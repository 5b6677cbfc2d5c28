"""llama4-maverick-400b-a17b: 128-expert top-1 MoE layers interleaved with
dense layers (48 layers, 24 (dense, MoE) pairs), each MoE layer with a
shared expert. The reference's configuration, field for field. Its d_ff =
8192 is a power of 2, so the expert down projection runs as one fused
rotate -> quantize -> GEMM launch over all experts (K6) on the card, and
the dense and shared-expert down projections as K4."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    groups=((("attn", "moe"), 24),),
    num_experts=128,
    experts_per_token=1,
    moe_shared_expert=True,
    rope_theta=500000.0,
)
