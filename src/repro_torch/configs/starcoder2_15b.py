"""starcoder2-15b: GQA (4 KV heads) with RoPE, QKV biases, LayerNorm and a
tanh-GELU MLP without a gate (arXiv:2402.19173), the reference's
configuration field for field (its MLP has no bias). Its d_ff = 24576 =
3 * 8192 is not a power of 2, so the down projection rotates as 3 grouped
8192-point transforms (one K1 launch per layer on the card)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    groups=((("attn",), 40),),
    act="gelu",
    norm="layernorm",
    qkv_bias=True,
    rope_theta=1e5,
)
