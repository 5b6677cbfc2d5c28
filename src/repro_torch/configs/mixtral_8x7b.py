"""mixtral-8x7b: 8 experts routed top-2 in every layer, sliding-window
attention over 4096 tokens (arXiv:2401.04088), the reference's
configuration field for field. Its expert d_ff = 14336 = 7 * 2048 is not a
power of 2, so the expert down projection never fuses into K6: one grouped
K1 launch over the dispatched rows per layer on the card, then the einsum
form per expert."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    groups=((("moe",), 32),),
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1e6,
)
