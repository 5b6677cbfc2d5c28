"""rwkv6-7b "Finch" (arXiv:2404.05892; the published Hugging Face config),
the reference's configuration field for field: attention-free, 32 layers of
RWKV6 time mix (64 heads of 64, data-dependent decay) and squared-ReLU
channel mix. It has no KV cache, so no Q / K rotation site; the channel
mix's down projection keeps the online Hadamard, and its d_ff = 14336 = 7 x
2048 makes that one grouped K1 launch per layer on the card. Sub-quadratic:
eligible for long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    d_model=4096,
    num_heads=64,
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    groups=((("rwkv",), 32),),
    rwkv_head_dim=64,
    sub_quadratic=True,
)
