"""qwen1.5-4b: multi-head attention (20 KV heads) with QKV biases, the
reference's configuration field for field. Its d_ff = 6912 = 27 * 256 is
not a power of 2, so the down projection rotates as 27 grouped 256-point
transforms (one K1 launch per layer on the card)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    groups=((("attn",), 40),),
    qkv_bias=True,
)
