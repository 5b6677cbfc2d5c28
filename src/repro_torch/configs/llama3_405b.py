"""llama3-405b: the largest dense GQA decoder of the Llama 3 herd
(arXiv:2407.21783), the reference's configuration field for field. Its d_ff
= 53248 = 13 * 4096 is not a power of 2, so the down projection rotates as
13 grouped 4096-point transforms (one K1 launch per layer on the card) and
contracts outside the kernel."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    groups=((("attn",), 126),),
    rope_theta=500000.0,
)
