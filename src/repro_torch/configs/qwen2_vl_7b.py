"""qwen2-vl-7b: M-RoPE decoder with a stubbed vision tower
(arXiv:2409.12191; the published Hugging Face config), the reference's
configuration field for field: the batch supplies ``vlm_patches``
precomputed patch embeddings, prepended to the token embeddings, and a
(3, B, S) grid of temporal / height / width positions whose rotary
frequencies split 16 / 24 / 24. Its d_ff = 18944 = 37 x 512 is not a power
of 2, so each down projection is one grouped K1 launch on the card."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    groups=((("attn",), 28),),
    mrope=True,
    mrope_sections=(16, 24, 24),
    vlm_patches=1024,
    rope_theta=1e6,
)
