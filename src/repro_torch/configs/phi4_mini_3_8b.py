"""phi4-mini-3.8b: RoPE SwiGLU GQA decoder with tied embeddings
(arXiv:2412.08905; the published Hugging Face config). Its d_ff = 8192 is a
power of 2, so the down projection runs the fused rotate -> quantize -> GEMM
consumer (K4) on the card."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    groups=((("attn",), 32),),
    tie_embeddings=True,
)
