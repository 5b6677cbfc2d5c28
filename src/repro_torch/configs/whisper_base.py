"""whisper-base: encoder-decoder transformer (arXiv:2212.04356), the
reference's configuration field for field. The conv frontend is stubbed as
the reference stubs it: the batch supplies ``encoder_seq`` precomputed
mel-frame embeddings, and both stacks add sinusoidal positions (the
reference's adaptation; DESIGN.md). Its d_ff = 2048 is a power of 2, so
every down projection, encoder and decoder, runs the fused rotate ->
quantize -> GEMM consumer (K4, 2048 -> 512) on the card; its head_dim 64
takes K2 at n = 64 at the Q and K sites and at the cross-attention K."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    groups=((("xattn",), 6),),
    encoder_groups=((("enc_attn",), 6),),
    encoder_seq=1500,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
)
