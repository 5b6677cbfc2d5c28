"""llama3-8b: the paper's own end-to-end evaluation model (section 4.2 runs
Llama-3.1-8B with FP8 attention and online Hadamard rotations)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    groups=((("attn",), 32),),
    rope_theta=500000.0,
)
