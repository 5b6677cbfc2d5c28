"""zamba2-7b (arXiv:2411.15242), the reference's configuration field for
field: a Mamba2 backbone with an attention block every sixth layer, 13
superblocks of 5 mamba + 1 attention layers and a tail of 3 mamba layers
(81 layers). The mamba layers have no rotation site. The attention's
head_dim = 3584 / 32 = 112 is not a power of 2, so its Q / K rotation is
the grouped I_7 (x) H_16 (K1 at n = 16, then the per-token quantize over the
full row); its d_ff = 14336 = 7 x 2048 gives one grouped K1 launch per
attention layer's down projection. Sub-quadratic: eligible for
long_500k."""
from repro_torch.models.config import ModelConfig

_m5a = ("mamba",) * 5 + ("attn",)

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    groups=((_m5a, 13), (("mamba",), 3)),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    sub_quadratic=True,
)
