"""Algorithm-based fault tolerance (ABFT) at run time (twin of
``repro.verify``): checksum verification of the fused rotate -> quantize
-> GEMM sites, the pure rotation sites and the serving KV cache, switched
on by ``REPRO_ABFT=1`` or ``QuantConfig.abft``."""
from repro_torch.verify.abft import (  # noqa: F401
    ABFT_ENV,
    abft_enabled,
    abft_tolerance,
    kv_check,
    kv_roll,
    kv_row_delta,
    kv_slot_reset,
    kv_sums_ok,
    kv_tree_sums,
    params_ok,
    residual_ok,
    with_checks,
)
