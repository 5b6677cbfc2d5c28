"""Per-launch sharding-rule presets (twin of the rules half of
``repro.launch.dryrun``).

``decode_rules(cfg, shape)`` and ``FSDP_ONLY_RULES`` are the reference's
overrides of ``distributed.sharding.DEFAULT_RULES``, with its names and
logic; ``serving.ServeEngine(..., rules_overrides=)`` takes either, and
``launch.steps.make_train_step(..., rules_overrides=)`` any of them.
``cell_rules(cfg, shape, seqpar, rules_preset)`` composes a cell's
overrides as the reference's ``run_cell`` does. The
reference's dry run itself -- lowering each cell to XLA, reading the
compiled program's cost and memory analysis and its roofline -- is left out
on purpose: the port compiles no XLA program, and ``chip_smoke.py``'s
bound columns are its roofline terms.
"""
from __future__ import annotations

from repro_torch.launch.flops import count_params
from repro_torch.launch.shapes import ShapeSpec

__all__ = ["decode_rules", "FSDP_ONLY_RULES", "cell_rules"]


def decode_rules(cfg, shape: ShapeSpec):
    """Per-cell sharding-rule overrides.

    decode: the KV cache shards its sequence dim over 'model'
    (flash-decoding style); batch < 32 (long context) also spans 'data'
    and splits the query heads over 'model'.

    Serving weight layout: FSDP-sharded weights must be all-gathered every
    decode step. So at serve time:
      * MoE archs shard experts over 'data' (EP) x expert-ffn over 'model'
        (TP), the dispatch replicated over the rows ('moebatch' None);
      * dense archs replicate the 'fsdp' dims IF the model-sharded weights
        fit comfortably (< 6 GB a device at 16 devices, bf16); giant dense
        models (405B) keep FSDP storage and pay the gather.

    None for a cell that is not a decode."""
    if shape.kind != "decode":
        return None
    rules = {"kvseq": "model", "kv": None}
    if shape.batch < 32:
        rules["kvseq"] = ("data", "model")
        rules["heads"] = "model"
    if cfg.num_experts:
        rules.update({"experts": "data", "dff": "model", "fsdp": None,
                      "moebatch": None})
    else:
        per_dev_gb = count_params(cfg)["total"] * 2 / 16 / 1e9  # TP-sharded bf16
        if per_dev_gb < 6.0:
            rules["fsdp"] = None
    return rules


# every layer computes whole; only the weights (and the vocabulary table,
# storage only) are split, over every mesh axis (ZeRO-3)
FSDP_ONLY_RULES = {
    "heads": None, "kv": None, "dff": None, "experts": None,
    "vocab": ("pod", "data", "model"),
    "fsdp": ("pod", "data", "model"),
}


def cell_rules(cfg, shape: ShapeSpec, seqpar: bool = False, rules_preset=None):
    """A cell's sharding-rule overrides, composed as the reference's
    ``run_cell`` composes them: ``decode_rules``, then residual sequence
    parallelism over 'model' with ``seqpar``, then ``FSDP_ONLY_RULES``
    with ``rules_preset == "fsdp_only"`` (any other preset adds nothing,
    as there). None when nothing overrides the defaults."""
    rules = decode_rules(cfg, shape)
    if seqpar:
        rules = dict(rules or {}, seqpar="model")
    if rules_preset == "fsdp_only":
        rules = dict(rules or {}, **FSDP_ONLY_RULES)
    return rules
