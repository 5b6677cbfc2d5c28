"""PyTorch port, the kernel-contract linter (``repro_torch.analysis``), on
the CPU.

The reference's own linter cannot run here (``src/repro/analysis/
jaxpr_utils.py:18`` imports ``jax.core.ClosedJaxpr``, which jax 0.9 no
longer has), so these tests hold the port's rules on the port's own sites:

* the registry carries the seven contracts, and a report survives its JSON
  round trip;
* the serving sites of a scaled-down engine (a decode step and a
  prefill-insert, recorded on the CPU) lint clean under ``donation``,
  ``fusion-contract`` (0 ``quantize_weight`` calls) and
  ``deprecated-shim-in-trace``, while ``dtype-flow`` names the decode site:
  the CPU attention widens the cache to f32 (no CPU op multiplies bf16 x
  bf16 into f32), the card's does not -- the rule's teeth, as the
  reference's ``test_dtype_flow_flags_cache_dequant``;
* each rule flags a broken site built from recorded evidence: a shim call,
  an aten contraction inside a kernel site that launched no fused kernel,
  a plain transform whose passes compute in f32, an understated
  shared-memory charge, a rotation count above the geometry's, a cache
  leaf whose pointer moved;
* the PTX reader parses an entry's instantiation from its mangled name,
  passes an intact streamed ring and flags it with its wait_group (or its
  drain) removed; it counts each entry's tensor-core ``mma.sync`` and
  CUDA-core ``dp4a`` instructions;
* the CLI refuses to run the card's rules, or the mutants, on the CPU, and
  refuses every rule set when the card was asked for and is not there: it
  exits 2 with a message and reports nothing as passed.

The kernels' own evidence (rotation counters, PTX of the built sources,
``cudaFuncGetAttributes``, the mutants) exists only on the card:
``python3 chip_smoke.py`` runs the linter there.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.analysis import lint, ptx
from repro_torch.analysis.dispatch_trace import OpRecord, OpRecorder, recording
from repro_torch.analysis.report import Report, Violation
from repro_torch.analysis.rules import CARD_RULES, all_rules, run_rules
from repro_torch.analysis.sites import Site, _plain_ops, _scaled_engine, serving_sites
from repro_torch.core.api import QuantDotSpec, plan_for
from repro_torch.core.wquant import quantize_weight

RULES = {"fusion-contract", "rotate-once-contract", "dma-safety", "dtype-flow",
         "smem-budget", "donation", "deprecated-shim-in-trace"}


def test_registry_carries_the_seven_contracts():
    assert set(all_rules()) == RULES
    assert CARD_RULES < RULES
    for rule in all_rules().values():
        assert rule.__doc__ and rule.name in RULES


def test_report_json_round_trip():
    rep = Report(checked=[("a", "donation"), ("b", "dtype-flow")],
                 violations=[Violation("dtype-flow", "b", "f32 cache copy")])
    back = Report.from_json(rep.to_json())
    assert back == rep and not back.ok
    assert back.to_dict() == rep.to_dict()
    merged = Report().merge(back)
    assert merged.checked == rep.checked and "1 violation" in merged.format_text()
    assert "OK" in Report(checked=[("a", "donation")]).format_text()


@pytest.fixture(scope="module")
def engine_sites():
    engine = _scaled_engine("phi4-mini-3.8b", "cpu", 0)
    return engine, serving_sites("phi4-mini-3.8b", engine=engine)


def _names(rep):
    return {(v.site, v.rule) for v in rep.violations}


def test_cpu_serving_sites_lint_clean_but_for_the_cache_upcast(engine_sites):
    _, sites = engine_sites
    decode, insert = sites
    assert decode.decode and decode.cache_leaves and insert.cache_leaves
    assert decode.qw_calls == 0 and insert.qw_calls == 0
    rep = run_rules(sites, ["donation", "fusion-contract", "deprecated-shim-in-trace"])
    assert rep.ok, rep.format_text()
    assert {r for _, r in rep.checked} == {"donation", "fusion-contract"}
    rep = run_rules(sites, ["dtype-flow"])
    assert _names(rep) == {(decode.name, "dtype-flow")}, rep.format_text()
    assert "float32" in rep.violations[0].message


def test_donation_flags_a_moved_cache_leaf(engine_sites):
    engine, (decode, _) = engine_sites
    from repro_torch.analysis.dispatch_trace import cache_snapshot

    before = cache_snapshot(engine.caches)
    moved = [{k: t.clone() for k, t in c.items()} for c in engine.caches]
    bad = dataclasses.replace(decode, cache_before=before, cache_after=cache_snapshot(moved))
    rep = run_rules([bad], ["donation"])
    assert _names(rep) == {(decode.name, "donation")}
    assert "changed pointer" in rep.violations[0].message
    shape, dt = decode.cache_leaves[0]
    copy = OpRecord("clone", ((shape, dt, before[0][3]),), ((shape, dt, 12345),))
    rep = run_rules([dataclasses.replace(decode, ops=decode.ops + (copy,))], ["donation"])
    assert "defensive copy" in rep.violations[0].message


def test_fusion_flags_a_kernel_site_with_an_aten_contraction():
    """The plain quant_dot (what a site resolved to the plain backend runs)
    records its contraction and no fused launch."""
    x = torch.randn(8, 128).to(torch.bfloat16)
    qt = quantize_weight(torch.randn(128, 64), "int8")
    spec = QuantDotSpec(n=128, mode="int8")
    with recording() as ev:
        spec.bind(qt)(x)
    assert ev.launches == {} and any(op.name in ("_int_mm", "mm", "matmul") for op in ev.ops)
    site = Site(name="quant_dot[plain]", kind="kernel", n=128, ops=ev.ops,
                launches=ev.launches)
    msgs = [v.message for v in run_rules([site], ["fusion-contract"]).violations]
    assert len(msgs) == 2 and "exactly 1 fused" in msgs[0] and "escaped" in msgs[1]
    ok = dataclasses.replace(site, ops=(), launches={"quant_dot_cuda": 1})
    assert run_rules([ok], ["fusion-contract"]).ok
    model = Site(name="mlp", kind="model", n=128, launches={"quant_dot_cuda": 1},
                 ops=(OpRecord("mm", (((8, 64), "bfloat16", 1), ((64, 128), "bfloat16", 2))),))
    assert run_rules([model], ["fusion-contract"]).ok   # gate / up contract over d_model
    spilled = dataclasses.replace(model, ops=(OpRecord("mm", (((8, 128), "float32", 3),)),))
    assert not run_rules([spilled], ["fusion-contract"]).ok
    serving = Site(name="serve", kind="serving", qw_calls=2)
    assert "quantize_weight" in run_rules([serving], ["fusion-contract"]).violations[0].message


def test_deprecated_shim_rule_reads_the_shim_ticks():
    from repro_torch.kernels import ops

    with recording() as ev, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ops.hadamard(torch.randn(2, 64))
    assert ev.shim_calls == {"deprecated/kernels.ops.hadamard": 1}
    rep = run_rules([Site(name="s", kind="kernel", shim_calls=ev.shim_calls)],
                    ["deprecated-shim-in-trace"])
    assert _names(rep) == {("s", "deprecated-shim-in-trace")}


def test_dtype_flow_flags_f32_pass_compute():
    """The plain transform of a bf16 plan widens its operands exactly and
    rounds every pass back to bf16: clean. Its passes run on f32 values
    with nothing rounded between them (what a silent upcast of the pass
    compute would record): flagged."""
    from repro_torch.core.hadamard import _apply_passes
    from repro_torch.kernels.hadacore import _plan_mats

    plan = plan_for(16384, dtype=torch.bfloat16, device_type="cpu")
    x = torch.randn(4, 16384).to(torch.bfloat16)
    site = Site(name="k", kind="kernel", plan=plan, plain_ops=_plain_ops(x, plan))
    assert plan.num_passes == 2 and run_rules([site], ["dtype-flow"]).ok
    rec = OpRecorder()
    with rec:
        _apply_passes(x.float(), 16384, _plan_mats(plan, x.device))
    rep = run_rules([dataclasses.replace(site, plain_ops=tuple(rec.ops))], ["dtype-flow"])
    assert _names(rep) == {("k", "dtype-flow")}
    assert any("never rounded" in v.message for v in rep.violations)
    wide = (OpRecord("mm", (((4, 128), "float32", 7), ((128, 128), "float32", 8)),
                     (((4, 128), "float32", 9),)),
            OpRecord("_to_copy", (((4, 128), "float32", 9),), (((4, 128), "bfloat16", 10),)))
    msgs = [v.message for v in run_rules([dataclasses.replace(site, plain_ops=wide)],
                                         ["dtype-flow"]).violations]
    assert len(msgs) == 2 and all("not the bfloat16 values widened" in m for m in msgs)


def _kernel_site(**kw):
    base = dict(name="quant_dot[k]", kind="kernel", schedule="rotate_once",
                rotations=np.array([4, 4, 4], np.uint32), expected_rotations=4,
                geometry={"splits": 32, "cluster": 8}, same_as_uninstrumented=True,
                smem={"planned": 196680, "fits": True, "requested": 196680,
                      "main": {"static_smem": 0, "max_dynamic_smem": 196680},
                      "optin": 232448})
    base.update(kw)
    return Site(**base)


def test_rotate_once_flags_counts_above_the_geometry():
    assert run_rules([_kernel_site()], ["rotate-once-contract"]).ok
    over = _kernel_site(rotations=np.array([12, 12, 12], np.uint32))
    rep = run_rules([over], ["rotate-once-contract"])
    assert "12..12 times, expected 4" in rep.violations[0].message
    changed = _kernel_site(same_as_uninstrumented=False)
    assert "counter changed" in run_rules([changed], ["rotate-once-contract"]) \
        .violations[0].message
    lost = _kernel_site(rotations_lost=3)
    assert not run_rules([lost], ["rotate-once-contract"]).ok


def test_smem_budget_flags_an_understated_charge():
    assert run_rules([_kernel_site()], ["smem-budget"]).ok
    under = _kernel_site(smem={"planned": 131144, "fits": True, "requested": 196680,
                               "main": {"static_smem": 0, "max_dynamic_smem": 196680},
                               "optin": 232448})
    msgs = [v.message for v in run_rules([under], ["smem-budget"]).violations]
    assert len(msgs) == 1 and "charges 131144 B" in msgs[0]
    over = _kernel_site(smem={"planned": 196680, "fits": True, "requested": 196680,
                              "main": {"static_smem": 40000, "max_dynamic_smem": 196680},
                              "optin": 232448})
    assert "exceeds" in run_rules([over], ["smem-budget"]).violations[0].message


NAME = ("_ZN41_GLOBAL__N__d3b0a1f2_12_quant_dot_cu_5c1e816quant_dot_kernelI13__nv_bfloat16"
        "Li4ELb0ELb1ELb0ELb0EEEvPKT_PKhPKfPS2_xiiiifiiiiNS_4AbftE")
PTX = f"""
.version 8.7
.target sm_90a
.entry {NAME}(
\t.param .u64 {NAME}_param_0
)
.maxntid 512, 1, 1
{{
\t.reg .b32 %r<10>;
\t@%p1 cp.async.ca.shared.global [%r1], [%rd1], 4, %r2;
\tcp.async.commit_group;
\tbarrier.cluster.arrive;
\tbarrier.cluster.wait;
\tld.shared.f32 %f1, [%r3];
$L__BB0_1:
\t@%p1 cp.async.ca.shared.global [%r1], [%rd1], 4, %r2;
\tcp.async.commit_group;
\tcp.async.wait_group 2;
\tld.shared.u32 %r4, [%r5];  // the ring
\t@%p2 bra $L__BB0_1;
\tcp.async.wait_group 0;
\tret;
}}
"""


def test_ptx_reader_passes_the_ring_and_flags_a_missing_wait():
    want = ptx.Instantiation("quant_dot_kernel", "bfloat16", 4, False, True, False, False)
    assert ptx.parse_name(NAME) == want
    name, events = ptx.events_of(PTX)[want]
    assert name == NAME
    assert [e.kind for e in events] == ["copy", "commit", "barrier", "ld_shared", "copy",
                                        "commit", "wait", "ld_shared", "wait", "ret"]
    assert ptx.dma_findings(events) == []
    _, broken = ptx.events_of(PTX.replace("\tcp.async.wait_group 2;\n", ""))[want]
    msgs = ptx.dma_findings(broken)
    assert len(msgs) == 1 and "no wait_group between" in msgs[0]
    _, undrained = ptx.events_of(PTX.replace("\tcp.async.wait_group 0;\n", ""))[want]
    assert "does not drain" in ptx.dma_findings(undrained)[0]
    _, dangling = ptx.events_of(PTX.replace("\tcp.async.wait_group 2;\n", "")
                                .replace("\tcp.async.wait_group 0;\n", ""))[want]
    assert len(ptx.dma_findings(dangling)) == 3
    assert ptx.dma_findings([e for e in events if e.kind != "copy"])[0].startswith("no cp.async")
    for evs in (broken, undrained):  # undrained: M2's fault
        site = _kernel_site(name="mutant[dangling_dma]", schedule="streamed", ptx_entry=NAME,
                            ptx_events=tuple(evs))
        assert _names(run_rules([site], ["dma-safety"])) == {("mutant[dangling_dma]",
                                                              "dma-safety")}
    assert dataclasses.replace(want, bm=8) not in ptx.events_of(PTX)


MMA_PTX = f"""
.version 8.7
.target sm_90a
.entry {NAME}(
\t.param .u64 {NAME}_param_0
)
{{
\tmma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {{%r1, %r2, %r3, %r4}}, {{%r5, %r6, %r7, %r8}}, {{%r9, %r10}}, {{%r1, %r2, %r3, %r4}};
\t@%p1 mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {{%f1, %f2, %f3, %f4}}, {{%r5, %r6, %r7, %r8}}, {{%r9, %r10}}, {{%f1, %f2, %f3, %f4}};
\tret;
}}
.entry {NAME}_cuda_cores(
\t.param .u64 p
)
{{
\tdp4a.s32.s32 %r1, %r2, %r3, %r1;
\tdp4a.s32.s32 %r1, %r4, %r5, %r1;  // mma.sync in a comment does not count
\tret;
}}
"""


def test_ptx_counts_tensor_core_and_cuda_core_contractions():
    counts = ptx.contraction_counts(MMA_PTX)
    assert counts == {NAME: {"mma": 2, "dp4a": 0},
                      NAME + "_cuda_cores": {"mma": 0, "dp4a": 2}}
    assert ptx.contraction_counts(PTX) == {NAME: {"mma": 0, "dp4a": 0}}


def test_cli_refuses_the_cards_rules_on_the_cpu(capsys):
    assert lint.main(["--mutation", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "cannot run here" in err and "mutants" in err
    assert lint.main(["--device", "cpu", "--no-serving"]) == 2
    assert "need the card and nvcc" in capsys.readouterr().err
    assert lint.main(["--list-rules"]) == 0
    assert set(capsys.readouterr().out.split()) >= RULES
    assert lint.main(["--rule", "no-such-rule", "--device", "cpu"]) == 2


@pytest.mark.parametrize("rules", [["donation"], ["dtype-flow"],
                                   ["deprecated-shim-in-trace"], []])
def test_cli_never_lints_the_cpu_in_place_of_the_card(rules, capsys, monkeypatch):
    """``--device cuda`` (the default) with no CUDA device exits 2 for every
    rule set, the CPU-only rules too: a verdict on the CPU's serving path
    is not the card's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for r in rules for a in ("--rule", r)]
    assert lint.main(argv) == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cuda was asked for" in err
