"""PyTorch port, the continuous-batching engine on a mesh: ``ServeEngine(...,
mesh=)`` and ``launch.serve_loop --mp`` on CPU ranks of a gloo process
group (``repro_torch.testing.ranks.run_ranks``) against the engine at
world 1 (no process group), port against port.

phi4-mini-3.8b (int8 weights, the fused down projection, whose sharded
quant_dot runs shard-locally) and mixtral-8x7b (top-2 experts, each rank's
rows through the expert site) at ``--scale 0.005``, int8 + Hadamard
through the 'cuda' backend's plain versions, 4 slots of 64 positions, a
prefill bucket of 16, ABFT and the numeric guards on (``REPRO_ABFT=1``,
``REPRO_NUMERIC_GUARDS=1``). World 1 runs in this process on one torch
thread, as the ranks do.

  * ``serve_loop.main --mp`` at (2, 1) (2 slots a rank) and (2, 2) (the
    weights split over 'model' too): every completion (tokens, status,
    finish reason), the ``summary()`` counts and ``health()`` equal world
    1's on every rank; at (2, 2) a completion's tokens may part from world
    1's where world 1's top-1 / top-2 margin at the first parting token is
    at most ``MARGIN`` (the split sums the heads' and the experts' shares
    in another order: mixtral's request 1 parts at its 21st token).
  * Fault plans at (2, 1), each against the same plan at world 1: a kernel
    raise on every rank at step 3 twice (a retry, then one rung down the
    ladder, in lockstep); a NaN poked into slot 1's cache (its owner's)
    before step 4 (the guard's verdict gathered: the same ``nan_guard``
    retirements); slot 1's last KV row overwritten before step 4 (ABFT's
    KV check on the owner, ``sdc_detected`` everywhere); a 2 s delay at
    steps 3 and 4 on rank 0 ALONE with a 1 s watchdog (the MAX of the
    ranks' step times: both ranks trip twice and degrade; a step here
    takes ~20 ms, so no other step comes near the watchdog, even on a
    loaded machine).
  * A decode step that raises on rank 0 alone, in its second layer (rank
    1 already waits in that layer's gather): both ranks' ``run`` raise
    ``RankStepError`` (rank 1's when the connection closes), well inside
    ``run_ranks``' timeout.
  * The model of a decode step on the mesh makes no all-reduce over the
    batch-row axis 'data', for either arch at (2, 1) and (2, 2): mixtral's
    MoE layers keep their own rows' load-balancing statistics, whose loss
    inference drops, rather than sum them over the ranks (two all-reduces
    a layer, a training pass's). At (2, 2) the tensor-parallel layers
    all-reduce over 'model' alone: the embedding's rows in both archs, each
    attention's output projection in phi4-mini, and in each of mixtral's
    MoE layers its attention's output projection and its experts' combine.
"""
import contextlib
import os
import threading
import time

import pytest
import torch

from repro_torch.testing.ranks import run_ranks

ENV = {"REPRO_ABFT": "1", "REPRO_NUMERIC_GUARDS": "1"}
BASE = ["--device", "cpu", "--scale", "0.005", "--quant", "int8", "--rotate", "hadamard",
        "--kernel", "cuda", "--requests", "6", "--slots", "4", "--max-len", "64",
        "--prefill-len", "16"]
ARCHS = ("phi4-mini-3.8b", "mixtral-8x7b")
PLANS = ("raise", "nan", "kv", "delay")
DELAY_S, WATCHDOG_MS = 2.0, 1000.0
MARGIN = 0.125     # tests/test_torch_mesh_families.py's


def _record(engine, err=None):
    comps = sorted((c.rid, c.status, c.finish_reason, tuple(c.tokens))
                   for c in engine.completions)
    s = engine.summary()
    counts = {k: v for k, v in s.items()
              if k.startswith("status_") or k in ("requests", "generated_tokens",
                                                  "decode_steps", "prefill_calls",
                                                  "decode_calls", "rung")}
    return {"completions": comps, "health": engine.health(), "counts": counts,
            "error": err}


def _launcher(arch: str, mp=None, teacher=None):
    """``serve_loop.main`` on the seeded stream: its record. ``teacher``: a
    dict that takes, under ``arch``, the world-1 margin of a completion's
    token (``_margin``'s arguments but the request id and the tokens
    before it)."""
    import contextlib
    import io

    from repro_torch.launch import serve_loop
    from repro_torch.serving import synthetic_stream

    argv = BASE + ["--arch", arch] + ([] if mp is None else ["--mp", str(mp)])
    with contextlib.redirect_stdout(io.StringIO()):
        engine = serve_loop.main(argv)
    if teacher is not None:
        args = serve_loop.parse_args(argv)
        prompts = {r.rid: r.tokens for r in synthetic_stream(
            args.requests, vocab_size=engine.cfg.vocab_size,
            prompt_len=(min(8, args.prefill_len), args.prefill_len), max_new_tokens=(8, 32),
            rate=0.5, seed=args.seed, deadline_slack=args.deadline_slack)}
        teacher[arch] = lambda rid, toks: _margin(engine.cfg, engine.params, prompts[rid], toks)
    return _record(engine)


def _margin(cfg, params, prompt, tokens) -> float:
    """The top-1 / top-2 logit gap at the token after ``prompt`` +
    ``tokens`` (one forward of them)."""
    from repro_torch.models.lm import lm_forward

    seq = torch.tensor([list(prompt) + list(tokens)], dtype=torch.long)
    with torch.inference_mode():
        last = lm_forward(cfg, params, {"tokens": seq})[0][0, -1, :cfg.vocab_size]
    top = last.float().topk(2).values
    return float(top[0] - top[1])


@contextlib.contextmanager
def _reduces_in_decode(box):
    """Counts into ``box`` the engine's decode calls ("decodes") and the
    mesh's all-reduces made inside them over the batch-row axis 'data'
    ("reduces") and over 'model' alone ("model_reduces")."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving.engine import ServeEngine

    reduce, decode, inside = Mesh.all_reduce, ServeEngine._decode, [False]

    def counted(self, t, axes, *a, **k):
        if inside[0]:
            box["reduces" if "data" in axes else "model_reduces"] += 1
        return reduce(self, t, axes, *a, **k)

    def decoding(self):
        box["decodes"] += 1
        inside[0] = True
        try:
            return decode(self)
        finally:
            inside[0] = False

    Mesh.all_reduce, ServeEngine._decode = counted, decoding
    try:
        yield box
    finally:
        Mesh.all_reduce, ServeEngine._decode = reduce, decode


def _counted_launchers(mp: int):
    """Both archs through the launcher at ``--mp mp``, each with its
    decode's all-reduces counted (under "reduces")."""
    out, counts = {}, {}
    for a in ARCHS:
        box = {"decodes": 0, "reduces": 0, "model_reduces": 0}
        with _reduces_in_decode(box) as counts[a]:
            out[a] = _launcher(a, mp)
    out["reduces"] = counts
    return out


def _plan(name: str, rank: int):
    from repro_torch.testing import faults

    if name == "raise":
        return faults.FaultPlan(kernel_raise_at_step=3, kernel_raise_count=2)
    if name == "nan":
        return faults.FaultPlan(nan_poke_step=4, nan_poke_slot=1)
    if name == "kv":
        return faults.FaultPlan(corrupt_at_step=4, corrupt_kind="kv", kv_corrupt_slot=1)
    # the delay on rank 0 alone
    return faults.FaultPlan(step_delay_s=DELAY_S if rank == 0 else 0.0, delay_at_steps=(3, 4))


def _faulted(name: str, rank: int = 0, mesh=None, raise_alone: bool = False):
    """phi4-mini's engine on a flood of 6 requests under the fault plan
    ``name``: its record. ``raise_alone``: instead, rank 0 raises in the
    second layer of decode step 5."""
    from repro_torch.launch import serve_loop
    from repro_torch.models import lm
    from repro_torch.testing import faults

    args = serve_loop.parse_args(BASE + ["--arch", ARCHS[0]])
    if name == "delay":
        args.watchdog_ms = WATCHDOG_MS
    engine, cfg = serve_loop.build_engine(args, mesh)
    reqs = faults.arrival_flood(6, prompt_len=args.prefill_len, max_new_tokens=8,
                                vocab=cfg.vocab_size, seed=1)
    plan = faults.FaultPlan() if raise_alone else _plan(name, rank)
    block, calls = lm._block_decode, [0]

    def failing(cfg_, *a):
        calls[0] += 1
        if engine.step == 5 and calls[0] % cfg_.num_layers == 0:
            raise RuntimeError("a kernel failed on this rank alone")
        return block(cfg_, *a)

    if raise_alone and rank == 0:
        lm._block_decode = failing
    err = None
    try:
        with faults.inject(plan):
            engine.run(reqs)
    except Exception as e:     # noqa: BLE001 -- the record says which
        err = type(e).__name__
    finally:
        lm._block_decode = block
    return _record(engine, err)


def _ranks(rank, world):
    """World 2: both archs through the launcher at --mp 1, every fault
    plan, then the raise on rank 0 alone (last: it ends the group).
    World 4: both archs at --mp 2."""
    from repro_torch.launch.mesh import make_local_mesh

    os.environ.update(ENV)
    torch.set_num_threads(1)
    if world == 4:
        return _counted_launchers(2)
    out = _counted_launchers(1)
    mesh = make_local_mesh(1)
    for name in PLANS:
        out[name] = _faulted(name, rank, mesh)
    t0 = time.perf_counter()
    out["alone"] = _faulted("alone", rank, mesh, raise_alone=True)
    out["alone_s"] = time.perf_counter() - t0
    return out


@pytest.fixture(scope="module")
def runs():
    """World 1 in this process beside worlds 2 and 4, each started from a
    thread of its own."""
    box, threads, saved = {}, torch.get_num_threads(), {k: os.environ.get(k) for k in ENV}

    def ranks(world):
        try:
            box[world] = run_ranks(_ranks, world, timeout=300)
        except BaseException as e:   # re-raised below
            box["error"] = e

    started = [threading.Thread(target=ranks, args=(w,)) for w in (2, 4)]
    for th in started:
        th.start()
    try:
        os.environ.update(ENV)
        torch.set_num_threads(1)
        teacher = {}
        one = {a: _launcher(a, teacher=teacher) for a in ARCHS}
        one.update({name: _faulted(name) for name in PLANS})
        one["teacher"] = teacher
    finally:
        for th in started:
            th.join()
        torch.set_num_threads(threads)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if "error" in box:
        raise box["error"]
    return {1: one, 2: box[2], 4: box[4]}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_on_mesh_matches_world_one(arch, world, runs):
    """``serve_loop --mp`` at (2, 1) and (2, 2): completions, counts and
    health on every rank are world 1's; at (2, 2), where 'model' splits
    the layers' sums, a completion's tokens may part from world 1's only at
    a token whose world-1 top-1 / top-2 margin is at most MARGIN."""
    want = runs[1][arch]
    assert want["counts"]["status_ok"] == 6 and want["health"]["rung"] == 0
    for got in runs[world]:
        got = got[arch]
        if world == 2:
            assert got == want
            continue
        assert {k: v for k, v in got.items() if k != "completions"} == {
            k: v for k, v in want.items() if k != "completions"}
        assert len(got["completions"]) == len(want["completions"])
        for a, b in zip(got["completions"], want["completions"]):
            assert a[:3] == b[:3] and len(a[3]) == len(b[3])
            if a[3] != b[3]:
                j = next(i for i, (x, y) in enumerate(zip(a[3], b[3])) if x != y)
                assert runs[1]["teacher"][arch](a[0], b[3][:j]) <= MARGIN, (a[0], j)


@pytest.mark.parametrize("name", PLANS)
def test_fault_plans_move_every_rank_together(name, runs):
    """A fault plan at (2, 1): every rank's completions and health equal
    world 1's under the same plan (the delay on rank 0 alone)."""
    want = runs[1][name]
    expect = {"raise": ("degrades", 1), "nan": ("nan_guard_trips", 1),
              "kv": ("abft_kv_trips", 1), "delay": ("watchdog_trips", 2)}[name]
    assert want["health"][expect[0]] >= expect[1]
    for got in runs[2]:
        assert got[name] == want


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_mesh_makes_no_all_reduce(arch, world, runs):
    """At (2, 1) and (2, 2) no rank's decode step makes an all-reduce over
    'data'; at (2, 2) the tensor-parallel layers' all-reduces over 'model'
    (module docstring): per decode step the embedding's one, plus one per
    layer in phi4-mini."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_loop import scaled_config

    cfg = scaled_config(get_config(arch), 0.005)
    # phi4-mini: each attention's output projection; mixtral: each MoE
    # layer's attention output projection and its experts' combine
    layers = 1 + cfg.num_layers * (1 if arch == "phi4-mini-3.8b" else 2)
    for got in runs[world]:
        box = got["reduces"][arch]
        assert box["decodes"] > 0 and box["reduces"] == 0, box
        want = box["decodes"] * layers if world == 4 else 0
        assert box["model_reduces"] == want, box


def test_a_raise_on_one_rank_ends_every_rank(runs):
    """Rank 0's step raises alone: both ranks' ``run`` raise RankStepError
    within seconds, none hangs."""
    for got in runs[2]:
        assert got["alone"]["error"] == "RankStepError"
        assert got["alone_s"] < 60.0
