"""Model assembly: causal decoders, dense and MoE, vlm decoders with
prepended patch embeddings and M-RoPE positions, encoder-decoders, and the
recurrent-state stacks of RWKV6 and of the Mamba2 hybrid (twin of
``repro.models.lm``).

The reference stacks each group's parameters over a leading layer axis and
runs the group as one ``lax.scan``; the port keeps the layers as a plain
list of per-layer dicts, in execution order, and loops over them.
Parameters:

    {"emb": (padded_vocab, d), "final_norm": {...}, "unemb": (d, padded_vocab),
     "layers": [{"norm1", "attn": {wq, wk, wv, wo}, "norm2",
                 "mlp": {w_gate, w_up, w_down}}, ...]}

with no "unemb" when ``cfg.tie_embeddings`` (the logits contract with
``emb`` transposed). A norm is {scale}, plus {bias} under LayerNorm; the
attention adds the 1-D biases {bq, bk, bv} under ``cfg.qkv_bias``; the GELU
MLP has no w_gate. A layer of kind 'moe' holds "moe": {router, experts:
{w_gate, w_up (E, d, f), w_down (E, f, d)}, shared: {...}} in place of
"mlp"; a decoder layer of kind 'xattn' adds "norm_x" and "xattn" (the
cross attention, the leaves of "attn"). A layer of kind 'rwkv' holds
{"norm1", "tmix", "norm2", "cmix"} (``models.rwkv``), one of kind 'mamba'
{"norm1", "mamba"} (``models.ssm``). An encoder-decoder also holds
"enc_layers" (the encoder's layers of kind 'enc_attn', in execution order)
and "enc_norm". ``cfg.layer_kinds`` / ``cfg.encoder_layer_kinds`` name
each layer's kind.

The batch: "tokens" (B, S) int; a vlm adds "patch_embeds" (B, P, d),
prepended to the token embeddings, and "positions" (3, B, P + S), the
M-RoPE streams; an encoder-decoder adds "frames" (B, T, d), the encoder's
precomputed input, and adds sinusoidal positions to both stacks' inputs.

Any matrix may be a pre-quantized :class:`~repro_torch.core.wquant.QTensor`.
KV caches are a list with one ``{"k", "v"}`` dict per decoder layer, each
(B, T, KH, hd) in the KV dtype -- the reference's per-layer layout; an
'xattn' layer's also holds "xk" / "xv" (B, T_enc, KH, hd), the cross
attention's K / V in the model dtype, computed once at prefill. A
recurrent layer's cache is its state, the reference's: 'rwkv' {"S" (B, H,
K, K) f32, "xp_t" / "xp_c" (B, d), the time and channel mixes' last
inputs}, 'mamba' {"ssm" (B, H, P, N) f32, "conv_x" / "conv_bc" (B, 3, C),
the last three pre-conv inputs}; a decode step updates both kinds of cache
in place.

Entry points: ``init_lm``, ``lm_forward``, ``lm_loss`` (training: raw
weights, quantized on the fly at the consumer sites, straight-through
gradients), ``lm_prefill``, ``pad_kv_caches``, ``lm_decode_step``.

Training recomputes each block in the backward pass when ``cfg.remat`` is
not "none" (``torch.utils.checkpoint``; the reference's jax.checkpoint of
its scan body): the same values, one block's activations held at a time.

Sharding: ``lm_param_specs`` gives every parameter's logical axes (the
reference's tree with ``stacked=True``; the port's per-layer layout by
default) and ``param_parts`` their mesh axes under a mesh. Under an active
mesh (``distributed.sharding``) the parameters are this rank's shards (the
ZeRO-3 layout, ``distributed.collectives.shard_tree``): each layer's are
gathered over the data axes just before the layer runs (int8 storage
gathered as int8 and dequantized after) and dropped after it, their
gradients reduce-scattered back to the shards; the rotation-consumer
QTensors stay split by their out-channels and go so into the sharded
quant_dot. The batch rows are this rank's share.

Over 'model' every layer kind is tensor-parallel: attention of every form
and the dense MLP split their dims named 'heads', 'kv' and 'dff'
(``models.attention``, ``models.mlp``); a MoE layer its
attention by head and its experts (``mlp.expert_split``, or the experts'
hidden width where 'experts' does not divide); RWKV6 its time mix by head
and its channel mix by 'dff' (``models.rwkv``); Mamba2 its SSD heads
(``models.ssm``). Those dims stay this rank's slice (``_local_dims``), but
for the rows of the down sites (the MLPs' ``w_down`` over 'dff', the
channel mix's ``wv``), which the site contracts whole, and Mamba2's
``w_zx``, gathered whole and cut to the rank's heads in the layer; so a rank
holds 1 / D of those weights live, computes 1 / D of their heads, experts
and hidden columns, and caches its KV heads and its heads' recurrent state.
The vocabulary is split in every model: the embedding looks its rows up
where they live and sums the ranks' rows; the logits contract with this
rank's vocabulary rows and are all-gathered whole, so the loss and the
greedy argmax read whole logits. Where the rules put the vocabulary over
the axes the batch rows split over too (``launch.dryrun.FSDP_ONLY_RULES``
while decoding), the table is storage only: gathered whole before use, as
any 'fsdp' leaf, and the whole vocabulary computed (``vocab_split``).
Under the 'seqpar' rule (``{"seqpar": "model"}``, the reference's
Megatron-style sequence parallelism) the residual stream between a stack's
blocks is this rank's S / D of the positions (``_run_stack``): each block
norms its positions, its norms' gradient summed over the split's ranks,
gathers them whole for the branch (``_block_norm``), and keeps its
positions of the branch's output -- reduce-scattered where the branch sums
over 'model', cut where it is replicated (``_local``); the final norm and
the logits run on the gathered stream.
Each layer of each pass on a tensor-parallel mesh ticks
``TRACE_COUNTS[("tensor_parallel", kind, "split" | "replicated")]``: an
attention layer whose heads and hidden width do not divide the axis runs
replicated; a MoE, RWKV6 or Mamba2 layer that cannot split raises.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.wquant import (QTensor, _is_consumer, dequant_tree, is_qleaf,
                                     qweight_specs, quantize_leaf)
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (WHOLE, _ctx, axes_of, constrain, current_mesh,
                                              local_seq, make_resolver, model_size,
                                              model_split, restored, row_axes, seq_split,
                                              snapshot)
from repro_torch.kernels.registry import TRACE_COUNTS
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as SSM
from repro_torch.models.common import (apply_norm, dense_init, dtype_of,
                                       init_norm, sinusoidal_positions)
from repro_torch.models.config import ModelConfig


KINDS = ("attn", "moe", "xattn", "rwkv", "mamba")    # decoder layers
ENCODER_KINDS = ("enc_attn",)


def _check_kinds(cfg: ModelConfig) -> None:
    bad = (set(cfg.layer_kinds) - set(KINDS)) | (
        set(cfg.encoder_layer_kinds) - set(ENCODER_KINDS))
    if bad:
        raise NotImplementedError(
            f"the port runs the layer kinds {KINDS} (encoder {ENCODER_KINDS}); "
            f"{cfg.name!r} has {sorted(bad)}")


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, device) -> dict:
    d = cfg.d_model
    if kind == "mamba":
        return {"norm1": init_norm(cfg, d, device),
                "mamba": SSM.init_mamba(gen, cfg, device)}
    if kind == "rwkv":
        return {"norm1": init_norm(cfg, d, device),
                "tmix": R.init_rwkv_tmix(gen, cfg, device),
                "norm2": init_norm(cfg, d, device),
                "cmix": R.init_rwkv_cmix(gen, cfg, device)}
    p = {"norm1": init_norm(cfg, d, device),
         "attn": A.init_attention(gen, cfg, device)}
    if kind == "xattn":
        p["norm_x"] = init_norm(cfg, d, device)
        p["xattn"] = A.init_attention(gen, cfg, device)
    p["norm2"] = init_norm(cfg, d, device)
    if kind == "moe":
        p["moe"] = M.init_moe(gen, cfg, device)
    else:
        p["mlp"] = M.init_mlp(gen, cfg, device)
    return p


# ---------------------------------------------------------------- sharding
def _norm_specs(cfg: ModelConfig) -> dict:
    if cfg.norm == "rmsnorm":
        return {"scale": (None,)}
    return {"scale": (None,), "bias": (None,)}


def _block_specs(cfg: ModelConfig, kind: str) -> dict:
    """Logical axes of one layer's parameters."""
    n1 = _norm_specs(cfg)
    if kind == "mamba":
        return {"norm1": dict(n1), "mamba": SSM.mamba_specs(cfg)}
    if kind == "rwkv":
        return {"norm1": dict(n1), "tmix": R.rwkv_tmix_specs(cfg),
                "norm2": dict(n1), "cmix": R.rwkv_cmix_specs(cfg)}
    if kind == "xattn":
        return {"norm1": dict(n1), "attn": A.attention_specs(cfg),
                "norm_x": dict(n1), "xattn": A.attention_specs(cfg, cross=True),
                "norm2": dict(n1), "mlp": M.mlp_specs(cfg)}
    if kind not in ("attn", "moe", "enc_attn"):
        raise ValueError(kind)
    p = {"norm1": dict(n1), "attn": A.attention_specs(cfg), "norm2": dict(n1)}
    p["moe" if kind == "moe" else "mlp"] = (
        M.moe_specs(cfg) if kind == "moe" else M.mlp_specs(cfg))
    return p


def _stack_specs(tree):
    if isinstance(tree, dict):
        return {k: _stack_specs(v) for k, v in tree.items()}
    return ("layers",) + tuple(tree)


def _group_specs(cfg: ModelConfig, pattern) -> dict:
    """The reference's stacked group: ``p<j>`` -> pattern position j's
    axes behind a leading 'layers' axis."""
    return {f"p{j}": _stack_specs(_block_specs(cfg, kind))
            for j, kind in enumerate(pattern)}


def lm_param_specs(cfg: ModelConfig, stacked: bool = False) -> Dict[str, Any]:
    """Every parameter's logical axes: in the port's layout (a list of
    per-layer trees), or, with ``stacked``, in the reference's (stacked
    ``groups``), equal to its ``lm_param_specs``."""
    n1 = _norm_specs(cfg)
    specs: Dict[str, Any] = {"emb": ("vocab", "embed"), "final_norm": dict(n1)}
    if not cfg.tie_embeddings:
        specs["unemb"] = ("embed", "vocab")
    if stacked:
        specs["groups"] = [_group_specs(cfg, pat) for pat, _ in cfg.groups]
    else:
        specs["layers"] = [_block_specs(cfg, k) for k in cfg.layer_kinds]
    if cfg.is_encdec:
        if stacked:
            specs["enc_groups"] = [_group_specs(cfg, pat) for pat, _ in cfg.encoder_groups]
        else:
            specs["enc_layers"] = [_block_specs(cfg, k) for k in cfg.encoder_layer_kinds]
        specs["enc_norm"] = dict(n1)
    return specs


_PARTS: Dict[tuple, Any] = {}


def param_parts(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The mesh axes of every parameter's dims on ``mesh`` under the active
    rules: ``lm_param_specs`` (and, for int8 weight storage,
    ``qweight_specs``: a QTensor's parts are ``{"q", "scale"[, "check"]}``)
    resolved on the parameters' shapes with the divisibility guard. Cached
    per config, mesh and rules."""
    from repro_torch.core.wquant import wants_checks

    key = (cfg, mesh.shape, mesh.axis_names, tuple(sorted(_ctx().rules.items())),
           wants_checks(cfg))
    if key not in _PARTS:
        shapes = init_lm(cfg, device="meta")
        specs = qweight_specs(lm_param_specs(cfg), shapes)
        _PARTS[key] = _resolve(specs, shapes, make_resolver(mesh))
    return _PARTS[key]


def _resolve(specs, shapes, one):
    if is_qleaf(shapes):
        out = {"q": one(specs["q"], shapes.q.shape),
               "scale": one(specs["scale"], shapes.scale.shape)}
        if shapes.check is not None:
            out["check"] = one(specs["check"], shapes.check.shape)
        return out
    if isinstance(shapes, dict):
        return {k: _resolve(specs[k], v, one) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_resolve(sp, v, one) for sp, v in zip(specs, shapes)]
    return one(specs, shapes.shape)


def _mesh_parts(cfg: ModelConfig, key: str):
    """``param_parts`` of one top-level entry under the active mesh; None
    off a mesh."""
    mesh = current_mesh()
    return None if mesh is None else param_parts(cfg, mesh)[key]


def _splits(cfg: ModelConfig, keys) -> dict:
    """The logical axes a leaf at path ``keys`` keeps as this rank's slice
    of 'model', each with the split its layer computes (module docstring)."""
    if "experts" in keys:
        split = {"experts": M.expert_split(cfg), "dff": M.expert_dff_split(cfg)}
    elif "tmix" in keys:
        split = {"heads": R.head_split(cfg)}
    elif "mamba" in keys:
        split = {} if keys[-1] == "w_zx" else {"dff": SSM.head_split(cfg)}
    else:
        hs, ks = A.head_splits(cfg)
        split = {"heads": hs, "kv": ks, "dff": M.dff_split(cfg)}
    if keys[-1] == "w_down" or keys[-2:] == ("cmix", "wv"):
        split.pop("dff")                # a down site contracts its rows whole
    split["vocab"] = vocab_split(cfg)
    return split


def vocab_split(cfg: ModelConfig):
    """This rank's split of the vocabulary: ``WHOLE`` where its axes are
    also the batch rows' (the table is then storage only, module
    docstring)."""
    vs = model_split("vocab", cfg.padded_vocab, rows_ok=True)
    return WHOLE if set(vs.axes) & set(row_axes()) else vs


def _local_dims(cfg: ModelConfig, spec, parts, keys) -> Tuple[int, ...]:
    """The dims of a leaf (logical axes ``spec``, mesh axes ``parts``, path
    ``keys``) that the running layer keeps as this rank's slice of 'model'
    (``_splits``); their split at rest is the compute's."""
    split = _splits(cfg, keys)
    dims = tuple(d for d, a in enumerate(spec) if a in split and split[a].size > 1)
    for d in dims:
        if axes_of(parts[d]) != split[spec[d]].axes:
            raise ValueError(f"{'/'.join(keys)} dim {d} rests split over "
                             f"{axes_of(parts[d])}, its compute over {split[spec[d]].axes}")
    return dims


def _gather(cfg: ModelConfig, tree, parts, specs, keys=()):
    """A layer's (or a top-level entry's) parameters from this rank's
    shards, whole but for the dims the layer keeps split over 'model'
    (``_local_dims``; ``specs``: the logical axes): tensors through
    ``gather_param`` (their gradients go back to the shards), QTensors
    gathered in their storage dtype, a kept rotation consumer only along
    its rows (``_consumer_shard``)."""
    mesh = current_mesh()
    if is_qleaf(tree):
        if _keeps(cfg, tree, keys) and tree.q.ndim == 2:
            return _consumer_shard(tree, parts, mesh)
        leaf = {k: C.gather_leaf(getattr(tree, k), parts[k], mesh,
                                 _local_dims(cfg, specs[k], parts[k], keys))
                for k in parts}
        return QTensor(leaf["q"], leaf["scale"], tree.mode, leaf.get("check"))
    if isinstance(tree, dict):
        return {k: _gather(cfg, v, parts[k], specs[k], keys + (k,))
                for k, v in tree.items()}
    return C.gather_param(tree, parts, mesh, _local_dims(cfg, specs, parts, keys))


def _consumer_shard(p: QTensor, parts, mesh) -> QTensor:
    """A rotation-consumer QTensor for the sharded quant_dot: when its
    out-channels are split over the mesh axes the site's plan shards over,
    gathered along its rows only (``QTensor.shard``); otherwise whole."""
    from repro_torch.core.api import _resolve_mesh_axes

    cols = axes_of(parts["q"][-1])
    d = p.q.shape[-1] * mesh.group_size(cols)
    want = _resolve_mesh_axes(M._DOWN_AXES, d)
    if want is None or cols != want or axes_of(parts["scale"][-1]) != want:
        return C.gather_tree(p, parts, mesh)
    check = None if p.check is None else C.gather_leaf(p.check, parts["check"], mesh)
    return QTensor(C.gather_leaf(p.q, parts["q"], mesh, skip=(1,)),
                   C.gather_leaf(p.scale, parts["scale"], mesh, skip=(1,)),
                   p.mode, check, shard=(want, d))


def _top(cfg: ModelConfig, params, key: str):
    """A top-level entry of ``params``, gathered under a mesh (``emb`` /
    ``unemb`` keep this rank's vocabulary rows when the vocabulary splits)."""
    parts = _mesh_parts(cfg, key)
    if parts is None:
        return params[key]
    specs = qweight_specs(lm_param_specs(cfg)[key], params[key])
    return _gather(cfg, params[key], parts, specs, (key,))


def _quantized(cfg: ModelConfig, tree, keys=()):
    """Pre-quantize one freshly initialized subtree (``weight_quant ==
    'int8'``: the serving storage of ``wquant.quantize_lm_weights``)."""
    if cfg.weight_quant != "int8":
        return tree
    if isinstance(tree, dict):
        return {k: _quantized(cfg, v, keys + (k,)) for k, v in tree.items()}
    return quantize_leaf(keys, tree, cfg)


def init_lm(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``. With ``cfg.weight_quant == 'int8'`` each leaf
    is quantized as soon as it is drawn, layer by layer (expert stacks a
    chunk of experts at a time), so the full 16-bit copy of the model never
    exists at once."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    # the meta device (shapes only, ``launch.flops``) draws nothing
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
    dt = dtype_of(cfg)
    params: Dict[str, Any] = {
        "emb": _quantized(cfg, dense_init(gen, cfg.padded_vocab, cfg.d_model,
                                          dt, scale=0.02, device=dev), ("emb",)),
        "final_norm": init_norm(cfg, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unemb"] = _quantized(
            cfg, dense_init(gen, cfg.d_model, cfg.padded_vocab, dt, device=dev),
            ("unemb",))
    params["layers"] = [_quantized(cfg, _init_block(gen, cfg, kind, dev), ("layers",))
                        for kind in cfg.layer_kinds]
    if cfg.is_encdec:
        params["enc_layers"] = [
            _quantized(cfg, _init_block(gen, cfg, kind, dev), ("enc_layers",))
            for kind in cfg.encoder_layer_kinds]
        params["enc_norm"] = init_norm(cfg, cfg.d_model, dev)
    return params


def _keeps(cfg: ModelConfig, p: QTensor, keys) -> bool:
    """Is this QTensor a quant_dot consumer the site contracts directly (a
    down projection stored in the config's rotation-quant mode)?"""
    qc = cfg.quant
    return qc.rotating and qc.enabled and p.mode == qc.mode and _is_consumer(keys)


def _dequant_layer(cfg: ModelConfig, lp: dict, dtype) -> dict:
    """Dequantize a layer's QTensor leaves, keeping the quant_dot CONSUMER
    leaves (down projections, dense or per expert, stored in the config's
    rotation-quant mode) quantized: the ``QuantDotSpec`` site contracts them
    directly. Expert stacks dequantize a chunk of experts at a time
    (``QTensor.dequant``): one MoE layer's gate and up in f32 at maverick's
    width would be 43 GB."""
    def one(p, keys):
        if is_qleaf(p):
            if _keeps(cfg, p, keys):
                return p
            return p.dequant(dtype)
        if isinstance(p, dict):
            return {k: one(v, keys + (k,)) for k, v in p.items()}
        return p

    return {k: one(v, (k,)) for k, v in lp.items()}


def _layer_params(cfg: ModelConfig, lp: dict, dtype, parts=None, kind: str = "attn") -> dict:
    """One layer's parameters for use: gathered from this rank's shards
    under a mesh (``parts``; the dims a layer of ``kind`` splits over
    'model' stay split), then dequantized."""
    if parts is not None:
        lp = _gather(cfg, lp, parts, qweight_specs(_block_specs(cfg, kind), lp),
                     ("layers",))
    if cfg.weight_quant == "int8":
        return _dequant_layer(cfg, lp, dtype)
    return dequant_tree(lp, dtype)


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows for ``tokens``; a quantized table is dequantized
    after the gather (elementwise, so the same values as dequantizing the
    whole table first). With the vocabulary split over 'model' each rank
    looks up the tokens whose rows it holds, zeros for the others, and the
    ranks' rows are summed (one rank's row and zeros: exact)."""
    emb = _top(cfg, params, "emb")
    vs = vocab_split(cfg)
    if vs.size > 1:
        rows = cfg.padded_vocab // vs.size
        tokens = tokens - vs.index * rows
        inside = (tokens >= 0) & (tokens < rows)
        tokens = torch.where(inside, tokens, torch.zeros_like(tokens))
    if is_qleaf(emb):
        x = (emb.q[tokens].to(torch.float32) * emb.scale[0]).to(dtype_of(cfg))
    else:
        x = emb[tokens]
    if vs.size == 1:
        return x
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return C.reduce_from_model(x, vs.axes)


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocabulary, whole on every rank (with the
    vocabulary split over 'model', this rank's columns all-gathered)."""
    x = apply_norm(cfg, _top(cfg, params, "final_norm"), x)
    axes = vocab_split(cfg).axes
    x = C.copy_to_model(x, axes)
    if cfg.tie_embeddings:
        logits = x @ dequant_tree(_top(cfg, params, "emb"), x.dtype).T
    else:
        logits = x @ dequant_tree(_top(cfg, params, "unemb"), x.dtype)
    logits = C.gather_from_model(logits, axes, -1)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = float("-inf")
    return constrain(logits, "batch", "seq", "vocab")


def _ffn(cfg, kind: str, p, h: torch.Tensor):
    """The block's feed-forward half: (y, aux); aux is the MoE load-
    balancing loss (0 for a dense MLP)."""
    if kind == "moe":
        return M.apply_moe(cfg, p["moe"], h)
    return M.apply_mlp(cfg, p["mlp"], h), 0.0


def _block_norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """A block's norm of its input ``x``, whole over the positions. Under
    the 'seqpar' rule (``seq_split``) ``x`` is this rank's positions: the
    norm runs on them, its leaves' gradient (that of a rank's positions)
    summed over the split's ranks (``copy_to_model``), and the normed
    positions are gathered whole for the block."""
    sp = seq_split()
    if sp.size == 1:
        return apply_norm(cfg, p, x)
    p = {k: C.copy_to_model(v, sp.axes) for k, v in p.items()}
    return C.gather_from_model(apply_norm(cfg, p, x), sp.axes, 1)


def _local(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A block's branch output ``y`` on the positions of the residual
    stream ``x``: itself, or, under the 'seqpar' rule, this rank's positions
    of a ``y`` whole and alike on every rank (a summed branch is already
    reduce-scattered to them, ``collectives.reduce_from_model``)."""
    return y if y.shape[1] == x.shape[1] else C.local_positions(y)


def _block_prefill(cfg, kind, p, x, positions, enc_out, want_cache: bool):
    """One full-sequence block: (x, aux, cache or None). An 'enc_attn'
    block attends without the causal mask and keeps no cache; an 'xattn'
    block adds the cross attention to ``enc_out`` after its self-attention
    and caches the cross K / V beside its own; a recurrent block's cache
    is its state after the sequence. Under the 'seqpar' rule ``x`` is this
    rank's positions, and each branch runs on the whole sequence
    (``_block_norm``, ``_local``)."""
    if kind in ("rwkv", "mamba"):
        return _recurrent_prefill(cfg, kind, p, x, want_cache)
    h = _block_norm(cfg, p["norm1"], x)
    causal = kind != "enc_attn"
    cache = None
    if want_cache and causal:
        y, (ck, cv) = A.apply_attention(cfg, p["attn"], h, positions,
                                        return_kv=True)
        cache = {"k": ck, "v": cv}
    else:
        y = A.apply_attention(cfg, p["attn"], h, positions, causal=causal)
    x = x + _local(y, x)
    if kind == "xattn":
        h = _block_norm(cfg, p["norm_x"], x)
        xk, xv = A.cross_kv(cfg, p["xattn"], enc_out)
        x = x + _local(A.apply_cross_attention(cfg, p["xattn"], h, (xk, xv)), x)
        if cache is not None:
            cache.update(xk=xk, xv=xv)
    y, aux = _ffn(cfg, kind, p, _block_norm(cfg, p["norm2"], x))
    return x + _local(y, x), aux, cache


def _recurrent_prefill(cfg, kind, p, x, want_cache: bool):
    h = _block_norm(cfg, p["norm1"], x)
    if kind == "mamba":
        y, st = SSM.apply_mamba(cfg, p["mamba"], h, return_state=True)
        cache = st._asdict()
    else:
        y, (st, xp_t) = R.apply_rwkv_tmix(cfg, p["tmix"], h, return_state=True)
        x = x + _local(y, x)
        y, xp_c = R.apply_rwkv_cmix(cfg, p["cmix"], _block_norm(cfg, p["norm2"], x),
                                    return_state=True)
        cache = {"S": st, "xp_t": xp_t, "xp_c": xp_c}
    return x + _local(y, x), 0.0, cache if want_cache else None


def _run_stack(cfg, kinds, layers, x, positions, enc_out, want_cache: bool,
               parts=None):
    """Every layer of one stack in order: (x, aux summed, caches or None).
    Each layer's gathered and dequantized parameters live only while the
    layer runs (``parts``: the stack's ``param_parts`` under a mesh); in a
    pass that records gradients each block is recomputed in the backward
    pass unless ``cfg.remat`` is "none".

    Under the 'seqpar' rule (Megatron-style sequence parallelism, the
    reference's ``constrain(x, "batch", "seqpar", None)``) the residual
    stream between the blocks -- and so each block's input that the
    backward keeps -- is this rank's contiguous S / D of the positions
    (``model_split("seqpar", S)``, ``local_seq``); the stack returns it
    gathered whole."""
    caches: Optional[List[dict]] = [] if want_cache else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat != "none" and not want_cache and torch.is_grad_enabled()
    sp = model_split("seqpar", x.shape[1])
    with local_seq(sp):
        x = C.local_positions(x)
        for i, (kind, lp) in enumerate(zip(kinds, layers)):
            lparts = None if parts is None else parts[i]
            _tp_tick(cfg, kind)
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    _block_train, cfg, kind, lp, x, positions, enc_out, lparts, snapshot(),
                    use_reentrant=False)
            else:
                x, a, cache = _block_prefill(cfg, kind,
                                             _layer_params(cfg, lp, x.dtype, lparts, kind),
                                             x, positions, enc_out, want_cache)
                if want_cache:
                    caches.append(cache)
            aux = aux + a
            x = constrain(x, "batch", "seqpar", None)
    return C.gather_from_model(x, sp.axes, 1), aux, caches


def _block_train(cfg, kind, lp, x, positions, enc_out, lparts, snap):
    """One block for ``torch.utils.checkpoint``, under the sharding context
    ``snap`` it was first run in: its recomputation runs on the autograd
    engine's thread."""
    with restored(snap):
        x, aux, _ = _block_prefill(cfg, kind, _layer_params(cfg, lp, x.dtype, lparts, kind),
                                   x, positions, enc_out, False)
    return x, torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def _tp_tick(cfg: ModelConfig, kind: str) -> None:
    """On a tensor-parallel mesh, count one layer of ``kind`` run split
    over 'model' or replicated (module docstring); a MoE, RWKV6 or Mamba2
    layer that cannot split raises."""
    if model_size() == 1:
        return
    if kind == "rwkv":
        split = R.head_split(cfg).size > 1 and M.dff_split(cfg).size > 1
    elif kind == "mamba":
        split = SSM.head_split(cfg).size > 1
    elif kind == "moe":
        split = M.expert_split(cfg).size > 1 or M.expert_dff_split(cfg).size > 1
    else:
        split = A.head_splits(cfg)[0].size > 1 or M.dff_split(cfg).size > 1
    if not split and kind in ("moe", "rwkv", "mamba"):
        raise NotImplementedError(
            f"a {kind!r} layer of {cfg.name!r} cannot split over 'model' of size "
            f"{model_size()}: its heads, experts or hidden width do not divide it")
    TRACE_COUNTS[("tensor_parallel", kind, "split" if split else "replicated")] += 1


def kv_heads(cfg: ModelConfig) -> List[int]:
    """Each decoder layer's KV heads on this rank under the active mesh."""
    return [A.local_kv_heads(cfg)] * cfg.num_layers


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _embed_inputs(cfg: ModelConfig, params, batch):
    """(x, positions) for the decoder stack: the token embeddings, after
    the patch embeddings of a vlm; positions (B, S), or the batch's
    (3, B, S) M-RoPE streams; an encoder-decoder adds the sinusoidal
    positions of 0..S-1."""
    x = _embed(cfg, params, batch["tokens"])
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = batch["positions"] if cfg.mrope else _positions(B, S, x.device)
    if cfg.is_encdec:
        x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
    return x, positions


def _run_encoder(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """The encoder on precomputed frame embeddings (B, T, d) (the
    reference's stub of whisper's conv frontend): sinusoidal positions
    added, the 'enc_attn' layers, then ``enc_norm``."""
    B, T, _ = frames.shape
    x = frames + sinusoidal_positions(T, cfg.d_model, frames.device).to(frames.dtype)[None]
    x, _, _ = _run_stack(cfg, cfg.encoder_layer_kinds, params["enc_layers"], x,
                         _positions(B, T, x.device), None, False,
                         _mesh_parts(cfg, "enc_layers"))
    return apply_norm(cfg, _top(cfg, params, "enc_norm"), x)


def lm_forward(cfg: ModelConfig, params, batch, want_cache: bool = False):
    """Full-sequence forward of a batch (module docstring). Returns
    (logits (B, S, padded_vocab) over every position, patches included;
    aux (the MoE layers' load-balancing losses summed; 0 for a dense
    model); caches or None)."""
    _check_kinds(cfg)
    enc_out = None
    if cfg.is_encdec:
        enc_out = _run_encoder(cfg, params, batch["frames"].to(dtype_of(cfg)))
    x, positions = _embed_inputs(cfg, params, batch)
    x = constrain(x, "batch", "seq", None)
    x, aux, caches = _run_stack(cfg, cfg.layer_kinds, params["layers"], x,
                                positions, enc_out, want_cache,
                                _mesh_parts(cfg, "layers"))
    return _logits(cfg, params, x), aux, caches


def lm_loss(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over the labels >= 0 (f32 log-softmax
    over the padded vocabulary, whose padding columns are -inf), plus 0.01 x
    the MoE load-balancing loss. A vlm's logits at its patch positions are
    dropped first (the labels cover the tokens). Returns (loss, {"ce",
    "aux"}).

    Under a mesh whose step splits the batch rows, the cross-entropy is
    this rank's share of the whole batch's mean: its masked sum over the
    count of labels >= 0 on every rank, so that the shares (and their
    gradients, which the step sums over the ranks) add up to the
    reference's mean however unevenly the labels fall. The aux loss is the
    whole batch's on every rank (``mlp.apply_moe``)."""
    logits, aux, _ = lm_forward(cfg, params, batch)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    labels = batch["labels"].to(torch.int64)
    lf = logits.to(torch.float32)
    del logits
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    count, _ = C.row_sum(mask.sum())
    ce = ((lse - ll) * mask).sum() / torch.clamp_min(count, 1.0)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


def lm_prefill(cfg: ModelConfig, params, batch):
    """Forward pass returning (last-position logits, caches)."""
    logits, _, caches = lm_forward(cfg, params, batch, want_cache=True)
    return logits[:, -1:], caches


def pad_kv_caches(cfg: ModelConfig, caches, max_len: int):
    """Grow every layer's self-attention K/V cache along seq to
    ``max_len``; the cross attention's "xk" / "xv" keep the encoder's
    length, and a recurrent layer's state passes through unchanged."""
    out = []
    for c in caches:
        grown = {}
        for key, t in c.items():
            if key in ("k", "v") and t.shape[1] < max_len:
                g = torch.zeros((t.shape[0], max_len) + tuple(t.shape[2:]),
                                dtype=t.dtype, device=t.device)
                g[:, :t.shape[1]] = t
                t = g
            grown[key] = t
        out.append(grown)
    return out


def lm_decode_step(cfg: ModelConfig, params, caches, tokens: torch.Tensor,
                   cache_pos: torch.Tensor):
    """One decode step. tokens: (B, 1) int; cache_pos: () int shared by the
    batch, or (B,) per-slot positions (continuous batching); under M-RoPE
    the three streams all take the position. The caches are updated in
    place and returned with the logits (a recurrent layer's state too;
    it reads no position).

    An encoder-decoder adds the sinusoidal embedding of position 0 to
    every decoded token, where prefill adds positions 0..S-1: the
    reference's ``sinusoidal_positions(1, d)``, carried as it is
    (ROADMAP.md, "Reference health")."""
    _check_kinds(cfg)
    x = _embed(cfg, params, tokens)
    B = x.shape[0]
    if cfg.is_encdec:
        x = x + sinusoidal_positions(1, cfg.d_model, x.device).to(x.dtype)[None]
    if cache_pos.ndim == 1:
        positions = cache_pos[:, None].to(torch.int32)
    else:
        positions = cache_pos.reshape(1, 1).expand(B, 1).to(torch.int32)
    if cfg.mrope:
        positions = positions[None].expand(3, B, 1)
    parts = _mesh_parts(cfg, "layers")
    for i, (kind, lp, c) in enumerate(zip(cfg.layer_kinds, params["layers"], caches)):
        lparts = None if parts is None else parts[i]
        _tp_tick(cfg, kind)
        x = _block_decode(cfg, kind, _layer_params(cfg, lp, x.dtype, lparts, kind), x,
                          c, cache_pos, positions)
    return _logits(cfg, params, x), caches


def _block_decode(cfg, kind, p, x, c, cache_pos, positions):
    if kind in ("rwkv", "mamba"):
        return _recurrent_decode(cfg, kind, p, x, c)
    h = apply_norm(cfg, p["norm1"], x)
    y, c["k"], c["v"] = A.decode_attention(cfg, p["attn"], h, c["k"], c["v"],
                                           cache_pos, positions)
    x = x + y
    if kind == "xattn":
        h = apply_norm(cfg, p["norm_x"], x)
        x = x + A.apply_cross_attention(cfg, p["xattn"], h, (c["xk"], c["xv"]))
    return x + _ffn(cfg, kind, p, apply_norm(cfg, p["norm2"], x))[0]


def _recurrent_decode(cfg, kind, p, x, c):
    """One token through a recurrent block, its state ``c`` updated in
    place."""
    h = apply_norm(cfg, p["norm1"], x)
    if kind == "mamba":
        y, st = SSM.decode_mamba(cfg, p["mamba"], h, SSM.MambaState(**c))
        for key, t in st._asdict().items():
            c[key].copy_(t)
        return x + y
    y, (st, xp_t) = R.decode_rwkv_tmix(cfg, p["tmix"], h, (c["S"], c["xp_t"]))
    x = x + y
    y, xp_c = R.decode_rwkv_cmix(cfg, p["cmix"], apply_norm(cfg, p["norm2"], x), c["xp_c"])
    for key, t in (("S", st), ("xp_t", xp_t), ("xp_c", xp_c)):
        c[key].copy_(t)
    return x + y
