"""The LM zoo's production steps (port of ``repro.launch.steps``).

  fl_train_step: one FL round.  Each participant slot's sequences carry
    their FedAvg weight n_k / n inside the loss (``batch["weight"]``), so
    the gradient of the weighted loss IS the FedAvg aggregate.
    ``local_passes`` = E re-passes the SAME round batch E times and
    accumulates the gradients (E x compute, the upload unchanged), then SGD
    with momentum applies the mean.  ``microbatches`` splits the round batch
    to bound activation memory (flops unchanged).
  prefill_step: the full-sequence forward that builds the KV cache (last
    position's logits).
  serve_step: ONE token against the cache (ring-buffered or recurrent for
    sub-quadratic archs; full-attention archs beyond 65,536 positions are
    served under the sliding-window variant), optionally from int8 weights
    dequantised inside every step.

Each ``make_*`` takes ``mesh=``.  Without one (the default) the step runs on
the one device that holds the tensors.  With a ``DeviceMesh`` of axes
``("data", "model")`` or ``("pod", "data", "model")``
(``launch/mesh.make_mesh``) it runs as the reference's runs under GSPMD:
inside ``activation_rules`` with the reference's rules, params and momentum
DTensors placed by ``param_shardings`` (``place_params``), the batch split
on its ``batch`` axes, the LM kernels on each rank's shards
(``local_map``), and the weighted gradient reduction that DTensor issues
(an all-reduce or a reduce-scatter per leaf onto its params' placements)
is the FedAvg aggregate, as GSPMD's is in the reference.  The steps take
plain tensors (the same on every rank) or DTensors, place them, and return
the loss, metrics and logits as plain tensors (gathered), params, momentum
and caches as DTensors.  bf16 is their default dtype, as the reference's.
Departures of form:

  * the reference donates params and momentum (``donate_argnums``); here
    ``fl_train_step`` updates both trees in place under ``no_grad`` after
    the backward passes (their graph is freed by then) and returns them,
    and ``serve_step`` writes the new token's keys and values into the
    cache in place;
  * the reference sums gradients into f32 zeros.  Here f32 params sum in
    their ``.grad`` over microbatches and passes, in the same order (the
    same bits); params of another dtype sum each pass's gradient, rounded
    to that dtype as the reference's is, into an f32 accumulator when
    ``microbatches * local_passes > 1``, and take it as it is when there is
    one;
  * ``resident_experts`` only changes the reference's sharding rules, so on
    one device it is accepted and computes the same thing;
  * on a mesh, ``serve_step`` writes the new entry into the local shard
    that holds its slot, and ``microbatches`` cuts the global batch before
    it is placed, so each microbatch is split over the batch's axes as a
    whole round batch is.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels.ref import RECIP_127
from repro_torch.launch.mesh import axis_size
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import stacked as stacked_mod
from repro_torch.models.common import MetaGenerator
from repro_torch.sharding import specs as sh
from repro_torch.sharding.ctx import activation_rules, is_dtensor
from repro_torch.tree import leaves, tree_map

DEFAULT_LR = 3e-4
DEFAULT_MOMENTUM = 0.9


def _quantize_dequantize_ste(w: torch.Tensor) -> torch.Tensor:
    """int8 fake quantisation with a straight-through gradient: per row of
    the last axis, scale = max|w| / 127 (at least 1e-8), values rounded half
    to even (``torch.round``, as ``jnp.round``) and clipped to +-127; the
    value is the dequantised tensor.  The gradient is the reference's: the
    identity through ``w - w.detach()``, plus the scale's own gradient
    through max|w| (the integer values carry none).  Leaves with fewer
    than 2 dims pass through.  The division by 127 is a multiply by its f32
    reciprocal, as XLA compiles the reference's (ROADMAP.md section 3,
    departure 1), so the two packages quantise to the same bits."""
    if w.dim() < 2 or w.dtype not in (torch.bfloat16, torch.float32):
        return w
    wf = w.to(torch.float32)
    scale = torch.clamp_min(wf.abs().amax(dim=-1, keepdim=True) * RECIP_127,
                            1e-8)
    with torch.no_grad():
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    deq = (q.to(torch.float32) * scale).to(w.dtype)
    return deq + (w - w.detach())


def batch_rows(mesh) -> int:
    """The batch's shards on ``mesh``: data x pod (the reference's
    ``mesh.shape["data"] * mesh.shape.get("pod", 1)``)."""
    return axis_size(mesh, "data") * axis_size(mesh, "pod", 1)


def train_step_rules(multi_pod: bool = False, seq_parallel: bool = True):
    """The train step's logical rules (``seq`` off without sequence
    parallelism)."""
    rules = sh.train_rules(multi_pod)
    if not seq_parallel:
        rules["seq"] = None
    return rules


def prefill_step_rules(multi_pod: bool = False):
    """The prefill step's rules: decode's, the batch on its axes."""
    rules = sh.decode_rules(multi_pod, shard_seq=False)
    rules["batch"] = ("pod", "data") if multi_pod else "data"
    return rules


def serve_step_rules(mesh, batch: int, multi_pod: bool = False,
                     resident_experts: bool = False):
    """The serve step's rules: the cache's sequence sharded over every axis
    when the batch is smaller than its shards; with ``resident_experts``
    the experts' d_ff dim on "data" instead of FSDP over d_model."""
    rules = sh.decode_rules(multi_pod, shard_seq=batch < batch_rows(mesh))
    if resident_experts:
        rules["residual"] = None
        rules["moe_inner"] = "data"
    return rules


@contextlib.contextmanager
def _on_mesh(mesh, rules):
    """The mesh's context for a step: its rules, and plain tensors made
    inside the models (positions, masks, zeros) taken as replicated."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with activation_rules(mesh, rules), implicit_replication():
        yield


def _plain(x):
    """A DTensor gathered whole; anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def param_struct(cfg: ModelConfig, dtype=torch.bfloat16, *,
                 stacked: bool = False):
    """The params' tree as tensors on the ``meta`` device: shapes and
    dtypes, nothing allocated."""
    init = stacked_mod.init_params_stacked if stacked else lm_mod.init_params
    return init(cfg, MetaGenerator(), dtype)


def _frontend_struct(cfg: ModelConfig, batch: int, dtype):
    f = cfg.frontend
    return torch.empty((batch, f.seq_len, f.feature_dim), dtype=dtype,
                       device="meta")


def make_fl_train_step(cfg: ModelConfig, shape: InputShape, *,
                       mesh=None, multi_pod: bool = False,
                       lr: float = DEFAULT_LR,
                       momentum: float = DEFAULT_MOMENTUM,
                       local_passes: int = 1, microbatches: int = 1,
                       remat: bool = True, dtype=torch.bfloat16,
                       seq_parallel: bool = True,
                       quantize_comm: bool = False,
                       moe_mode: str = "dense"):
    """One FL round over layer-stacked params.  Returns ``(step,
    (p_struct, m_struct, batch_struct))``, the structs on the ``meta``
    device.

    ``step(params, momentum_state, batch) -> (params, momentum_state,
    loss, metrics)``: batch is {tokens (B, S), labels (B, S), weight (B,),
    frontend?}; params and momentum are updated in place and returned;
    loss and metrics are those of the first pass (averaged over
    microbatches).  On ``mesh`` params and momentum are placed by
    ``param_shardings`` (once, if they are not DTensors yet) and the
    hierarchical MoE's rows are the batch's shards (data x pod); without
    one its rows are 16, as the reference's default."""
    if moe_mode not in ("dense", "dispatch", "hierarchical"):
        raise ValueError(f"unknown moe_mode {moe_mode!r}")
    b, s = shape.global_batch, shape.seq_len
    if b % microbatches:
        raise ValueError(f"batch {b} is not a multiple of microbatches="
                         f"{microbatches}")
    mb_size = b // microbatches
    rules = None if mesh is None else train_step_rules(multi_pod,
                                                       seq_parallel)
    rows = 16 if mesh is None else batch_rows(mesh)

    def loss(params, batch):
        if quantize_comm:   # the int8 upload, straight-through
            params = tree_map(_quantize_dequantize_ste, params)
        with ffn_mod.moe_impl(moe_mode, rows=rows):
            return stacked_mod.loss_fn(params, cfg, batch, remat=remat)

    n = microbatches * local_passes

    def place(mb):
        return mb if mesh is None else {
            k: sh.place_batch(v, mesh, rules) for k, v in mb.items()}

    def fl_train_step(params, momentum_state, batch: Dict[str, Any]):
        if mesh is not None:
            params = sh.place_params(params, mesh, rules)
            momentum_state = sh.place_like(momentum_state, params)
        ps = leaves(params)
        for p in ps:
            p.grad = None
            p.requires_grad_(True)
        # an f32 sum for the gradients of params in another dtype
        acc = {i: torch.zeros_like(p, dtype=torch.float32)
               for i, p in enumerate(ps)
               if n > 1 and p.dtype != torch.float32}
        micro = [place(batch)] if microbatches == 1 else [
            place({k: v[i * mb_size:(i + 1) * mb_size]
                   for k, v in batch.items()})
            for i in range(microbatches)]
        losses, metricss = [], []
        with _on_mesh(mesh, rules):
            try:
                for e in range(local_passes):
                    for mb in micro:
                        l, metrics = loss(params, mb)
                        l.backward()
                        for i, a in acc.items():
                            if ps[i].grad is not None:
                                a.add_(_reduced(ps[i].grad, ps[i]))
                                ps[i].grad = None
                        if e == 0:
                            losses.append(_plain(l.detach()))
                            metricss.append({k: _plain(v.detach())
                                             for k, v in metrics.items()})
            finally:
                for p in ps:
                    p.requires_grad_(False)
            with torch.no_grad():
                for i, (p, m) in enumerate(zip(ps, leaves(momentum_state))):
                    g = acc.get(i)
                    if g is None:
                        g = torch.zeros_like(p) if p.grad is None \
                            else _reduced(p.grad, p)
                    p.grad = None
                    g.div_(n)
                    m.mul_(momentum).add_(g.to(m.dtype))
                    # lr in the params' dtype, as the reference's weakly
                    # typed ``lr * m.astype(p.dtype)``
                    lr_p = float(torch.tensor(lr, dtype=p.dtype))
                    p.sub_(lr_p * m.to(p.dtype))
        if microbatches == 1:
            l, metrics = losses[0], metricss[0]
        else:
            l = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricss]).mean()
                       for k in metricss[0]}
        return params, momentum_state, l, metrics

    p_struct = param_struct(cfg, dtype, stacked=True)
    m_struct = tree_map(lambda x: torch.empty(x.shape, dtype=torch.float32,
                                              device="meta"), p_struct)
    batch_struct: Dict[str, Any] = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device="meta"),
        "labels": torch.empty((b, s), dtype=torch.int32, device="meta"),
        "weight": torch.empty((b,), dtype=torch.float32, device="meta"),
    }
    if cfg.frontend is not None:
        batch_struct["frontend"] = _frontend_struct(cfg, b, dtype)
    return fl_train_step, (p_struct, m_struct, batch_struct)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _reduced(g, p):
    """A gradient on its param's placements: on a mesh the sums over the
    batch's and the model's shards that DTensor left pending (the FedAvg
    aggregate) are reduced here; on one device ``g`` itself."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_prefill_step(cfg: ModelConfig, shape: InputShape, *,
                      mesh=None, multi_pod: bool = False,
                      dtype=torch.bfloat16,
                      decode_window: Optional[int] = None):
    """The prompt pass.  Returns ``(step, (p_struct, tok_struct[,
    frontend_struct]))``, the structs on the ``meta`` device.

    ``step(params, tokens, frontend=None) -> (logits (B, V), cache)``: a
    stacked cache of ``shape.seq_len`` positions in ``dtype`` (a sliding
    window of ``decode_window`` on full-attention layers, when given) on
    the tokens' device, filled by the prompt ``tokens`` (B, S'), S' <=
    ``shape.seq_len``, in place; the logits are the last position's.  On
    ``mesh`` params and inputs are placed as the reference's prefill
    places them (the batch on its axes), and the cache is made already
    placed by ``cache_specs`` under those rules: each rank allocates and
    fills only its own shard (``sharding.specs.empty_cache``)."""
    b, s = shape.global_batch, shape.seq_len
    rules = None if mesh is None else prefill_step_rules(multi_pod)

    def prefill_step(params, tokens, frontend=None):
        if mesh is not None:
            params = sh.place_params(params, mesh, rules)
            tokens = sh.place_batch(tokens, mesh, rules)
            if frontend is not None:
                frontend = sh.place_batch(frontend, mesh, rules)
        with _on_mesh(mesh, rules), ffn_mod.moe_impl("dense"):
            kw = dict(decode_window=decode_window, dtype=dtype)
            if mesh is None:
                cache = stacked_mod.init_cache_stacked(
                    cfg, tokens.shape[0], s, device=tokens.device, **kw)
            else:   # each rank allocates only its shard
                with FakeTensorMode():      # shapes only, not traced
                    struct = stacked_mod.init_cache_stacked(
                        cfg, tokens.shape[0], s, device="meta", **kw)
                cache = sh.empty_cache(struct, mesh, rules,
                                       tokens.to_local().device)
            logits, cache = stacked_mod.prefill(params, cfg, tokens, cache,
                                                frontend=frontend)
            if mesh is not None:
                cache = sh.place_cache(cache, mesh, rules)
        return _plain(logits), cache

    args = (param_struct(cfg, dtype, stacked=True),
            torch.empty((b, s), dtype=torch.int32, device="meta"))
    if cfg.frontend is not None:
        args = args + (_frontend_struct(cfg, b, dtype),)
    return prefill_step, args


# ---------------------------------------------------------------------------
# serve (decode one token), with the int8-weight variant
# ---------------------------------------------------------------------------

def _quantizable(leaf) -> bool:
    """The reference's rule: a matrix (ndim >= 2) of at least 2^20
    elements in bf16 or f32."""
    return leaf is not None and leaf.dim() >= 2 and \
        leaf.numel() >= (1 << 20) and \
        leaf.dtype in (torch.bfloat16, torch.float32)


def quantize_param_structs(p_struct):
    """Split a param struct tree into (int8 mirror, scales tree): a
    quantisable leaf becomes int8 of its shape and an f32 scale of its
    shape with the last axis 1; the rest pass through (scale None)."""
    def q(leaf):
        if _quantizable(leaf):
            return torch.empty(leaf.shape, dtype=torch.int8, device="meta")
        return leaf

    def sc(leaf):
        if _quantizable(leaf):
            return torch.empty(leaf.shape[:-1] + (1,), dtype=torch.float32,
                               device="meta")
        return None

    return tree_map(q, p_struct), tree_map(sc, p_struct)


def quantize_params(params):
    """Runtime int8 quantisation of the quantisable leaves: per row of the
    last axis, scale = max(max|w| / 127, 1e-8) in f32 and values
    ``clip(round(w / scale), -127, 127)`` (round half to even), as the
    reference's eager ``quantize_params`` computes them (a true division by
    127, not XLA's reciprocal: the reference does not jit it).  Returns
    (int8-or-passthrough tree, scales tree with None for the rest)."""
    def scale(w):
        if not _quantizable(w):
            return None
        return torch.clamp_min(
            w.to(torch.float32).abs().amax(dim=-1, keepdim=True) / 127.0,
            1e-8)

    def q(w, sc):
        if sc is None:
            return w
        return torch.clamp(torch.round(w.to(torch.float32) / sc), -127,
                           127).to(torch.int8)

    scales = tree_map(scale, params)
    return tree_map(q, params, scales), scales


def dequantize_params(params_q, scales, dtype=torch.bfloat16):
    """int8 leaves times their f32 scale, rounded to ``dtype``; leaves
    without a scale pass through."""
    def deq(q, s):
        if s is None:
            return q
        return (q.to(torch.float32) * s).to(dtype)
    return tree_map(deq, params_q, scales)


def make_serve_step(cfg: ModelConfig, shape: InputShape, *,
                    mesh=None, multi_pod: bool = False,
                    dtype=torch.bfloat16, quantize_weights: bool = False,
                    resident_experts: bool = False):
    """One decoded token.  Returns ``(step, (p_struct, cache_struct,
    token_struct, pos_struct[, scale_struct]))`` on the ``meta`` device.

    ``step(params, cache, token, pos, scales=None) -> (logits (B, V),
    cache)``: token (B,) int, pos the token's position; the cache is a
    stacked cache of ``shape.seq_len`` positions (``make_prefill_step``'s,
    or ``stacked.init_cache_stacked``) and is updated in place.  A
    full-attention arch beyond 65,536 positions is served under its
    ``long_context_window`` (the reference's rule).  With
    ``quantize_weights`` params are ``quantize_params``' int8 tree and
    ``scales`` its scales, dequantised to ``dtype`` inside every step.
    ``resident_experts`` changes only the reference's sharding rules.  On
    ``mesh`` the params (int8 ones too; scales whole on every rank) are
    placed by ``param_shardings``, the cache by ``cache_specs``, under
    decode's rules (the cache's sequence split over every axis when the
    batch is smaller than its shards)."""
    b, s = shape.global_batch, shape.seq_len
    force_window = (not cfg.subquadratic) and s > 65536
    decode_window = cfg.long_context_window if force_window else None
    rules = None if mesh is None else serve_step_rules(
        mesh, b, multi_pod, resident_experts)

    p_struct = param_struct(cfg, dtype, stacked=True)
    scale_struct = None
    if quantize_weights:
        p_struct, scale_struct = quantize_param_structs(p_struct)

    def serve_step(params, cache, token, pos, scales=None):
        if mesh is not None:
            params = sh.place_params(params, mesh, rules)
            cache = sh.place_cache(cache, mesh, rules)
            token = sh.place_batch(token, mesh, rules)
        with _on_mesh(mesh, rules), ffn_mod.moe_impl("dense"):
            if quantize_weights:
                params = dequantize_params(params, scales, dtype)
            logits, cache = stacked_mod.decode_step(params, cfg, token,
                                                    int(pos), cache)
            if mesh is not None:
                cache = sh.place_cache(cache, mesh, rules)
        return _plain(logits), cache

    cache_struct = stacked_mod.init_cache_stacked(
        cfg, b, s, decode_window=decode_window, dtype=dtype, device="meta")
    args = [p_struct, cache_struct,
            torch.empty((b,), dtype=torch.int32, device="meta"),
            torch.empty((), dtype=torch.int32, device="meta")]
    if quantize_weights:
        args.append(scale_struct)
    return serve_step, tuple(args)


def step_for_shape(cfg: ModelConfig, shape: InputShape, **kw):
    """Dispatch on the shape kind -> (step, example structs); ``mesh=``
    and ``multi_pod=`` pass through."""
    if shape.kind == "train":
        return make_fl_train_step(cfg, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, **kw)
    if shape.kind == "decode":
        return make_serve_step(cfg, shape, **kw)
    raise ValueError(shape.kind)
