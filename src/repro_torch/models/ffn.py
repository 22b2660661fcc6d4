"""Feed-forward layers: the dense gated MLP (SwiGLU / GeGLU) and the top-k
mixture of experts.

Port of ``repro.models.ffn``.  The MoE routes each token to its top-k
experts through an f32 router.  Two ways to run the experts, as in the
reference:

  * ``moe_ffn_dispatch`` (the full-sequence default): capacity-based
    scatter dispatch.  Each (token, slot) takes the next place in its
    expert's buffer of ``1.25 * T * k / E`` places (rounded up to a
    multiple of 8); overflowing tokens are dropped (Switch-style) and land,
    zeroed, in the last place.  The expert products run on the (E, C, d)
    buffers; the reference's ``.at[].add`` is ``index_add_``.
  * ``moe_ffn_dense``, the serving path (prefill and decode): every expert
    sees every token and the top-k combine weights zero the rest.  It
    drops nothing, so a token's value never depends on what else is in the
    batch.

  * ``moe_ffn_hierarchical``, the train step's MoE on a device mesh:
    capacity dispatch batched over ``rows`` data-shard rows.  Each row
    dispatches its own tokens into (E, C_row, d) buffers, C_row = 1.25 *
    (T / rows) * k / E rounded up to a multiple of 8, and the expert
    products run at capacity on (R, E, C, d); it falls back to the dense
    path when the rows do not split the tokens or hold fewer than E.

``moe_impl(kind, rows=16)`` switches ``moe_ffn`` to ``kind`` for the
enclosed calls (a context variable, so concurrent callers do not see each
other's choice).

On a device mesh (``repro_torch.sharding``) the reference's constraints
place the expert buffers and products (experts on "model", tokens on the
batch's axes).  DTensor has no sharding rule for the router's sort nor
for the dispatch's cumsum, scatter and gather, so those run on each
rank's local rows through ``local_map``: the router on its tokens (the
router weights gathered whole), the hierarchical dispatch and combine on
its rows, whose scatter never crosses a row (the reason the reference
batches it), and the hierarchical expert products on each rank's rows of
its own experts (``_expert_local``).  The full-sequence dispatch path's
positions run over all tokens, so on a mesh it runs as the hierarchical
impl's one row: every rank dispatches all the tokens (gathered) into the
(E, C, d) buffers, whose experts stay split, and computes the products of
its own experts.

Top-k order: ``jax.lax.top_k`` puts the lower expert index first among
equal probabilities; the port sorts with a stable descending sort, which
does the same (``torch.topk`` promises no order for ties).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import activation, dense_init
from repro_torch.sharding.ctx import (PartitionSpec as P, current_rules,
                                      is_dtensor, logical_constraint,
                                      rows_local, to_placements, unshard)
from repro_torch.sharding.specs import fit_spec

CAPACITY_FACTOR = 1.25
# the profiler range around the expert products (``launch/profile_serve``)
EXPERT_RANGE = "moe_expert_products"

_MOE_IMPL = contextvars.ContextVar("moe_impl", default="dispatch")


_MOE_ROWS = contextvars.ContextVar("moe_rows", default=16)


def current_moe_impl() -> Tuple[str, int]:
    """The impl ``moe_ffn`` takes here ("dispatch" unless inside
    ``moe_impl``) and the hierarchical impl's rows."""
    return _MOE_IMPL.get(), _MOE_ROWS.get()


@contextlib.contextmanager
def moe_impl(kind: str, rows: int = 16):
    """Run ``moe_ffn`` as ``"dispatch"``, ``"dense"`` or
    ``"hierarchical"`` (over ``rows`` data-shard rows) inside the block."""
    if kind not in ("dispatch", "dense", "hierarchical"):
        raise ValueError(f"unknown MoE impl {kind!r}")
    token = _MOE_IMPL.set(kind)
    token_rows = _MOE_ROWS.set(rows)
    try:
        yield
    finally:
        _MOE_ROWS.reset(token_rows)
        _MOE_IMPL.reset(token)


# ---------------------------------------------------------------------------
# dense gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp_params(gen: torch.Generator, d_model: int, d_ff: int,
                    dtype=torch.float32):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }


def mlp(params, x: torch.Tensor, act_name: str = "silu") -> torch.Tensor:
    act = activation(act_name)
    h = act(x @ params["w_gate"])
    h = h * (x @ params["w_up"])
    h = logical_constraint(h, ("batch", None, "ff"))
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def init_moe_params(gen: torch.Generator, d_model: int, moe: MoEConfig,
                    dtype=torch.float32):
    e, f = moe.n_experts, moe.d_ff_expert
    return {
        "router": dense_init(gen, (d_model, e), dtype),
        "we_gate": dense_init(gen, (e, d_model, f), dtype),
        "we_up": dense_init(gen, (e, d_model, f), dtype),
        "we_down": dense_init(gen, (e, f, d_model), dtype, fan_in=f),
    }


def _route_local(xf, router, moe: MoEConfig):
    e, k = moe.n_experts, moe.top_k
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                         # (T, E)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = top.values[:, :k], top.indices[:, :k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    top1 = F.one_hot(expert_ids[:, 0], e).to(torch.float32)
    return gate_vals, expert_ids, probs, top1


def _route(params, xf: torch.Tensor, moe: MoEConfig):
    """xf: (T, d) -> gates (T, k) renormalised, expert ids (T, k), the
    Switch load-balance loss over the top-1 assignment.  On a mesh each
    rank routes its own tokens against the whole router."""
    e = moe.n_experts
    gate_vals, expert_ids, probs, top1 = rows_local(
        lambda x_, r_: _route_local(x_, r_, moe), 4, xf,
        whole=params["router"])
    frac_tokens = top1.mean(0)
    frac_probs = probs.mean(0)
    aux = moe.aux_loss_coef * e * torch.sum(frac_tokens * frac_probs)
    return gate_vals, expert_ids, aux


def moe_ffn(params, x: torch.Tensor, moe: MoEConfig, act_name: str = "silu",
            capacity_factor: float = CAPACITY_FACTOR
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux loss), by the impl ``moe_impl`` chose."""
    kind = _MOE_IMPL.get()
    if kind == "dense":
        return moe_ffn_dense(params, x, moe, act_name)
    if kind == "hierarchical":
        return moe_ffn_hierarchical(params, x, moe, act_name,
                                    rows=_MOE_ROWS.get(),
                                    capacity_factor=capacity_factor)
    return moe_ffn_dispatch(params, x, moe, act_name, capacity_factor)


def _dispatch_rows(xr, ids, e: int, capacity: int):
    """Each row's capacity dispatch.  xr (R, tr, d), ids (R, tr, k) ->
    buffers (R, E, C, d), keep (R, tr*k) and the flat place of each
    (token, slot) in its row's E*C places, the dropped ones in the last
    place (zeroed)."""
    r, tr, d = xr.shape
    k = ids.shape[-1]
    flat_ids = ids.reshape(r, tr * k)
    onehot = F.one_hot(flat_ids, e)                               # (R,tr*k,E)
    pos_all = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos_all, 2, flat_ids[..., None])[..., 0]
    keep = pos < capacity
    dest = torch.where(keep, flat_ids * capacity + pos,
                       torch.full_like(pos, e * capacity - 1))
    xk = xr[:, :, None, :].expand(r, tr, k, d).reshape(r, tr * k, d)
    xk = torch.where(keep[..., None], xk,
                     torch.zeros((), dtype=xk.dtype, device=xk.device))
    row0 = torch.arange(r, device=xr.device)[:, None] * (e * capacity)
    buf = torch.zeros((r * e * capacity, d), dtype=xr.dtype, device=xr.device)
    buf.index_add_(0, (dest + row0).reshape(-1), xk.reshape(r * tr * k, d))
    return buf.reshape(r, e, capacity, d), keep, dest


def _combine_rows(out_buf, keep, dest, gv):
    """Each row's gate-weighted sum of its k slots: out_buf (R, E, C, d),
    keep/dest (R, tr*k), gv (R, tr, k) -> (R, tr, d)."""
    r, e, c, d = out_buf.shape
    tr, k = gv.shape[1:]
    flat = out_buf.reshape(r, e * c, d)
    gathered = torch.gather(flat, 1, dest[..., None].expand(r, tr * k, d))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=flat.dtype,
                                       device=flat.device))
    return (gathered.reshape(r, tr, k, d)
            * gv[..., None].to(flat.dtype)).sum(dim=2)


def _expert_local(fn, bufs, *ws):
    """``fn(bufs, *ws)``, the expert products on (R, E, C, d) buffers.  On
    a mesh each rank computes its own rows' buffers of its own experts
    (``local_map``), the buffers placed as the reference constrains them
    (rows on "moe_tokens", experts on "expert") and the weights gathered
    whole but for their expert dim: GSPMD's layout, stated, since DTensor
    cannot flatten these products' sharded dims itself.  A weight's
    gradient is then a sum over each rank's rows (pending on the rows'
    mesh dims)."""
    if not is_dtensor(bufs):
        return fn(bufs, *ws)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    rules, mesh = current_rules(), bufs.device_mesh
    b_pl = to_placements(fit_spec(P(rules.get("moe_tokens"),
                                    rules.get("expert"), None, None),
                                  bufs.shape, mesh), mesh)
    e_ax = [p if isinstance(p, Shard) and p.dim == 1 else None
            for p in b_pl]
    w_pl = [Shard(0) if e is not None else Replicate() for e in e_ax]
    w_grad = [Shard(0) if e is not None else
              (Partial() if isinstance(p, Shard) else Replicate())
              for e, p in zip(e_ax, b_pl)]
    n = len(ws)
    return local_map(fn, out_placements=list(b_pl),
                     in_placements=(list(b_pl),) + (w_pl,) * n,
                     in_grad_placements=(list(b_pl),) + (w_grad,) * n,
                     device_mesh=mesh, redistribute_inputs=True)(bufs, *ws)


def moe_ffn_hierarchical(params, x: torch.Tensor, moe: MoEConfig,
                         act_name: str = "silu", *, rows: int = 16,
                         capacity_factor: float = CAPACITY_FACTOR
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch batched over ``rows`` data-shard rows: each row
    dispatches its own T/rows tokens into (E, C_row, d) buffers, then the
    expert products run at capacity (~1.25x the active params' flops).
    The dense path when ``T % rows`` or ``T // rows < E``."""
    b, s, _ = x.shape
    if (b * s) % rows or (b * s) // rows < moe.n_experts:
        return moe_ffn_dense(params, x, moe, act_name)
    return _capacity_rows(params, x, moe, act_name, rows, capacity_factor)


def _capacity_rows(params, x: torch.Tensor, moe: MoEConfig, act_name: str,
                   rows: int, capacity_factor: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hierarchical impl without its fallback: ``rows`` rows of
    T/rows tokens, each dispatched into its own (E, C_row, d) buffers."""
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    t = b * s
    xf = unshard(x, (1, 2)).reshape(t, d)
    gate_vals, expert_ids, aux = _route(params, xf, moe)
    tr = t // rows
    capacity = int(max(1, capacity_factor * tr * k / e))
    capacity = (capacity + 7) // 8 * 8

    xr = xf.reshape(rows, tr, d)
    ids_r = expert_ids.reshape(rows, tr, k)
    gv_r = gate_vals.reshape(rows, tr, k)
    bufs, keeps, dests = rows_local(
        lambda x_, i_: _dispatch_rows(x_, i_, e, capacity), 3, xr, ids_r)
    bufs = logical_constraint(bufs, ("moe_tokens", "expert", None, None))

    act = activation(act_name)

    def products(bufs_, wg, wu, wd):
        h = act(torch.einsum("recd,edf->recf", bufs_, wg))
        h = h * torch.einsum("recd,edf->recf", bufs_, wu)
        h = logical_constraint(h, ("moe_tokens", "expert", None, None))
        return torch.einsum("recf,efd->recd", h, wd)

    with record_function(EXPERT_RANGE):
        out_buf = _expert_local(products, bufs, params["we_gate"],
                                params["we_up"], params["we_down"])
    out_buf = logical_constraint(out_buf,
                                 ("moe_tokens", "expert", None, None))
    y = rows_local(_combine_rows, 1, out_buf, keeps, dests, gv_r)
    return y.reshape(b, s, d), aux.to(x.dtype)


def moe_ffn_dense(params, x: torch.Tensor, moe: MoEConfig,
                  act_name: str = "silu"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked dense-expert MoE: every expert sees every token; the top-k
    combine weights zero the rest.  Numerically capacity-infinite top-k."""
    b, s, d = x.shape
    e = moe.n_experts
    t = b * s
    xf = unshard(x, (1, 2)).reshape(t, d)
    gate_vals, expert_ids, aux = _route(params, xf, moe)
    combine = rows_local(
        lambda i_, g_: (F.one_hot(i_, e).to(torch.float32)
                        * g_[..., None]).sum(dim=1), 1,
        expert_ids, gate_vals)                                    # (T, E)
    combine = logical_constraint(combine, ("moe_tokens", "expert"))
    act = activation(act_name)
    with record_function(EXPERT_RANGE):
        h = act(torch.matmul(xf, params["we_gate"]))              # (E, T, f)
        h = h * torch.matmul(xf, params["we_up"])
        h = logical_constraint(h, ("expert", "moe_tokens", None))
        y_e = torch.matmul(h, params["we_down"])                  # (E, T, d)
    y_e = logical_constraint(y_e, ("expert", "moe_tokens", None))
    y = torch.einsum("etd,te->td", y_e, combine.to(y_e.dtype))
    return y.reshape(b, s, d), aux.to(x.dtype)


def moe_ffn_dispatch(params, x: torch.Tensor, moe: MoEConfig,
                     act_name: str = "silu",
                     capacity_factor: float = CAPACITY_FACTOR
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux loss), overflowing tokens dropped.  Its
    queue positions run over all T tokens, so on a mesh it is the
    hierarchical impl's one row: every rank dispatches all the tokens and
    computes its own experts' products."""
    if is_dtensor(x):
        return _capacity_rows(params, x, moe, act_name, 1, capacity_factor)
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    t = b * s
    xf = x.reshape(t, d)
    gate_vals, expert_ids, aux = _route(params, xf, moe)

    capacity = int(max(1, capacity_factor * t * k / e))
    capacity = (capacity + 7) // 8 * 8     # a multiple of 8, as the reference

    # place of each (token, slot) in its expert's queue
    flat_ids = expert_ids.reshape(-1)                             # (T*k,)
    onehot = F.one_hot(flat_ids, e)                               # (T*k, E)
    pos_in_expert = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos_in_expert, 1, flat_ids[:, None])[:, 0]
    keep = pos < capacity
    # dropped tokens go, zeroed, to the last place (the overflow bin)
    dest = torch.where(keep, flat_ids * capacity + pos,
                       torch.full_like(pos, e * capacity - 1))

    xk = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    xk = torch.where(keep[:, None], xk, torch.zeros((), dtype=xk.dtype,
                                                    device=xk.device))
    buf = torch.zeros((e * capacity, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, dest, xk)
    buf = buf.reshape(e, capacity, d)

    act = activation(act_name)
    with record_function(EXPERT_RANGE):
        h = act(torch.bmm(buf, params["we_gate"]))                # (E, C, f)
        h = h * torch.bmm(buf, params["we_up"])
        out_buf = torch.bmm(h, params["we_down"])                 # (E, C, d)

    # gather back to (T*k, d); dropped tokens contribute zero
    out_flat = out_buf.reshape(e * capacity, d)
    gathered = torch.where(keep[:, None], out_flat[dest],
                           torch.zeros((), dtype=out_flat.dtype,
                                       device=out_flat.device))
    combined = (gathered.reshape(t, k, d)
                * gate_vals[..., None].to(out_flat.dtype)).sum(dim=1)
    return combined.reshape(b, s, d), aux.to(x.dtype)
