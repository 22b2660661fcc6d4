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

``moe_impl("dense")`` switches ``moe_ffn`` to the dense path for the
enclosed calls (a context variable, so concurrent callers do not see each
other's choice).  The reference's sharded "hierarchical" impl raises (see
ROADMAP.md, item 15b).

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

CAPACITY_FACTOR = 1.25
# the profiler range around the expert products (``launch/profile_serve``)
EXPERT_RANGE = "moe_expert_products"

_MOE_IMPL = contextvars.ContextVar("moe_impl", default="dispatch")


def current_moe_impl() -> str:
    """The impl ``moe_ffn`` takes here ("dispatch" unless inside
    ``moe_impl``)."""
    return _MOE_IMPL.get()


@contextlib.contextmanager
def moe_impl(kind: str):
    """Run ``moe_ffn`` as ``"dispatch"`` or ``"dense"`` inside the block."""
    if kind == "hierarchical":
        raise NotImplementedError(
            "the hierarchical MoE is the sharded variant: it comes with the "
            "LM half of the multi-GPU slice (see ROADMAP.md, item 15b)")
    if kind not in ("dispatch", "dense"):
        raise ValueError(f"unknown MoE impl {kind!r}")
    token = _MOE_IMPL.set(kind)
    try:
        yield
    finally:
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


def _route(params, xf: torch.Tensor, moe: MoEConfig):
    """xf: (T, d) -> gates (T, k) renormalised, expert ids (T, k), the
    Switch load-balance loss over the top-1 assignment."""
    e, k = moe.n_experts, moe.top_k
    logits = xf.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                         # (T, E)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = top.values[:, :k], top.indices[:, :k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    frac_tokens = F.one_hot(expert_ids[:, 0], e).to(torch.float32).mean(0)
    frac_probs = probs.mean(0)
    aux = moe.aux_loss_coef * e * torch.sum(frac_tokens * frac_probs)
    return gate_vals, expert_ids, aux


def moe_ffn(params, x: torch.Tensor, moe: MoEConfig, act_name: str = "silu",
            capacity_factor: float = CAPACITY_FACTOR
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux loss), by the impl ``moe_impl`` chose."""
    if _MOE_IMPL.get() == "dense":
        return moe_ffn_dense(params, x, moe, act_name)
    return moe_ffn_dispatch(params, x, moe, act_name, capacity_factor)


def moe_ffn_dense(params, x: torch.Tensor, moe: MoEConfig,
                  act_name: str = "silu"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked dense-expert MoE: every expert sees every token; the top-k
    combine weights zero the rest.  Numerically capacity-infinite top-k."""
    b, s, d = x.shape
    e = moe.n_experts
    t = b * s
    xf = x.reshape(t, d)
    gate_vals, expert_ids, aux = _route(params, xf, moe)
    combine = (F.one_hot(expert_ids, e).to(torch.float32)
               * gate_vals[..., None]).sum(dim=1)                 # (T, E)
    act = activation(act_name)
    with record_function(EXPERT_RANGE):
        h = act(torch.matmul(xf, params["we_gate"]))              # (E, T, f)
        h = h * torch.matmul(xf, params["we_up"])
        y_e = torch.matmul(h, params["we_down"])                  # (E, T, d)
    y = torch.einsum("etd,te->td", y_e, combine.to(y_e.dtype))
    return y.reshape(b, s, d), aux.to(x.dtype)


def moe_ffn_dispatch(params, x: torch.Tensor, moe: MoEConfig,
                     act_name: str = "silu",
                     capacity_factor: float = CAPACITY_FACTOR
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux loss), overflowing tokens dropped."""
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
