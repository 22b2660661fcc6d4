"""The federated LM training step (port of ``repro.launch.steps``' train
half).

  fl_train_step: one FL round.  Each participant slot's sequences carry
    their FedAvg weight n_k / n inside the loss (``batch["weight"]``), so
    the gradient of the weighted loss IS the FedAvg aggregate.
    ``local_passes`` = E re-passes the SAME round batch E times and
    accumulates the gradients (E x compute, the upload unchanged), then SGD
    with momentum applies the mean.  ``microbatches`` splits the round batch
    to bound activation memory (flops unchanged).

The reference's step runs on a device mesh and lowers under GSPMD; this one
runs on the one device that holds the params (the ``("data", "model")``
mesh is ROADMAP.md item 15b).  It keeps the reference's arguments.  Two
departures of form:

  * the reference donates params and momentum (``donate_argnums``); here
    ``step`` updates both trees in place under ``no_grad`` after the
    backward passes (their graph is freed by then) and returns them;
  * gradients accumulate in the params' ``.grad`` across microbatches and
    passes (the reference carries a zero-initialised sum), in the same
    order, so the sums are the same.

f32 only: the kernels take f32 (bf16 is ROADMAP.md queue 2).  The
prefill and serve steps and the quantised serve step wait for item 15b.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels.ref import RECIP_127
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import stacked as stacked_mod
from repro_torch.models.common import MetaGenerator
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


def param_struct(cfg: ModelConfig, dtype=torch.float32, *,
                 stacked: bool = False):
    """The params' tree as tensors on the ``meta`` device: shapes and
    dtypes, nothing allocated."""
    init = stacked_mod.init_params_stacked if stacked else lm_mod.init_params
    return init(cfg, MetaGenerator(), dtype)


def _frontend_struct(cfg: ModelConfig, batch: int, dtype):
    f = cfg.frontend
    return torch.empty((batch, f.seq_len, f.feature_dim), dtype=dtype,
                       device="meta")


def _check_dtype(dtype):
    if dtype != torch.float32:
        raise ValueError(
            f"the port trains in float32 only, got {dtype}: the kernels take "
            "f32 (bf16 kernels are ROADMAP.md queue 2)")


def make_fl_train_step(cfg: ModelConfig, shape: InputShape, *,
                       lr: float = DEFAULT_LR,
                       momentum: float = DEFAULT_MOMENTUM,
                       local_passes: int = 1, microbatches: int = 1,
                       remat: bool = True, dtype=torch.float32,
                       quantize_comm: bool = False,
                       moe_mode: str = "dense"):
    """One FL round over layer-stacked params.  Returns ``(step,
    (p_struct, m_struct, batch_struct))``, the structs on the ``meta``
    device.

    ``step(params, momentum_state, batch) -> (params, momentum_state,
    loss, metrics)``: batch is {tokens (B, S), labels (B, S), weight (B,),
    frontend?}; params and momentum are updated in place and returned;
    loss and metrics are those of the first pass (averaged over
    microbatches)."""
    _check_dtype(dtype)
    if moe_mode == "hierarchical":
        raise NotImplementedError(
            "moe_mode='hierarchical' is the sharded MoE: it comes with the "
            "LM half of the multi-GPU slice (ROADMAP.md item 15b)")
    if moe_mode not in ("dense", "dispatch"):
        raise ValueError(f"unknown moe_mode {moe_mode!r}")
    b, s = shape.global_batch, shape.seq_len
    if b % microbatches:
        raise ValueError(f"batch {b} is not a multiple of microbatches="
                         f"{microbatches}")
    mb_size = b // microbatches

    def loss(params, batch):
        if quantize_comm:   # the int8 upload, straight-through
            params = tree_map(_quantize_dequantize_ste, params)
        with ffn_mod.moe_impl(moe_mode):
            return stacked_mod.loss_fn(params, cfg, batch, remat=remat)

    def fl_train_step(params, momentum_state, batch: Dict[str, Any]):
        ps = leaves(params)
        for p in ps:
            p.grad = None
            p.requires_grad_(True)
        micro = [batch] if microbatches == 1 else [
            {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
            for i in range(microbatches)]
        losses, metricss = [], []
        try:
            for e in range(local_passes):
                for mb in micro:
                    l, metrics = loss(params, mb)
                    l.backward()
                    if e == 0:
                        losses.append(l.detach())
                        metricss.append({k: v.detach()
                                         for k, v in metrics.items()})
        finally:
            for p in ps:
                p.requires_grad_(False)
        if microbatches == 1:
            l, metrics = losses[0], metricss[0]
        else:
            l = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricss]).mean()
                       for k in metricss[0]}
        n = microbatches * local_passes
        with torch.no_grad():
            for p, m in zip(ps, leaves(momentum_state)):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = None
                g.div_(n)
                m.mul_(momentum).add_(g.to(m.dtype))
                p.sub_(lr * m.to(p.dtype))
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


def step_for_shape(cfg: ModelConfig, shape: InputShape, **kw):
    """Dispatch on the shape kind -> (step, example structs).  Only the
    train step is ported; prefill and decode steps raise (item 15b)."""
    if shape.kind == "train":
        return make_fl_train_step(cfg, shape, **kw)
    if shape.kind in ("prefill", "decode"):
        raise NotImplementedError(
            f"the {shape.kind} step runs on the device mesh: it comes with "
            "the LM half of the multi-GPU slice (ROADMAP.md item 15b)")
    raise ValueError(shape.kind)
