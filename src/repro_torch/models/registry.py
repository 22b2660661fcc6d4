"""Uniform model handles (counterpart of ``repro.models.registry``).

``build_model(cfg)`` returns a ``Model`` whose functional API the FL
substrate and the launchers use: the paper's MLP, and every LM config for
serving and training (``loss_fn`` is ``lm.loss_fn``; the layer-stacked
training step is ``launch.steps``).  ResNet raises
``NotImplementedError`` until its slice lands.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_models import MLPConfig, ResNetConfig
from repro_torch.models import lm as lm_mod
from repro_torch.models import mlp as mlp_mod


@dataclass(frozen=True)
class Model:
    config: Any
    init: Callable[..., Any]        # (seed, device, dtype) -> params
    loss_fn: Optional[Callable[..., Any]] = None  # (params, batch) -> (loss, metrics)
    forward: Optional[Callable[..., Any]] = None
    init_cache: Optional[Callable[..., Any]] = None
    prefill: Optional[Callable[..., Any]] = None
    decode_step: Optional[Callable[..., Any]] = None
    flops_per_example: Optional[float] = None   # analytic fwd FLOPs


def _classifier_loss(forward):
    def loss_fn(params, cfg, batch):
        logits = forward(params, cfg, batch["x"])
        labels = batch["y"].long()
        logp = F.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
        # optional per-example mask (for padded client batches)
        mask = batch.get("mask")
        if mask is None:
            loss = nll.mean()
            acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        else:
            mask = mask.to(torch.bool)
            denom = torch.clamp_min(mask.sum(), 1).to(torch.float32)
            loss = torch.where(mask, nll, torch.zeros_like(nll)).sum() / denom
            hit = (logits.argmax(-1) == labels) & mask
            acc = hit.sum().to(torch.float32) / denom
        return loss, {"ce": loss, "acc": acc}
    return loss_fn


def _lm_model(cfg: ModelConfig) -> Model:
    """Handle of an LM config: ``loss_fn(params, batch, remat=False) ->
    (loss, metrics)`` (next-token CE weighted per sequence, plus the MoE
    aux loss) and the serving functions.  ``forward`` and ``prefill`` take
    the frontend input (audio frames or vision patches) as ``frontend=``,
    ``loss_fn`` as ``batch["frontend"]``."""

    def init(seed: int, device, dtype=torch.float32):
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(int(seed))
        return lm_mod.init_params(cfg, gen, dtype)

    def init_cache(batch: int, max_len: int, *, device, **kw):
        return lm_mod.init_cache(cfg, batch, max_len,
                                 device=torch.device(device), **kw)

    return Model(
        config=cfg,
        init=init,
        loss_fn=lambda params, batch, **kw: lm_mod.loss_fn(params, cfg, batch,
                                                          **kw),
        forward=lambda params, tokens, frontend=None: lm_mod.forward(
            params, cfg, tokens, frontend=frontend),
        init_cache=init_cache,
        prefill=lambda params, tokens, cache, frontend=None: lm_mod.prefill(
            params, cfg, tokens, cache, frontend=frontend),
        decode_step=lambda params, token, pos, cache: lm_mod.decode_step(
            params, cfg, token, pos, cache),
    )


def build_model(cfg) -> Model:
    if isinstance(cfg, ModelConfig):
        return _lm_model(cfg)
    if isinstance(cfg, MLPConfig):
        fwd = mlp_mod.forward
        loss = _classifier_loss(fwd)

        def init(seed: int, device, dtype=torch.float32):
            gen = torch.Generator().manual_seed(int(seed))
            return mlp_mod.init_params(cfg, gen, torch.device(device), dtype)

        return Model(
            config=cfg,
            init=init,
            loss_fn=lambda params, batch: loss(params, cfg, batch),
            forward=lambda params, x: fwd(params, cfg, x),
            flops_per_example=mlp_mod.flops_per_example(cfg),
        )
    if isinstance(cfg, ResNetConfig):
        raise NotImplementedError(
            "ResNet is not ported yet: it comes with the ResNet slice "
            "(see ROADMAP.md)")
    raise TypeError(f"unknown config type {type(cfg).__name__}")
