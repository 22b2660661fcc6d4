"""Layer-stacked execution: the training step's layout of the params.

Port of ``repro.models.stacked``.  The reference stacks the params of a
repeating cycle of layers (RecurrentGemma's rglru/rglru/attn, Gemma-2's
local/global, xLSTM's mlstm/slstm) and runs ``lax.scan`` over the cycles,
so XLA compiles one cycle body; layers past the last full cycle run
unrolled.  PyTorch runs eagerly, so here the scan is a Python loop over the
cycles' slices of the stacked tensors (one ``unbind`` per stacked leaf, so
a leaf's gradient is stacked once rather than scattered cycle by cycle),
with one ``torch.utils.checkpoint`` per cycle under ``remat``, as the
reference's ``jax.checkpoint`` of its scan body.

``stack_params`` / ``unstack_params`` convert between the per-layer list
layout (serving, checkpoints) and the stacked layout (``launch.steps``).
The stacked tree is the reference's leaf for leaf, so
``repro_torch.weights`` carries a stacked JAX tree across.  Prefill and
decode over stacked params and caches are here so that the module is
whole; serving itself runs the per-layer layout.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.common import rmsnorm, shard_bse
from repro_torch.sharding.ctx import unshard
from repro_torch.tree import leaves, tree_stack, unflatten_like


# ---------------------------------------------------------------------------
# cycle detection / (un)stacking
# ---------------------------------------------------------------------------

def find_cycle(cfg: ModelConfig) -> Tuple[int, int, int]:
    """Returns (cycle_len, n_full_cycles, n_rest_layers)."""
    specs = cfg.layers
    n = len(specs)
    for p in range(1, n + 1):
        n_full = n // p
        if n_full < 2:
            break
        if all(specs[i] == specs[i % p] for i in range(n)):
            return p, n_full, n - n_full * p
    return n, 1, 0


def _unstack(tree) -> List[Any]:
    """A stacked tree -> its slices along the leading axis, one tree each
    (views: one ``unbind`` per leaf).  On a mesh a leaf split along its
    layer axis (the reference's cache specs split a stacked ``slot_pos``
    on the batch's axes) is gathered on that axis first."""
    cols = [unshard(x, (0,)).unbind(0) for x in leaves(tree)]
    return [unflatten_like(tree, list(xs)) for xs in zip(*cols)]


def _rest_spec(cfg: ModelConfig, params_st, i: int) -> LayerSpec:
    p, n_full, _ = find_cycle(cfg)
    return cfg.layers[n_full * p + i] if params_st["stacked"] \
        else cfg.layers[i]


def _stack_layers(layers: List[Any], cfg: ModelConfig) -> Dict[str, Any]:
    p, n_full, _ = find_cycle(cfg)
    if n_full >= 2:
        return {"stacked": tuple(
                    tree_stack([layers[c * p + pos] for c in range(n_full)])
                    for pos in range(p)),
                "rest": list(layers[n_full * p:])}
    return {"stacked": (), "rest": list(layers)}


def stack_params(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update(_stack_layers(params["layers"], cfg))
    if cfg.is_encoder_decoder and len(params["encoder"]["layers"]) >= 2:
        enc = dict(params["encoder"])
        enc["stacked"] = (tree_stack(enc.pop("layers")),)
        out["encoder"] = enc
    return out


def _unstack_layers(tree_st, cfg: ModelConfig) -> List[Any]:
    p, n_full, _ = find_cycle(cfg)
    layers = []
    if tree_st["stacked"]:
        per_pos = [_unstack(st) for st in tree_st["stacked"]]
        for c in range(n_full):
            for pos in range(p):
                layers.append(per_pos[pos][c])
    layers.extend(tree_st["rest"])
    return layers


def unstack_params(params_st: Dict[str, Any], cfg: ModelConfig
                   ) -> Dict[str, Any]:
    out = {k: v for k, v in params_st.items()
           if k not in ("stacked", "rest")}
    out["layers"] = _unstack_layers(params_st, cfg)
    if cfg.is_encoder_decoder and "stacked" in params_st.get("encoder", {}):
        enc = dict(params_st["encoder"])
        enc["layers"] = _unstack(enc.pop("stacked")[0])
        out["encoder"] = enc
    return out


def init_params_stacked(cfg: ModelConfig, gen: torch.Generator,
                        dtype=torch.float32):
    return stack_params(lm_mod.init_params(cfg, gen, dtype), cfg)


# ---------------------------------------------------------------------------
# the blocks over stacked params / loss
# ---------------------------------------------------------------------------

def _cycle_body(x, layer_tuple, cfg: ModelConfig, enc_out):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pos, lp in enumerate(layer_tuple):
        x, a = lm_mod._block(lp, cfg, cfg.layers[pos], x, enc_out)
        aux = lm_mod.add_aux(aux, a)
    return x, aux


def _apply_blocks(params_st, cfg: ModelConfig, x: torch.Tensor, *,
                  enc_out=None, remat: bool = True):
    """Every layer over x: the full cycles from the stacked params (one
    checkpoint per cycle under ``remat``), then the rest one by one.
    Returns (x, the MoE aux loss summed in f32)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if params_st["stacked"]:
        per_pos = [_unstack(st) for st in params_st["stacked"]]
        for cycle in zip(*per_pos):
            if remat:
                x, aux = lm_mod.remat_call(_cycle_body, x, cycle, cfg,
                                           enc_out)
            else:
                x, aux = _cycle_body(x, cycle, cfg, enc_out)
            aux_total = aux_total + aux
    for i, lp in enumerate(params_st["rest"]):
        x, a = lm_mod.run_block(lp, cfg, _rest_spec(cfg, params_st, i), x,
                                enc_out, remat)
        aux_total = lm_mod.add_aux(aux_total, a)
    return x, aux_total


def _enc_layer(lp, cfg: ModelConfig, x):
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn_mod.attention(lp["mixer"], cfg, LayerSpec(), h,
                               causal=False)
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + ffn_mod.mlp(lp["ffn"], h2, cfg.act)


def _encode_scanned(params_st, cfg: ModelConfig, frames: torch.Tensor, *,
                    remat: bool = True) -> torch.Tensor:
    """The encoder over stacked layers (one checkpoint per layer under
    ``remat``): (B, T, F) -> (B, T, d_enc)."""
    enc = params_st["encoder"]
    x = frames @ params_st["frontend_proj"]
    for lp in _unstack(enc["stacked"][0]):
        x = lm_mod.remat_call(_enc_layer, lp, cfg, x) if remat \
            else _enc_layer(lp, cfg, x)
    return rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def _encoder_output(params_st, cfg: ModelConfig, frontend, remat: bool):
    if not cfg.is_encoder_decoder:
        return None
    if frontend is None:
        raise ValueError(f"{cfg.name} needs frontend frames for its encoder")
    return _encode_scanned(params_st, cfg, frontend, remat=remat)


def loss_fn(params_st, cfg: ModelConfig, batch, *, remat: bool = True):
    """Same contract as ``lm.loss_fn``, over stacked params."""
    labels = batch["labels"]
    frontend = batch.get("frontend")
    enc_out = _encoder_output(params_st, cfg, frontend, remat)
    x = lm_mod._embed_inputs(params_st, cfg, batch["tokens"], frontend)
    x, aux_total = _apply_blocks(params_st, cfg, x, enc_out=enc_out,
                                 remat=remat)
    x = lm_mod.text_states(shard_bse(x), labels)
    tok_w = lm_mod.token_weights(labels, batch.get("weight"))
    ce, acc = lm_mod.chunked_ce(params_st, cfg, x, labels, tok_w)
    return ce + aux_total, {"ce": ce, "aux": aux_total, "acc": acc}


# ---------------------------------------------------------------------------
# stacked caches: prefill and decode
# ---------------------------------------------------------------------------

def stack_cache(cache: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """A per-layer cache list in the stacked layout."""
    out = {k: v for k, v in cache.items() if k != "layers"}
    out.update(_stack_layers(cache["layers"], cfg))
    return out


def init_cache_stacked(cfg: ModelConfig, batch: int, max_len: int, **kw):
    return stack_cache(lm_mod.init_cache(cfg, batch, max_len, **kw), cfg)


def _per_layer_cache(cache_st, cfg: ModelConfig) -> Dict[str, Any]:
    out = {k: v for k, v in cache_st.items() if k not in ("stacked", "rest")}
    out["layers"] = _unstack_layers(cache_st, cfg)
    return out


@torch.no_grad()
def prefill(params_st, cfg: ModelConfig, tokens: torch.Tensor, cache_st, *,
            frontend=None):
    """The prompt pass over stacked params and a stacked cache (the
    cycles' slices run in layer order, as the reference's scan).  Returns
    (last-position logits (B, V), the new stacked cache)."""
    logits, cache = lm_mod.prefill(unstack_params(params_st, cfg), cfg,
                                   tokens, _per_layer_cache(cache_st, cfg),
                                   frontend=frontend)
    return logits, stack_cache(cache, cfg)


@torch.no_grad()
def decode_step(params_st, cfg: ModelConfig, token: torch.Tensor, pos: int,
                cache_st):
    """One token over stacked params and a stacked cache (mirrors
    ``lm.decode_step``).  Returns (logits (B, V), the new stacked cache)."""
    logits, cache = lm_mod.decode_step(unstack_params(params_st, cfg), cfg,
                                       token, pos,
                                       _per_layer_cache(cache_st, cfg))
    return logits, stack_cache(cache, cfg)
