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

from repro_torch import obs
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import lm as lm_mod
from repro_torch.models.attention import write_slot
from repro_torch.models.common import rmsnorm, shard_bse
from repro_torch.sharding.ctx import is_dtensor, unshard
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


def _encode_scanned(params_st, cfg: ModelConfig, frames: torch.Tensor, *,
                    remat: bool = True) -> torch.Tensor:
    """The encoder over stacked layers (one checkpoint per layer under
    ``remat``): (B, T, F) -> (B, T, d_enc)."""
    enc = params_st["encoder"]
    x = shard_bse(frames @ params_st["frontend_proj"])   # as lm._encode
    for lp in _unstack(enc["stacked"][0]):
        x = lm_mod.remat_call(lm_mod.enc_layer, lp, cfg, x) if remat \
            else lm_mod.enc_layer(lp, cfg, x)
    return lm_mod._gathered_seq(rmsnorm(x, enc["final_norm"], cfg.norm_eps))


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


def _slices_are_views(x) -> bool:
    """True when ``_unstack``'s slices of the stacked leaf ``x`` are views
    of it (a leaf split along its layer axis is gathered first)."""
    from torch.distributed.tensor import Shard
    return not is_dtensor(x) or not any(
        isinstance(p, Shard) and p.dim == 0 for p in x.placements)


def _into_stack(cache_st, cache, views, cfg: ModelConfig) -> Dict[str, Any]:
    """The stacked cache ``cache_st`` holding the per-layer ``cache`` that
    a step made from its slices ``views`` (``_per_layer_cache``): a leaf
    the step wrote through a view of the stack is in it already; any other
    is copied into its slice of the stack (the encoder's output into its
    own tensor), or, where its dtype changed (an RG-LRU state's f32 h
    after the cache's bf16 zeros), its stacked leaf is stacked anew from
    the layers, as the reference's scan stacks them."""
    p, n_full, _ = find_cycle(cfg)
    out = {}
    for k, v in cache.items():      # the encoder's output
        if k == "layers":
            continue
        mine = cache_st.get(k)
        if mine is not None and mine is not v and mine.dtype == v.dtype:
            mine.copy_(v)
            v = mine
        out[k] = v
    out["rest"] = list(cache["layers"][len(cache["layers"])
                                       - len(cache_st["rest"]):])
    stacked = []
    for pos, tree in enumerate(cache_st["stacked"]):
        st_leaves = leaves(tree)
        made = [leaves(cache["layers"][c * p + pos]) for c in range(n_full)]
        seen = [leaves(views["layers"][c * p + pos]) for c in range(n_full)]
        restacked = {}
        for i, x in enumerate(st_leaves):
            col = [ls[i] for ls in made]
            if any(y.dtype != x.dtype for y in col):
                restacked[i] = torch.stack(col)
                continue
            in_place = _slices_are_views(x)
            new = [c for c, y in enumerate(col)
                   if not (in_place and y is seen[c][i])]
            if len(new) == len(col) and not is_dtensor(x):
                torch.stack(col, out=x)     # every slice: one copy
            else:
                for c in new:
                    _write_layer(x, c, col[c])
        if restacked:
            tree = unflatten_like(tree, [restacked.get(i, x)
                                         for i, x in enumerate(st_leaves)])
        stacked.append(tree)
    out["stacked"] = tuple(stacked)
    return out


def _write_layer(x, c: int, y) -> None:
    """Slice ``c`` of the stacked leaf ``x`` set to ``y``, in place (on a
    mesh by the rank whose shard holds it)."""
    if is_dtensor(x):
        write_slot(x, 0, c, y.unsqueeze(0))
    else:
        x[c].copy_(y)


@torch.no_grad()
def prefill(params_st, cfg: ModelConfig, tokens: torch.Tensor, cache_st, *,
            frontend=None):
    """The prompt pass over stacked params and a stacked cache (the
    cycles' slices run in layer order, as the reference's scan).  Returns
    (last-position logits (B, V), the stacked cache): the cache given,
    its layers written through views of it (``_into_stack``)."""
    views = _per_layer_cache(cache_st, cfg)
    logits, cache = lm_mod.prefill(unstack_params(params_st, cfg), cfg,
                                   tokens, views, frontend=frontend)
    with obs.range(obs.CACHE_WRITE):
        return logits, _into_stack(cache_st, cache, views, cfg)


@torch.no_grad()
def decode_step(params_st, cfg: ModelConfig, token: torch.Tensor, pos: int,
                cache_st):
    """One token over stacked params and a stacked cache (mirrors
    ``lm.decode_step``).  Returns (logits (B, V), the stacked cache given,
    the new entry and each layer's new state written in place, a layer at
    a time)."""
    views = _per_layer_cache(cache_st, cfg)
    logits, cache = lm_mod.decode_step(unstack_params(params_st, cfg), cfg,
                                       token, pos, views, in_place=True)
    with obs.range(obs.CACHE_WRITE):
        return logits, _into_stack(cache_st, cache, views, cfg)
