"""Decoder-only language model assembled from ``LayerSpec``s, for serving.

Port of ``repro.models.lm`` for the ``attn`` and ``rglru`` mixers with the
dense FFN (recurrentgemma-9b, gemma2-2b, qwen2-7b, command-r-35b,
minitron-8b).  Any other mixer, the MoE FFN, the encoder-decoder and the
frontend-prefixed VLM raise ``NotImplementedError``; so do the training
loss and its chunked cross-entropy (see ROADMAP.md).

API (params are nested dicts and lists of tensors, leaf for leaf the
reference's, so ``repro_torch.weights`` carries them across):
  init_params(cfg, gen, dtype)
  forward(params, cfg, tokens)                 # full-seq logits
  init_cache(cfg, batch, max_len, ...)         # decode state
  prefill(params, cfg, tokens, cache)          # build cache, last logits
  decode_step(params, cfg, token, pos, cache)  # one token
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (FFN_DENSE, FFN_NONE, MIX_ATTN,
                                      MIX_RGLRU, LayerSpec, ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.common import (dense_init, embed_init, rmsnorm,
                                       softcap)
from repro_torch.tree import leaves


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` runs on
    modules the port has."""
    why = []
    mixers = sorted({s.mixer for s in cfg.layers} - {MIX_ATTN, MIX_RGLRU})
    if mixers:
        why.append(f"mixers {mixers}")
    ffns = sorted({s.ffn for s in cfg.layers} - {FFN_DENSE, FFN_NONE})
    if ffns:
        why.append(f"ffn {ffns}")
    if cfg.encoder is not None:
        why.append("the encoder-decoder stack")
    if cfg.frontend is not None:
        why.append(f"the {cfg.frontend.kind} frontend")
    if why:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(why)}, which the port does not "
            "have yet (see ROADMAP.md)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                dtype):
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    p: Dict[str, Any] = {"ln1": zeros()}
    if spec.mixer == MIX_ATTN:
        p["mixer"] = attn_mod.init_attention_params(gen, cfg, dtype=dtype)
    else:
        p["mixer"] = rec_mod.init_rglru_params(gen, cfg, dtype=dtype)
    if spec.ffn != FFN_NONE:
        p["ln2"] = zeros()
        p["ffn"] = ffn_mod.init_mlp_params(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32):
    """Random params drawn from ``gen`` on ``gen``'s device, in the
    reference's tree shape."""
    check_supported(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "layers": [_init_layer(gen, cfg, spec, dtype) for spec in cfg.layers],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype)
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in leaves(params))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ffn(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor):
    if spec.ffn == FFN_NONE:
        return x
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_mod.mlp(p["ffn"], h2, cfg.act)


def _block(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor):
    """One block over the full sequence."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == MIX_ATTN:
        mix = attn_mod.attention(p["mixer"], cfg, spec, h)
    else:
        mix = rec_mod.rglru_block(p["mixer"], h)
    return _ffn(p, cfg, spec, x + mix)


def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor):
    emb = params["embed"]
    # sqrt(d) rounded in f32, as the reference computes it
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32,
                                    device=emb.device)).to(emb.dtype)
    return emb[tokens.long()] * scale


def _unembed(params, cfg: ModelConfig, x: torch.Tensor):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    return softcap(logits.to(torch.float32), cfg.final_softcap)


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S). Returns logits (B, S, V) in f32."""
    x = _embed_inputs(params, cfg, tokens)
    for p, spec in zip(params["layers"], cfg.layers):
        x = _block(p, cfg, spec, x)
    return _unembed(params, cfg, x)


# ---------------------------------------------------------------------------
# cache / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               decode_window: Optional[int] = None, dtype=torch.float32,
               device=None):
    """decode_window forces a sliding window onto full-attention layers
    (the reference's long-context serving adaptation)."""
    check_supported(cfg)
    layers = []
    for spec in cfg.layers:
        if spec.mixer == MIX_ATTN:
            layers.append(attn_mod.init_kv_cache(
                cfg, spec, batch, max_len, decode_window=decode_window,
                dtype=dtype, device=device))
        else:
            layers.append(rec_mod.init_rglru_state(cfg, batch, dtype,
                                                   device))
    return {"layers": layers}


def _prefill_block(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                   st):
    """One block of the prompt pass; fills this layer's cache or state."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == MIX_ATTN:
        mix, st = attn_mod.prefill_into_cache(p["mixer"], cfg, spec, h, st)
    else:
        mix, h_last, u = rec_mod.rglru_sequence(p["mixer"], h)
        st = rec_mod.RGLRUState(
            h=h_last,
            conv_tail=u[:, -(cfg.conv1d_width - 1):].to(st.conv_tail.dtype))
    return _ffn(p, cfg, spec, x + mix), st


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache):
    """Run the prompt (B, S) through the model, filling the cache.
    Returns (last-position logits (B, V), cache)."""
    x = _embed_inputs(params, cfg, tokens)
    new_layers = []
    for p, spec, st in zip(params["layers"], cfg.layers, cache["layers"]):
        x, st = _prefill_block(p, cfg, spec, x, st)
        new_layers.append(st)
    logits = _unembed(params, cfg, x[:, -1:])
    return logits[:, 0], dict(cache, layers=new_layers)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos: int,
                cache):
    """token: (B,) ints; pos: the global position of this token.
    Returns (logits (B, V), new cache).  Attention caches are updated in
    place (see ``attention.decode_attention``)."""
    x = _embed_inputs(params, cfg, token)[:, None]              # (B,1,d)
    new_layers = []
    for p, spec, st in zip(params["layers"], cfg.layers, cache["layers"]):
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        if spec.mixer == MIX_ATTN:
            mix, st = attn_mod.decode_attention(p["mixer"], cfg, spec, h,
                                                int(pos), st)
        else:
            mix, st = rec_mod.rglru_decode_step(p["mixer"], h, st)
        x = _ffn(p, cfg, spec, x + mix)
        new_layers.append(st)
    logits = _unembed(params, cfg, x)
    return logits[:, 0], dict(cache, layers=new_layers)
