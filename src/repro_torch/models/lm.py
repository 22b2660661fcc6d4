"""Language models assembled from ``LayerSpec``s: a decoder-only LM, an
encoder-decoder (the audio family) or a VLM whose text follows a prefix of
vision patches.

Port of ``repro.models.lm`` for every mixer (attention, RG-LRU, mLSTM,
sLSTM), the dense FFN and the MoE, the encoder stack over (stub) audio
frames and the (stub) vision-patch prefix: all ten LM configs serve and
train.

API (params are nested dicts and lists of tensors, leaf for leaf the
reference's, so ``repro_torch.weights`` carries them across):
  init_params(cfg, gen, dtype)
  forward(params, cfg, tokens, frontend=)          # full-seq logits
  loss_fn(params, cfg, batch, remat=)              # next-token CE + MoE aux
  chunked_ce(params, cfg, x, labels, tok_w)        # CE over token chunks
  init_cache(cfg, batch, max_len, ...)             # decode state
  prefill(params, cfg, tokens, cache, frontend=)   # build cache, last logits
  decode_step(params, cfg, token, pos, cache)      # one token

``forward``, ``prefill`` and ``decode_step`` run under ``no_grad``
(serving); ``loss_fn`` records autograd, and with ``remat`` each block runs
under ``torch.utils.checkpoint`` (its activations recomputed in the
backward, as the reference's ``jax.checkpoint``).

``frontend`` is (B, frames, features) for the encoder-decoder and (B,
patches, features) for the VLM, whose logits and positions then cover the
prefix as well.  The full-sequence forward runs the MoE as ``moe_ffn``
(capacity dispatch by default); prefill and decode run it drop-free
(``moe_ffn_dense``), as the reference serves it.

On a device mesh (``repro_torch.sharding``) the reference's constraints
place the residual stream (``shard_bse``), the logits and the decoded
token's state.  Where DTensor has no usable rule the collective is stated
(``_gathered_seq``, ``_residual``, ``_embed_tokens``, ``_mesh_ce_sums``):
a block's normed input is gathered over the sequence, a sublayer's output
is placed as the residual stream before the add, each rank looks up its
own tokens in its own range of the vocabulary, the rows summed over
``model`` (``_SplitVocabLookup``), and the CE runs on each rank's own
tokens with the vocabulary kept split, its three reductions over the
vocabulary made from each shard's pieces (``_SplitVocabNLL``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.configs.base import (FFN_DENSE, FFN_NONE, MIX_ATTN,
                                      MIX_MLSTM, MIX_RGLRU, MIX_SLSTM,
                                      LayerSpec, ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (dense_init, embed_init, rmsnorm,
                                       shard_bse, softcap)
from repro_torch.sharding.ctx import (activation_rules, current_mesh,
                                      current_rules, is_dtensor,
                                      logical_constraint, unshard,
                                      unshard_for_local)
from repro_torch.tree import leaves

_MIXER_INIT = {
    MIX_ATTN: lambda gen, cfg, dtype: attn_mod.init_attention_params(
        gen, cfg, dtype=dtype),
    MIX_RGLRU: rec_mod.init_rglru_params,
    MIX_MLSTM: xlstm_mod.init_mlstm_params,
    MIX_SLSTM: xlstm_mod.init_slstm_params,
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                dtype):
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    p: Dict[str, Any] = {"ln1": zeros(),
                         "mixer": _MIXER_INIT[spec.mixer](gen, cfg, dtype)}
    if spec.ffn != FFN_NONE:
        p["ln2"] = zeros()
        if spec.ffn == FFN_DENSE:
            p["ffn"] = ffn_mod.init_mlp_params(gen, cfg.d_model, cfg.d_ff,
                                               dtype)
        else:
            p["ffn"] = ffn_mod.init_moe_params(gen, cfg.d_model, cfg.moe,
                                               dtype)
    if cfg.is_encoder_decoder:
        p["ln_cross"] = zeros()
        p["cross"] = attn_mod.init_attention_params(gen, cfg, bias=False,
                                                    dtype=dtype)
    return p


def _init_encoder(gen: torch.Generator, cfg: ModelConfig, dtype):
    e = cfg.encoder
    zeros = lambda: torch.zeros((e.d_model,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    layers = [{
        "ln1": zeros(),
        "mixer": attn_mod.init_attention_params(
            gen, cfg, d_in=e.d_model, n_heads=e.n_heads, n_kv=e.n_kv_heads,
            head_dim=e.head_dim, bias=False, dtype=dtype),
        "ln2": zeros(),
        "ffn": ffn_mod.init_mlp_params(gen, e.d_model, e.d_ff, dtype),
    } for _ in range(e.n_layers)]
    return {"layers": layers, "final_norm": zeros()}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32):
    """Random params drawn from ``gen`` on ``gen``'s device, in the
    reference's tree shape."""
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "layers": [_init_layer(gen, cfg, spec, dtype) for spec in cfg.layers],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype)
    if cfg.frontend is not None:
        params["frontend_proj"] = dense_init(
            gen, (cfg.frontend.feature_dim, cfg.d_model), dtype)
    if cfg.is_encoder_decoder:
        params["encoder"] = _init_encoder(gen, cfg, dtype)
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in leaves(params))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y``.  On a mesh ``y`` is first placed as the residual stream
    ``x`` is, by an explicit redistribution, so that its gradient goes back
    to ``y``'s own placement before the products that made it."""
    if is_dtensor(y) and tuple(y.placements) != tuple(x.placements):
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def _gathered_seq(h: torch.Tensor) -> torch.Tensor:
    """A block's normed input with its sequence whole on every rank (the
    all-gather of sequence parallelism, before the products that flatten
    batch and sequence); a plain tensor as it is."""
    return unshard(h, (1,))


def _ffn(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor, *,
         serving: bool):
    """The FFN's residual step and the MoE's aux loss (None for a dense
    FFN or none); the MoE drop-free when ``serving``."""
    if spec.ffn == FFN_NONE:
        return x, None
    h2 = _gathered_seq(rmsnorm(x, p["ln2"], cfg.norm_eps))
    if spec.ffn == FFN_DENSE:
        return _residual(x, ffn_mod.mlp(p["ffn"], h2, cfg.act)), None
    moe = ffn_mod.moe_ffn_dense if serving else ffn_mod.moe_ffn
    out, aux = moe(p["ffn"], h2, cfg.moe, cfg.act)
    return _residual(x, out), aux


def _cross(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
           enc_out: Optional[torch.Tensor]):
    """The decoder's cross-attention residual step (none without an
    encoder)."""
    if enc_out is None:
        return x
    hc = _gathered_seq(rmsnorm(x, p["ln_cross"], cfg.norm_eps))
    return _residual(x, attn_mod.attention(
        p["cross"], cfg, spec, hc, causal=False, kv_input=enc_out,
        rope=False))


def _block(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
           enc_out: Optional[torch.Tensor] = None):
    """One block over the full sequence: (x, the MoE's aux loss or None)."""
    h = _gathered_seq(rmsnorm(x, p["ln1"], cfg.norm_eps))
    if spec.mixer == MIX_ATTN:
        mix = attn_mod.attention(p["mixer"], cfg, spec, h)
    elif spec.mixer == MIX_RGLRU:
        mix = rec_mod.rglru_block(p["mixer"], h)
    elif spec.mixer == MIX_MLSTM:
        mix = xlstm_mod.mlstm_block(p["mixer"], h, cfg)
    else:
        mix = xlstm_mod.slstm_block(p["mixer"], h, cfg)
    x = _cross(p, cfg, spec, _residual(x, mix), enc_out)
    x, aux = _ffn(p, cfg, spec, x, serving=False)
    return shard_bse(x), aux


def _encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over (stub) frontend frames: (B, T, F) -> (B, T, d_enc).
    Non-causal self-attention with rope over positions ``arange(T)``."""
    # on a mesh the stream is placed as the decoder's and gathered as its
    # before each product: a sum left pending may be scattered over a dim
    # the mesh does not divide
    x = shard_bse(frames @ params["frontend_proj"])
    for lp in params["encoder"]["layers"]:
        x = enc_layer(lp, cfg, x)
    return _gathered_seq(rmsnorm(x, params["encoder"]["final_norm"],
                                 cfg.norm_eps))


def enc_layer(lp, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """One encoder layer: non-causal self-attention and the MLP, each a
    residual step as the decoder's."""
    h = _gathered_seq(rmsnorm(x, lp["ln1"], cfg.norm_eps))
    x = _residual(x, attn_mod.attention(lp["mixer"], cfg, LayerSpec(), h,
                                        causal=False))
    h2 = _gathered_seq(rmsnorm(x, lp["ln2"], cfg.norm_eps))
    return _residual(x, ffn_mod.mlp(lp["ffn"], h2, cfg.act))


class _SplitVocabLookup(torch.autograd.Function):
    """``table[tokens]`` where this rank looks up rows [v0, v0 + hi - lo)
    of the vocabulary, its local table's rows [lo, hi): each token outside
    them gives a row of zeros, and the rows are summed over ``group``,
    whose ranks hold the rest of the vocabulary.  Exactly one term of each
    sum is nonzero, so the sum is the row itself, bit for bit.  The table's
    d is first gathered over each ``gathers`` entry (group, ranks, rank,
    tokens split there), the innermost mesh dim first; its gradient goes
    back to the local shard: each rank scatter-adds its own tokens' row
    gradients into its own rows only, then a reduce-scatter over each
    gather's group (a plain slice where the tokens are the same on every
    rank of it), so no collective carries more than the rank's rows of the
    table with d whole."""

    @staticmethod
    def forward(ctx, table, tokens, lo: int, hi: int, v0: int, gathers,
                group):
        rows = table[lo:hi]
        for g, _, _, _ in reversed(gathers):
            rows = _collective("all_gather", rows, 1, g)
        n = hi - lo
        idx = tokens.long() - v0
        local = (idx >= 0) & (idx < n)
        idx = torch.clamp(idx, 0, max(n - 1, 0))
        picked = rows[idx] if n else rows.new_zeros(idx.shape
                                                     + rows.shape[1:])
        out = torch.where(local[..., None], picked,
                          torch.zeros((), dtype=rows.dtype,
                                      device=rows.device))
        if group is not None:
            out = _all_reduce(out, "sum", group)
        ctx.save_for_backward(idx, local)
        ctx.lo, ctx.hi, ctx.d, ctx.gathers = lo, hi, rows.shape[1], gathers
        ctx.table_shape = table.shape
        return out

    @staticmethod
    def backward(ctx, g):
        idx, local = ctx.saved_tensors
        grad = torch.zeros((ctx.hi - ctx.lo, ctx.d), dtype=g.dtype,
                           device=g.device)
        if ctx.hi > ctx.lo:
            grad.index_put_((idx,), torch.where(local[..., None], g,
                                                torch.zeros_like(g)),
                            accumulate=True)
        for grp, n, r, split in ctx.gathers:
            grad = _collective("reduce_scatter", grad, "sum", 1, grp) \
                if split else grad.chunk(n, 1)[r]
        if grad.shape[0] != ctx.table_shape[0]:
            full = grad.new_zeros(ctx.table_shape)
            full[ctx.lo:ctx.hi] = grad
            grad = full
        return grad, None, None, None, None, None, None


def _mesh_lookup(emb, tokens):
    """``emb[tokens]`` on a mesh, each rank on its own tokens (``local_map``)
    with the table left split on the vocabulary over ``model``
    (``_SplitVocabLookup``): over the other axes the rank's rows are
    gathered on d only, as FSDP gathers every weight.  Where the
    vocabulary is whole on ``model`` (``fit_spec`` drops an axis that does
    not divide it), each ``model`` rank looks up its own range of the rows
    all the same.  So no rank holds the whole table or a whole gradient of
    it (ROADMAP departure 14).  The rows come back split as the tokens
    are, whole on ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = tokens.device_mesh
    names = tuple(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    n_model = 1 if mi is None else mesh.size(mi)
    t = unshard_for_local(tokens, range(1, tokens.dim()))
    rows = [p if isinstance(p, Shard) and i != mi else Replicate()
            for i, p in enumerate(t.placements)]
    e_pl = list(emb.placements)
    vocab, local_rows = emb.shape[0], emb.to_local().shape[0]
    split = n_model > 1 and e_pl[mi] == Shard(0)
    if split:
        lo, hi, v0 = 0, local_rows, mesh.get_local_rank(mi) * local_rows
    else:
        per = -(-vocab // n_model)
        lo = v0 = min(mesh.get_local_rank(mi) * per, vocab) if mi is not None \
            else 0
        hi = min(lo + per, vocab)
    gathers = [(mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i),
                isinstance(rows[i], Shard))
               for i, p in enumerate(e_pl) if p == Shard(1)]
    group = mesh.get_group(mi) if n_model > 1 else None
    grad = [p if isinstance(p, Shard)
            else Partial() if i == mi and n_model > 1
            or isinstance(rows[i], Shard) else Replicate()
            for i, p in enumerate(e_pl)]
    return local_map(
        lambda e, tl: _SplitVocabLookup.apply(e, tl, lo, hi, v0, gathers,
                                              group),
        out_placements=(rows,), in_placements=(e_pl, rows),
        in_grad_placements=(grad, rows),
        device_mesh=mesh)(emb, t.redistribute(mesh, rows))


@obs.ranged(obs.EMBED)
def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor):
    emb = params["embed"]
    # sqrt(d) rounded in f32, as the reference computes it
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32,
                                    device=emb.device)).to(emb.dtype)
    if is_dtensor(tokens):
        return _mesh_lookup(emb, tokens) * scale
    return emb[tokens.long()] * scale


def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                  frontend: Optional[torch.Tensor] = None):
    """Token embeddings (scaled by sqrt(d)), after the VLM's projected
    patch embeddings (not scaled) where the config has that prefix."""
    x = _embed_tokens(params, cfg, tokens)
    if cfg.frontend is not None and cfg.frontend.kind == "vision_patches":
        if frontend is None:
            raise ValueError(f"{cfg.name} needs frontend patch embeddings")
        fx = frontend @ params["frontend_proj"]
        x = torch.cat([fx.to(x.dtype), x], dim=1)
    return shard_bse(x)


def _encoder_output(params, cfg: ModelConfig,
                    frontend: Optional[torch.Tensor]):
    if not cfg.is_encoder_decoder:
        return None
    if frontend is None:
        raise ValueError(f"{cfg.name} needs frontend frames for its encoder")
    return _encode(params, cfg, frontend)


@obs.ranged(obs.UNEMBED)
def _unembed(params, cfg: ModelConfig, x: torch.Tensor):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    return logical_constraint(logits, ("batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: (B, S_text).  Returns logits (B, S_total, V) in f32, S_total
    counting a vision prefix."""
    enc_out = _encoder_output(params, cfg, frontend)
    x = _embed_inputs(params, cfg, tokens, frontend)
    for p, spec in zip(params["layers"], cfg.layers):
        x = _block(p, cfg, spec, x, enc_out)[0]
    return _unembed(params, cfg, x)


@contextlib.contextmanager
def _replay(impl: str, rows: int, mesh, rules):
    with ffn_mod.moe_impl(impl, rows):
        if mesh is None:
            yield
        else:
            with activation_rules(mesh, rules):
                yield


def remat_call(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward, which may run outside the caller's
    ``moe_impl`` and ``activation_rules`` blocks, so the recompute
    re-enters the forward's."""
    impl, rows = ffn_mod.current_moe_impl()
    mesh, rules = current_mesh(), current_rules()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _replay(impl, rows, mesh, rules)))


def run_block(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
              enc_out: Optional[torch.Tensor], remat: bool):
    """``_block`` for training, recomputed in the backward when
    ``remat``."""
    if not remat:
        return _block(p, cfg, spec, x, enc_out)
    return remat_call(_block, p, cfg, spec, x, enc_out)


def add_aux(total: torch.Tensor, aux: Optional[torch.Tensor]):
    """The running MoE aux loss in f32 (a block without a MoE adds 0)."""
    return total if aux is None else total + aux.to(torch.float32)


def token_weights(labels: torch.Tensor, weight: Optional[torch.Tensor]):
    """(B, S) f32: 1 where the label counts (>= 0), times the sequence's
    weight (B,) where given: FedAvg's n_k / n enters the round objective
    here, so the gradient's reduction IS the weighted aggregation."""
    tok_w = (labels >= 0).to(torch.float32)
    if weight is not None:
        tok_w = tok_w * weight[:, None].to(torch.float32)
    return tok_w


def text_states(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The hidden states of the text: a VLM's prefix is cut so that they
    line up with the labels."""
    if x.shape[1] != labels.shape[1]:
        x = x[:, x.shape[1] - labels.shape[1]:]
    return x


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = False):
    """batch: {"tokens": (B, S), "labels": (B, S) with -1 = ignored,
    optional "weight" (B,) and "frontend"}.  Returns (loss, metrics):
    the weighted next-token CE plus the MoE aux loss, and {"ce", "aux",
    "acc"}."""
    tokens, labels = batch["tokens"], batch["labels"]
    frontend = batch.get("frontend")
    enc_out = _encoder_output(params, cfg, frontend)
    x = _embed_inputs(params, cfg, tokens, frontend)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, spec in zip(params["layers"], cfg.layers):
        x, aux = run_block(p, cfg, spec, x, enc_out, remat)
        aux_total = add_aux(aux_total, aux)
    x = text_states(x, labels)
    tok_w = token_weights(labels, batch.get("weight"))
    ce, acc = chunked_ce(params, cfg, x, labels, tok_w)
    return ce + aux_total, {"ce": ce, "aux": aux_total, "acc": acc}


def _chunk_stats(xc, head, lc, wc, mc, final_cap):
    """One chunk's (sum of w * nll, correct, sum of w, counted)."""
    logits = softcap((xc @ head).to(torch.float32), final_cap)
    logz = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp_min(lc, 0).long()
    tgt = torch.gather(logits, 1, safe[:, None])[:, 0]
    nll = logz - tgt
    correct = mc & (logits.argmax(-1) == safe)
    return (nll * wc).sum(), correct.sum(), wc.sum(), mc.sum()


def _waited(out) -> torch.Tensor:
    """A functional collective's result, waited for."""
    import torch.distributed._functional_collectives as funcol
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def _collective(kind: str, *args) -> torch.Tensor:
    """``funcol``'s ``{kind}_single`` (``{kind}_tensor`` on a torch that
    has no such name), waited for."""
    import torch.distributed._functional_collectives as funcol
    fn = getattr(funcol, f"{kind}_single", None) or \
        getattr(funcol, f"{kind}_tensor")
    return _waited(fn(*args))


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    return _waited(funcol.all_reduce(t, op, group))


class _SplitVocabNLL(torch.autograd.Function):
    """Per row, ``logsumexp(logits) - logits[label]`` and the argmax, of
    logits whose vocabulary is split over ``group``: this rank holds
    columns [v0, v0 + n).  The three reductions over the vocabulary are
    made from each shard's pieces, with collectives of (rows,) vectors:
    the max and each shard's sum of exp, the target logit from the shard
    that holds it, the argmax as (max, lowest global index), so a tie
    goes to the lowest id, as ``argmax`` gives.  The backward is this
    shard's own: softmax minus the label's one-hot, no collective."""

    @staticmethod
    def forward(ctx, logits, safe, v0: int, group):
        n = logits.shape[1]
        m_loc = logits.amax(1)
        i_loc = logits.argmax(1)
        m = _all_reduce(m_loc, "max", group)
        shift = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        local = (safe >= v0) & (safe < v0 + n)
        idx = torch.clamp(safe - v0, 0, n - 1)
        tgt = torch.where(local, torch.gather(logits, 1, idx[:, None])[:, 0],
                          torch.zeros_like(m))
        sums = _all_reduce(torch.stack(
            [torch.exp(logits - shift[:, None]).sum(1), tgt]), "sum", group)
        logz = torch.log(sums[0]) + shift
        pred = _all_reduce(torch.where(
            m_loc == m, i_loc + v0,
            torch.full_like(i_loc, torch.iinfo(torch.int64).max)),
            "min", group)
        ctx.save_for_backward(logits, logz, idx, local)
        ctx.mark_non_differentiable(pred)
        return logz - sums[1], pred

    @staticmethod
    def backward(ctx, g, _):
        logits, logz, idx, local = ctx.saved_tensors
        grad = torch.exp(logits - logz[:, None]) * g[:, None]
        grad.scatter_add_(1, idx[:, None],
                          torch.where(local, -g, torch.zeros_like(g))[:, None])
        return grad, None, None, None


def _split_chunk_stats(xc, head, lc, wc, mc, final_cap, v0, group):
    """``_chunk_stats`` of a chunk whose head holds this rank's columns
    [v0, v0 + n) of the vocabulary: its logits stay split."""
    logits = softcap((xc @ head).to(torch.float32), final_cap)
    safe = torch.clamp_min(lc, 0).long()
    nll, pred = _SplitVocabNLL.apply(logits, safe, v0, group)
    correct = mc & (pred == safe)
    return (nll * wc).sum(), correct.sum(), wc.sum(), mc.sum()


def _ce_sums(xf, head, lf, wf, mf, final_cap, chunk_tokens, stats=None):
    """Flattened tokens' (sum of w * nll, correct, sum of w, counted):
    chunks of ``chunk_tokens`` (the last padded with zero-weight tokens,
    as the reference pads), each recomputed in the backward.  ``stats``
    is a chunk's function of (xc, head, lc, wc, mc, final_cap)."""
    t, d = xf.shape
    dev = xf.device
    nll_s = torch.zeros((), dtype=torch.float32, device=dev)
    w_s = torch.zeros((), dtype=torch.float32, device=dev)
    cor_s = torch.zeros((), dtype=torch.int64, device=dev)
    m_s = torch.zeros((), dtype=torch.int64, device=dev)
    if t == 0:
        return nll_s, cor_s, w_s, m_s
    chunk = min(chunk_tokens, t)
    pad = (-t) % chunk
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, d))])
        lf = torch.cat([lf, lf.new_zeros((pad,))])
        wf = torch.cat([wf, wf.new_zeros((pad,))])
        mf = torch.cat([mf, mf.new_zeros((pad,))])
    for c0 in range(0, t + pad, chunk):
        sl = slice(c0, c0 + chunk)
        nll, cor, w, m = checkpoint(stats or _chunk_stats, xf[sl], head,
                                    lf[sl], wf[sl], mf[sl], final_cap,
                                    use_reentrant=False)
        nll_s, cor_s, w_s, m_s = nll_s + nll, cor_s + cor, w_s + w, m_s + m
    return nll_s, cor_s, w_s, m_s


def _mesh_ce_sums(x, head, labels, tok_w, final_cap, chunk_tokens):
    """``_ce_sums`` on a mesh, each rank on its own tokens (``local_map``):
    the chunks are cut from the rank's local rows (its batch shard), so no
    op slices a split dim.  Where the head's vocabulary is split over
    ``model`` the chunk's logits stay split (``_SplitVocabNLL``); where it
    is whole and ``model`` has more than one rank, the ``model`` ranks
    split the local rows, so no two compute the same logits, and the
    chunk (``chunk_tokens`` over the ``model`` ranks).  Returns
    the sums as (nll, w) f32 and (correct, counted) int64, each reduced
    once over the mesh."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    n_model = 1 if mi is None else mesh.size(mi)
    x = unshard_for_local(x, (1, 2))
    rows = [p if isinstance(p, Shard) and i != mi else Replicate()
            for i, p in enumerate(x.placements)]
    split = n_model > 1 and head.placements[mi] == Shard(1)
    head_pl = [head.placements[mi] if i == mi and split else Replicate()
               for i in range(mesh.ndim)]

    def part(i):    # a sum's or a gradient's placement on mesh dim i
        if i == mi:
            return Replicate() if n_model == 1 else Partial()
        return Partial() if isinstance(rows[i], Shard) else Replicate()

    x_grad = [part(i) if i == mi else rows[i] for i in range(mesh.ndim)]
    head_grad = [head_pl[i] if i == mi and split else part(i)
                 for i in range(mesh.ndim)]
    sums_pl = [Replicate() if i == mi and split else part(i)
               for i in range(mesh.ndim)]

    def local(xl, hl, ll, wl):
        b, s, d = xl.shape
        t = b * s
        xf, lf, wf = xl.reshape(t, d), ll.reshape(t), wl.reshape(t)
        stats, chunk = None, chunk_tokens
        if split:
            v0 = mesh.get_local_rank(mi) * hl.shape[1]
            group = mesh.get_group(mi)
            stats = functools.partial(_split_chunk_stats, v0=v0,
                                      group=group)
        elif n_model > 1:
            # the rows split, and the chunk with them: a chunk's logits
            # a rank as large as where the vocabulary is split
            per = -(-t // n_model)
            lo = min(mesh.get_local_rank(mi) * per, t)
            hi = min(lo + per, t)
            xf, lf, wf = xf[lo:hi], lf[lo:hi], wf[lo:hi]
            chunk = -(-chunk_tokens // n_model)
        nll, cor, w, m = _ce_sums(xf, hl, lf, wf, lf >= 0, final_cap,
                                  chunk, stats)
        return torch.stack([nll, w]), torch.stack([cor, m])

    f_sums, i_sums = local_map(
        local, out_placements=(sums_pl, sums_pl),
        in_placements=(rows, head_pl, rows, rows),
        in_grad_placements=(x_grad, head_grad, rows, rows),
        device_mesh=mesh)(*(v.redistribute(mesh, pl) for v, pl in (
            (x, rows), (head, head_pl), (labels, rows), (tok_w, rows))))
    rep = [Replicate()] * mesh.ndim
    f_sums, i_sums = f_sums.redistribute(mesh, rep), \
        i_sums.redistribute(mesh, rep)
    return f_sums[0], i_sums[0], f_sums[1], i_sums[1]


def chunked_ce(params, cfg: ModelConfig, x: torch.Tensor,
               labels: torch.Tensor, tok_w: torch.Tensor, *,
               chunk_tokens: int = 16_384):
    """Cross-entropy without materialising all (B, S, V) f32 logits at
    once: the B*S tokens are flattened and cut into chunks of
    ``chunk_tokens`` (the last padded with zero-weight tokens, as the
    reference pads), and each chunk's logits are recomputed in the
    backward (``torch.utils.checkpoint``).  On a mesh each rank cuts its
    chunks from its own tokens and the vocabulary stays split
    (``_mesh_ce_sums``).  Returns (ce, acc)."""
    b, s, d = x.shape
    x = _gathered_seq(rmsnorm(x, params["final_norm"], cfg.norm_eps))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if is_dtensor(x):
        nll_s, cor_s, w_s, m_s = _mesh_ce_sums(
            x, head, labels, tok_w, cfg.final_softcap, chunk_tokens)
    else:
        t = b * s
        nll_s, cor_s, w_s, m_s = _ce_sums(
            x.reshape(t, d), head, labels.reshape(t), tok_w.reshape(t),
            (labels >= 0).reshape(t), cfg.final_softcap, chunk_tokens)
    ce = nll_s / torch.clamp_min(w_s, 1e-9)
    acc = cor_s.to(torch.float32) / torch.clamp_min(m_s, 1).to(torch.float32)
    return ce, acc


# ---------------------------------------------------------------------------
# cache / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               decode_window: Optional[int] = None, dtype=torch.float32,
               device=None):
    """decode_window forces a sliding window onto full-attention layers
    (the reference's long-context serving adaptation).  ``max_len`` counts
    a vision prefix."""
    layers = []
    for spec in cfg.layers:
        if spec.mixer == MIX_ATTN:
            layers.append(attn_mod.init_kv_cache(
                cfg, spec, batch, max_len, decode_window=decode_window,
                dtype=dtype, device=device))
        elif spec.mixer == MIX_RGLRU:
            layers.append(rec_mod.init_rglru_state(cfg, batch, dtype,
                                                   device))
        elif spec.mixer == MIX_MLSTM:
            layers.append(xlstm_mod.init_mlstm_state(cfg, batch, dtype,
                                                     device))
        else:
            layers.append(xlstm_mod.init_slstm_state(cfg, batch, dtype,
                                                     device))
    cache: Dict[str, Any] = {"layers": layers}
    if cfg.is_encoder_decoder:
        cache["enc_out"] = torch.zeros(
            (batch, cfg.frontend.seq_len, cfg.encoder.d_model), dtype=dtype,
            device=device)
    return cache


def _prefill_block(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                   st, enc_out: Optional[torch.Tensor]):
    """One block of the prompt pass; fills this layer's cache or state."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == MIX_ATTN:
        mix, st = attn_mod.prefill_into_cache(p["mixer"], cfg, spec, h, st)
    elif spec.mixer == MIX_RGLRU:
        mix, h_last, u = rec_mod.rglru_sequence(p["mixer"], h)
        # a copy: a view of u would keep it whole while the cache lives
        st = rec_mod.RGLRUState(
            h=h_last, conv_tail=u[:, -(cfg.conv1d_width - 1):].to(
                st.conv_tail.dtype, copy=True))
    elif spec.mixer == MIX_MLSTM:
        mix, st = xlstm_mod.mlstm_sequence(p["mixer"], h, cfg)
    else:
        mix, st = xlstm_mod.slstm_sequence(p["mixer"], h, cfg)
    x = _cross(p, cfg, spec, _residual(x, mix), enc_out)
    return shard_bse(_ffn(p, cfg, spec, x, serving=True)[0]), st


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache, *,
            frontend: Optional[torch.Tensor] = None):
    """Run the prompt (B, S) (after a vision prefix, or with the encoder's
    output for cross-attention) through the model, filling the cache.
    Returns (last-position logits (B, V), cache)."""
    enc_out = _encoder_output(params, cfg, frontend)
    if enc_out is not None:
        cache = dict(cache, enc_out=enc_out)
    x = _embed_inputs(params, cfg, tokens, frontend)
    new_layers = []
    for p, spec, st in zip(params["layers"], cfg.layers, cache["layers"]):
        x, st = _prefill_block(p, cfg, spec, x, st, enc_out)
        new_layers.append(st)
    logits = _unembed(params, cfg, x[:, -1:])
    return logits[:, 0], dict(cache, layers=new_layers)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos: int,
                cache, *, in_place: bool = False):
    """token: (B,) ints; pos: the global position of this token (a vision
    prefix counted).  Returns (logits (B, V), new cache).  Attention caches
    are updated in place (see ``attention.decode_attention``); with
    ``in_place`` every layer's new state is written into the cache's own
    tensors as soon as the layer is done, where its shape, dtype and
    placement are theirs (``_write_state``), so no two layers' new states
    wait side by side (the stacked step's views, as the reference's
    donated cache)."""
    x = _embed_tokens(params, cfg, token)[:, None]              # (B,1,d)
    x = logical_constraint(x, ("batch", None, "embed"))
    enc_out = cache.get("enc_out")
    new_layers = []
    for p, spec, old in zip(params["layers"], cfg.layers, cache["layers"]):
        h, st = rmsnorm(x, p["ln1"], cfg.norm_eps), old
        if spec.mixer == MIX_ATTN:
            mix, st = attn_mod.decode_attention(p["mixer"], cfg, spec, h,
                                                int(pos), st)
        elif spec.mixer == MIX_RGLRU:
            mix, st = rec_mod.rglru_decode_step(p["mixer"], h, st)
        elif spec.mixer == MIX_MLSTM:
            mix, st = xlstm_mod.mlstm_decode_step(p["mixer"], h, st, cfg)
        else:
            mix, st = xlstm_mod.slstm_decode_step(p["mixer"], h, st, cfg)
        x = _residual(x, mix)
        if enc_out is not None:
            hc = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
            x = _residual(x, attn_mod.cross_decode_attention(
                p["cross"], cfg, spec, hc, int(pos), enc_out))
        x = _ffn(p, cfg, spec, x, serving=True)[0]
        new_layers.append(_write_state(old, st) if in_place else st)
    logits = _unembed(params, cfg, x)
    return logits[:, 0], dict(cache, layers=new_layers)


def _write_state(old, new):
    """The layer state ``new`` with each leaf that fits the ``old`` one
    (shape, dtype, DTensor placements) copied into it, in place; the old
    tensor then stands for the new one."""
    def fits(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and (
            is_dtensor(a) == is_dtensor(b)) and (
            not is_dtensor(a) or tuple(a.placements) == tuple(b.placements))

    leaves_ = []
    for a, b in zip(old, new):
        if b is not a and fits(a, b):
            a.copy_(b)
            b = a
        leaves_.append(b)
    return type(new)(*leaves_)
