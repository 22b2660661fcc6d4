"""Attention: GQA + RoPE + (optional) sliding window + logit soft-cap.

Port of ``repro.models.attention`` for serving.  Three execution paths:
  * ``naive_attention`` materialises the (S, T) scores: the plain path,
    which a CPU tensor takes (a ``meta`` one, which computes nothing, and
    a CPU one under ``roofline.analysis`` take the kernel's route);
  * on a CUDA tensor every full-sequence core is ``ops.flash_attention``,
    the Hopper kernel, whatever the sequence length (the reference's naive
    and blocked paths compute the same function): causal self-attention,
    the encoder's non-causal self-attention and cross-attention to the
    encoder's output (T != S, no rope);
  * ``decode_attention``: one query token against a (possibly ring-buffer)
    KV cache, and ``cross_decode_attention``, one query against the
    encoder's output: plain PyTorch, as in the reference.

On a device mesh (``repro_torch.sharding``, DTensor params) q, k and v are
constrained to ("batch", None, "heads", None) as in the reference, and the
full-sequence core runs on each rank's local shard through ``local_map``:
its batch shard and its heads, the kv heads split over the heads' axes
when they divide, else the query groups over them with k and v
replicated (MQA on a wider ``model`` axis), else all heads on every rank.
A CUDA shard runs the kernel, a CPU shard the plain path.  The output
projection takes each rank's heads (``local_map``) and leaves the sum
over heads pending; decode and cross-attention's decode gather the heads
before the scores (their products flatten dims DTensor cannot flatten
split) and decode writes the new cache entry into the local shard that
holds its slot.  Where the heads do not divide the heads' axes (8 heads
on a 16-wide ``model`` axis, as on the production meshes), the q, k and
v projections take each rank's rows of x with the weight whole
(``_head_proj``): DTensor's einsum would split the flattened (H, D)
product and could not view it back.  The local cores' gradients are made
contiguous: ``local_map`` hands them back under contiguous global
strides, and the projections' backward views them.

Full-sequence positions are ``arange(S)`` (keys: ``arange(T)``), as every
caller of the reference passes them.

Training: on the CPU autograd runs through ``naive_attention``'s ops, as
the reference's naive path; on CUDA ``ops.flash_attention`` is an autograd
Function whose backward is the hand-written kernel
(``kernels/csrc/flash_attention_bwd.cu``), the counterpart of the blocked
path's custom VJP (``repro.models.attention._flash_backward``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import (CACHE_FILL, apply_rope, dense_init,
                                       map_grad, shard_bshd, softcap)
from repro_torch.roofline import analysis
from repro_torch.sharding.ctx import (PartitionSpec as P, current_mesh,
                                      current_rules, is_dtensor, split_dim,
                                      to_placements, unshard,
                                      unshard_for_local)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attention_params(gen: torch.Generator, cfg: ModelConfig, *,
                          d_in: Optional[int] = None,
                          n_heads: Optional[int] = None,
                          n_kv: Optional[int] = None,
                          head_dim: Optional[int] = None,
                          bias: Optional[bool] = None, dtype=torch.float32):
    """The config's widths unless given (the encoder's own, or the decoder's
    cross-attention without bias)."""
    d = cfg.d_model if d_in is None else d_in
    h = cfg.n_heads if n_heads is None else n_heads
    k = cfg.n_kv_heads if n_kv is None else n_kv
    hd = cfg.head_dim if head_dim is None else head_dim
    use_bias = cfg.qkv_bias if bias is None else bias
    p = {
        "wq": dense_init(gen, (d, h, hd), dtype, fan_in=d),
        "wk": dense_init(gen, (d, k, hd), dtype, fan_in=d),
        "wv": dense_init(gen, (d, k, hd), dtype, fan_in=d),
        "wo": dense_init(gen, (h, hd, d), dtype, fan_in=h * hd),
    }
    if use_bias:
        dev = gen.device
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((k, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((k, hd), dtype=dtype, device=dev)
    return p


def _heads_unfit(n_heads: int) -> bool:
    """True on a mesh whose heads' axes do not divide ``n_heads`` (8 heads
    over a 16-wide ``model`` axis): ``fit_spec`` leaves such heads whole,
    as GSPMD replicates what it cannot split.  A single head is never
    split, so it always fits."""
    rules, mesh = current_rules(), current_mesh()
    if mesh is None or n_heads == 1:
        return False
    from repro_torch.sharding.specs import fit_spec
    spec = P(None, rules.get("heads"), None)
    return spec[1] is not None and \
        fit_spec(spec, (1, n_heads, 1), mesh)[1] != spec[1]


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,E) x w (E,H,D) -> (B,S,H,D).  Where the heads do not fit the
    mesh (``_heads_unfit``), each rank takes the product of its own rows
    of x with w whole (``local_map``) and the heads come out whole on every
    rank: DTensor's einsum would split the flattened (H, D) product over
    the heads' axes and then cannot view it back into H heads."""
    if not (is_dtensor(x) and is_dtensor(w)) or not _heads_unfit(w.shape[1]):
        return torch.einsum("bse,ehd->bshd", x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x = unshard_for_local(x, (2,))
    rep = [Replicate()] * x.device_mesh.ndim
    # each rank's w gradient sums over its own rows
    w_grad = [Partial() if isinstance(p, Shard) else Replicate()
              for p in x.placements]
    return local_map(
        lambda a, b: torch.einsum("bse,ehd->bshd", a, b),
        out_placements=list(x.placements), in_placements=(x.placements, rep),
        in_grad_placements=(x.placements, w_grad),
        device_mesh=x.device_mesh, redistribute_inputs=True)(x, w)


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, *, rope: bool = True,
                 kv_input: Optional[torch.Tensor] = None,
                 kv_positions: Optional[torch.Tensor] = None):
    """Returns q:(B,S,K,G,D), k,v:(B,T,K,D); keys and values come from
    ``kv_input`` (cross-attention) when it is given."""
    kv_x = x if kv_input is None else kv_input
    q = _head_proj(x, params["wq"])
    k = _head_proj(kv_x, params["wk"])
    v = _head_proj(kv_x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = shard_bshd(q)
    k = shard_bshd(k)
    v = shard_bshd(v)
    if rope:
        kv_pos = positions if kv_positions is None else kv_positions
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    n_kv = k.shape[2]
    g = q.shape[2] // n_kv
    if g > 1:
        q = split_dim(q, 2, n_kv)   # heads split where the kv groups are not
    q = q.reshape(q.shape[0], q.shape[1], n_kv, g, q.shape[3])
    return q, k, v


def _out_proj(out: torch.Tensor, params) -> torch.Tensor:
    """(B,S,H,D) x wo (H,D,E) -> (B,S,E).  On a mesh the heads go back onto
    their axes (a local slice where they were whole) and each rank takes
    the product of its own heads (``local_map``: the product flattens
    (D, H) in that order, which DTensor cannot do with H split): a sum
    pending over the heads' axes, which the residual stream's placement
    reduces (Megatron's row-parallel projection).  wo is gathered only
    over its other dims' axes (FSDP)."""
    wo = params["wo"]
    if not is_dtensor(out):
        return torch.einsum("bshd,hde->bse", out, wo)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    out = shard_bshd(out)
    heads = [isinstance(p, Shard) and p.dim == 2 for p in out.placements]
    rows = [isinstance(p, Shard) and p.dim == 0 for p in out.placements]
    y_pl = [Partial() if h else p for h, p in zip(heads, out.placements)]
    wo_pl = [Shard(0) if h else Replicate() for h in heads]
    # each rank's wo gradient sums over its own rows
    wo_grad = [Shard(0) if h else Partial() if r else Replicate()
               for h, r in zip(heads, rows)]
    return local_map(
        lambda o, w: torch.einsum("bshd,hde->bse", o, w),
        out_placements=y_pl, in_placements=(out.placements, wo_pl),
        in_grad_placements=(out.placements, wo_grad),
        device_mesh=out.device_mesh, redistribute_inputs=True)(out, wo)


# ---------------------------------------------------------------------------
# full-sequence paths
# ---------------------------------------------------------------------------

def _mask(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def naive_attention(q, k, v, *, q_pos, k_pos, causal=True,
                    window: Optional[int] = None,
                    cap: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,K,G,D); k,v: (B,T,K,D) -> (B,S,K*G,D)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = softcap(scores, cap)
    mask = _mask(q_pos, k_pos, causal=causal, window=window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
    b, s, kh, g, d = out.shape
    return out.reshape(b, s, kh * g, d)


def flash_core(q, k, v, *, causal: bool = True, window: Optional[int],
               cap: Optional[float]) -> torch.Tensor:
    """Attention through ``ops.flash_attention``: q (B,S,K,G,D), k/v
    (B,T,K,D) -> (B,S,K*G,D).  The kernel reads the model's layout through
    strides, (B,S,H,D) viewed as (B,H,S,D), and writes its output in q's
    layout: no copies where the projections are dense."""
    b, s, kh, g, d = q.shape
    q = q.reshape(b, s, kh * g, d).contiguous()
    out = ops.flash_attention(q.transpose(1, 2),
                              k.contiguous().transpose(1, 2),
                              v.contiguous().transpose(1, 2),
                              causal=causal, window=window, cap=cap)
    return out.transpose(1, 2)


def _attend_sharded(q, k, v, mesh, *, causal: bool, window: Optional[int],
                    cap: Optional[float]) -> torch.Tensor:
    """``_attend`` of DTensors on ``mesh``, each rank's local shard through
    ``local_map``.  q (B,S,K,G,D) is split on the batch's axes and on its
    kv heads K where they divide the heads' axes, else on its query groups
    G (k and v then whole on every rank), as ``fit_spec`` decides; the
    output comes back as (B,S,K,G,D) on q's placements and is merged into
    (B,S,K*G,D) by DTensor."""
    from repro_torch.sharding.specs import fit_spec
    from torch.distributed.tensor.experimental import local_map
    rules = current_rules()
    kv_spec = fit_spec(P(rules.get("batch"), None, rules.get("heads"), None),
                       k.shape, mesh)
    if kv_spec[2] is not None:
        q_spec = P(kv_spec[0], None, kv_spec[2], None, None)
    else:
        q_spec = fit_spec(P(kv_spec[0], None, None, rules.get("heads"), None),
                          q.shape, mesh)
    q_pl, kv_pl = to_placements(q_spec, mesh), to_placements(kv_spec, mesh)
    # k and v whole on a mesh dim that splits the query groups: each rank's
    # dk and dv are its groups' part of the sum
    from torch.distributed.tensor import Partial, Shard
    kv_grad = tuple(Partial() if isinstance(qp, Shard) and qp.dim == 3
                    else kp for qp, kp in zip(q_pl, kv_pl))

    def local(ql, kl, vl):
        # local_map hands the local gradients back under contiguous global
        # strides, and the projections' backward views them
        ql, kl, vl = (map_grad(x, torch.Tensor.contiguous)
                      for x in (ql, kl, vl))
        s, t = ql.shape[1], kl.shape[1]
        out = _attend(ql, kl, vl, torch.arange(s, device=ql.device),
                      torch.arange(t, device=ql.device), causal=causal,
                      window=window, cap=cap)
        return out.reshape(ql.shape)

    out = local_map(local, out_placements=list(q_pl),
                    in_placements=(q_pl, kv_pl, kv_pl),
                    in_grad_placements=(q_pl, kv_grad, kv_grad),
                    device_mesh=mesh, redistribute_inputs=True)(q, k, v)
    b, s, kh, g, d = out.shape
    # the query groups whole before they merge into heads
    return unshard(out, (3,)).reshape(b, s, kh * g, d)


def _attend(q, k, v, q_pos, k_pos, *, causal: bool, window: Optional[int],
            cap: Optional[float]) -> torch.Tensor:
    """The full-sequence core: the plain path on the CPU, the kernel on
    CUDA, each on the local shards on a mesh.  ``meta`` takes the kernel's
    route (its entry points return empty outputs there), and so does the
    CPU under ``roofline.analysis`` (the plain versions inside the entry
    points), so the analysis counts the card's program.  The kernel
    places query i at key i + (T - S); the positions here are ``arange``,
    so a mask agrees with it when S == T or when there is none
    (non-causal, no window: cross-attention)."""
    mesh = current_mesh()
    if mesh is not None and is_dtensor(q):
        return _attend_sharded(q, k, v, mesh, causal=causal, window=window,
                               cap=cap)
    if q.device.type == "cpu" and not analysis.active():
        return naive_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                               causal=causal, window=window, cap=cap)
    if q.shape[1] != k.shape[1] and (causal or window is not None):
        raise ValueError(
            f"a masked attention over S={q.shape[1]} queries and "
            f"T={k.shape[1]} keys at positions arange(S), arange(T) is not "
            "the kernel's alignment")
    return flash_core(q, k, v, causal=causal, window=window, cap=cap)


def attention(params, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
              *, causal: bool = True,
              kv_input: Optional[torch.Tensor] = None,
              rope: bool = True) -> torch.Tensor:
    """Self-attention over a full sequence x (B,S,E), or cross-attention
    to ``kv_input`` (B,T,E').  Query positions are ``arange(S)``, key
    positions ``arange(T)``."""
    positions = torch.arange(x.shape[1], device=x.device)
    kv_positions = None if kv_input is None else torch.arange(
        kv_input.shape[1], device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions, rope=rope,
                           kv_input=kv_input, kv_positions=kv_positions)
    out = _attend(q, k, v, positions,
                  positions if kv_positions is None else kv_positions,
                  causal=causal, window=spec.window, cap=cfg.attn_softcap)
    return _out_proj(out, params)


def cross_decode_attention(params, cfg: ModelConfig, spec: LayerSpec,
                           x: torch.Tensor, pos: int,
                           enc_out: torch.Tensor) -> torch.Tensor:
    """One decoded query (B,1,E) at global position ``pos`` against the
    encoder output (B,T,E), no rope: plain PyTorch on every device, as the
    reference's decode runs it (``use_kernel=False``).  K and V are
    projected from ``enc_out`` again each step, as in the reference."""
    q_pos = torch.tensor([pos], dtype=torch.int32, device=x.device)
    k_pos = torch.arange(enc_out.shape[1], device=x.device)
    q, k, v = _project_qkv(params, x, cfg, q_pos, rope=False,
                           kv_input=enc_out)
    if is_dtensor(q):
        # the scores batch over (B, K): the kv heads whole, as decode's
        q = unshard(q, (2, 3))
        k, v = unshard(k, (2,)), unshard(v, (2,))
    out = naive_attention(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=False,
                          window=spec.window, cap=cfg.attn_softcap)
    return _out_proj(out, params)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # (B, C, Kh, D)
    v: torch.Tensor          # (B, C, Kh, D)
    slot_pos: torch.Tensor   # (C,) global position stored in each slot, -1 empty


def init_kv_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                  max_len: int, *, decode_window: Optional[int] = None,
                  dtype=torch.float32, device=None) -> KVCache:
    window = spec.window if spec.window is not None else decode_window
    c = max_len if window is None else min(window, max_len)
    shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        slot_pos=torch.full((c,), CACHE_FILL["slot_pos"], dtype=torch.int32,
                            device=device),
    )


def prefill_into_cache(params, cfg: ModelConfig, spec: LayerSpec,
                       x: torch.Tensor, cache: KVCache):
    """Run full-sequence attention AND fill the cache with the (windowed)
    tail: the first s slots when the cache has room for the prompt (the
    rest emptied), else the last ``c`` tokens ring-style (slot = pos % c).
    The prompt's keys, values and positions are written into ``cache``'s
    tensors in place (on a mesh into each rank's local shards, as
    ``_write_slots`` lays them).  Returns (y (B,S,E), the cache)."""
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend(q, k, v, positions, positions, causal=True,
                  window=spec.window, cap=cfg.attn_softcap)
    s = q.shape[1]
    _write_slots(cache.k, k, s, 1)
    _write_slots(cache.v, v, s, 1)
    _write_slots(cache.slot_pos, None, s, 0)
    return _out_proj(out, params), cache


def _slot_positions(lo: int, hi: int, c: int, s: int, device):
    """The position each slot in [lo, hi) of a ``c``-slot cache holds after
    a prompt of ``s`` tokens: slot j holds j when the prompt fits (c > s;
    -1 past it), else the last c positions ring-style (slot = pos % c)."""
    j = torch.arange(lo, hi, device=device)
    if c > s:
        return torch.where(j < s, j, torch.full_like(j, -1))
    return s - c + (j - (s - c)) % c


def _write_slots(buf, new, s: int, dim: int) -> None:
    """Fill ``buf``'s slots (dim ``dim``) after a prompt of ``s`` tokens,
    in place: with ``new``'s entries along that dim at the slots'
    positions (``_slot_positions``; an empty slot zeroed), or with the
    positions themselves when ``new`` is None (``slot_pos``).  On a mesh
    each rank fills its own shard of ``buf`` from its local part of
    ``new`` (whole along ``dim``, its other dims split as ``buf``'s)."""
    c = buf.shape[dim]
    local, lo = buf, 0
    if is_dtensor(buf):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        _, off = compute_local_shape_and_global_offset(
            tuple(buf.shape), buf.device_mesh, buf.placements)
        local, lo = buf.to_local(), off[dim]
        if new is not None:
            new = new.redistribute(buf.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == dim else p
                for p in buf.placements]).to_local()
    pos = _slot_positions(lo, lo + local.shape[dim], c, s, local.device)
    if new is None:
        local.copy_(pos)
    elif c > s:
        n = max(0, min(s - lo, local.shape[dim]))
        local.narrow(dim, 0, n).copy_(new.narrow(dim, min(lo, s), n))
        local.narrow(dim, n, local.shape[dim] - n).zero_()
    else:
        local.copy_(new.index_select(dim, pos))


def write_slot(buf, dim: int, slot: int, new) -> None:
    """Write ``new`` (a DTensor of size 1 on ``dim``, or a number) into the
    DTensor ``buf`` at index ``slot`` of ``dim``, in place: only the rank
    whose local shard holds the slot writes, into that shard."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, off = compute_local_shape_and_global_offset(
        tuple(buf.shape), buf.device_mesh, buf.placements)
    if is_dtensor(new):     # its other dims split as ``buf``'s are
        new = new.redistribute(buf.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in buf.placements]).to_local().select(dim, 0)
    i = slot - off[dim]
    if 0 <= i < shape[dim]:
        dst = buf.to_local().select(dim, i)
        dst.copy_(torch.as_tensor(new, device=dst.device))


def decode_attention(params, cfg: ModelConfig, spec: LayerSpec,
                     x: torch.Tensor, pos: int, cache: KVCache):
    """One-token decode. x: (B,1,E); pos: the token's global position.
    Writes the new key and value into ``cache``'s tensors in place (the
    reference returns updated copies; on a mesh into the local shards that
    hold the slot) and returns them as the new cache."""
    positions = torch.tensor([pos], dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    if is_dtensor(q):
        # the scores batch over (B, K): the kv heads whole, as the cache's
        q = unshard(q, (2, 3))
        k_new, v_new = unshard(k_new, (2,)), unshard(v_new, (2,))
    c = cache.k.shape[1]
    slot = pos % c
    k, v, slot_pos = cache
    if is_dtensor(k):
        write_slot(k, 1, slot, k_new.to(k.dtype))
        write_slot(v, 1, slot, v_new.to(v.dtype))
        write_slot(slot_pos, 0, slot, pos)
    else:
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
        slot_pos[slot] = pos
    scale = q.shape[-1] ** -0.5
    sc = torch.einsum("bskgd,btkd->bkgst", q.to(torch.float32),
                      k.to(torch.float32)) * scale     # (B,K,G,1,C)
    sc = softcap(sc, cfg.attn_softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if spec.window is not None:
        valid &= slot_pos > pos - spec.window
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
    b, s, kh, g, d = out.shape
    y = _out_proj(out.reshape(b, s, kh * g, d), params)
    return y, KVCache(k=k, v=v, slot_pos=slot_pos)
