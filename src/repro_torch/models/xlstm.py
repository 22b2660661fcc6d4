"""xLSTM blocks: mLSTM (matrix memory, parallelisable) and sLSTM (scalar
memory with recurrent gate connections), per arXiv:2405.04517.

Port of ``repro.models.xlstm``.  Both use exponential gating with the
max-stabiliser m_t, which starts at -inf; the order of ``maximum`` and
``exp`` is the reference's, so -inf never meets -inf in a subtraction.
Log-sigmoid is ``-softplus(-x)`` with the reference's threshold-free
softplus (``common.softplus``), not ``F.logsigmoid``.

  * mLSTM: the full sequence runs chunkwise (chunks of 128: quadratic
    decay-masked attention inside a chunk, the (C, n, m) state carried
    across chunks by a Python loop where the reference scans); decode runs
    the per-step recurrence.  A prompt is at most one chunk long or a
    multiple of the chunk (the reference's assert).
  * sLSTM: strictly sequential, S steps of small launches per layer (plain
    PyTorch: the reference has no TPU kernel for it).  The four gates'
    head-wise recurrent products run as one batched product a step.

``mlstm_sequence`` and ``slstm_sequence`` return the block's output and
the state decode carries on (the reference's ``lm._mlstm_prefill`` and
``_slstm_prefill``); the mLSTM conv tail comes from the block's own
up-projection, where the reference computes it again.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import causal_conv, dense_init, softplus
from repro_torch.sharding.ctx import logical_constraint

DEFAULT_MLSTM_CHUNK = 128
CONV_WIDTH = 4
# the profiler range around the sLSTM step loop (``launch/profile_serve``)
SLSTM_RANGE = "slstm_step_loop"
_GATES = ("z", "i", "f", "o")


def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    w = int(cfg.d_model * cfg.xlstm_proj_factor)
    return w, cfg.n_heads, w // cfg.n_heads


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype=torch.float32):
    d = cfg.d_model
    w, h, hd = _mlstm_dims(cfg)
    dev = gen.device
    return {
        "w_up": dense_init(gen, (d, w), dtype),
        "w_z": dense_init(gen, (d, w), dtype),
        "conv_w": dense_init(gen, (CONV_WIDTH, w), dtype,
                             fan_in=CONV_WIDTH),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "w_q": dense_init(gen, (h, hd, hd), dtype, fan_in=hd),
        "w_k": dense_init(gen, (h, hd, hd), dtype, fan_in=hd),
        "w_v": dense_init(gen, (h, hd, hd), dtype, fan_in=hd),
        "w_i": dense_init(gen, (w, h), dtype),
        "w_f": dense_init(gen, (w, h), dtype),
        "b_i": torch.zeros((h,), dtype=dtype, device=dev),
        # forget-gate bias: remember early
        "b_f": torch.full((h,), 3.0, dtype=dtype, device=dev),
        "w_down": dense_init(gen, (w, d), dtype),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor          # (B, H, hd, hd)
    n: torch.Tensor          # (B, H, hd)
    m: torch.Tensor          # (B, H)
    conv_tail: torch.Tensor  # (B, 3, W)


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> MLSTMState:
    w, h, hd = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        C=torch.zeros((batch, h, hd, hd), **f32),
        n=torch.zeros((batch, h, hd), **f32),
        m=torch.full((batch, h), float("-inf"), **f32),
        conv_tail=torch.zeros((batch, CONV_WIDTH - 1, w), dtype=dtype,
                              device=device),
    )


def _mlstm_qkvif(params, x: torch.Tensor, h: int, hd: int):
    """Shared projections.  x: (B,S,d) -> q, k, v (B,H,S,hd) f32; i, f
    pre-activations (B,H,S) f32; the output gate z (B,S,W); the
    up-projection xu (B,S,W)."""
    xu = x @ params["w_up"]
    xu = logical_constraint(xu, ("batch", None, "ff"))
    xc = F.silu(causal_conv(xu, params["conv_w"], params["conv_b"]))
    b, s, w = xc.shape
    xh = xc.reshape(b, s, h, hd).transpose(1, 2)                # (B,H,S,hd)
    q = torch.matmul(xh, params["w_q"])
    k = torch.matmul(xh, params["w_k"]) * (hd ** -0.5)
    v = torch.matmul(xh, params["w_v"])
    i_pre = (xc @ params["w_i"] + params["b_i"]).to(torch.float32)
    f_pre = (xc @ params["w_f"] + params["b_f"]).to(torch.float32)
    z = F.silu(x @ params["w_z"])
    f32 = torch.float32
    return (q.to(f32), k.to(f32), v.to(f32), i_pre.transpose(1, 2),
            f_pre.transpose(1, 2), z, xu)


def _mlstm_step(carry, inp):
    """One step of the recurrence.  q, k, v: (B,H,hd); i, f: (B,H)."""
    C, n, m = carry
    q, k, v, i_pre, f_pre = inp
    logf = _log_sigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf + m - m_new)
    C = f_g[..., None, None] * C + i_g[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    hq = torch.matmul(C, q[..., None])[..., 0]
    denom = torch.maximum(torch.abs((n * q).sum(-1)), torch.exp(-m_new))
    return (C, n, m_new), hq / denom[..., None]


def mlstm_chunkwise(q, k, v, i_pre, f_pre, *,
                    chunk: int = DEFAULT_MLSTM_CHUNK):
    """Chunkwise-parallel stabilised mLSTM.

    q, k, v: (B,H,S,hd) f32; i_pre, f_pre: (B,H,S) f32.  Inside a chunk:
    quadratic (L x L) decay-masked attention; across chunks: the (C, n, m)
    state, from zeros and m = -inf.  Returns (h (B,H,S,hd), (C, n, m)
    final state)."""
    bsz, nh, s, hd = q.shape
    l = min(chunk, s)
    assert s % l == 0, (s, l)
    nc = s // l
    logf = _log_sigmoid(f_pre)
    dev = q.device

    c_st = torch.zeros((bsz, nh, hd, hd), dtype=torch.float32, device=dev)
    n_st = torch.zeros((bsz, nh, hd), dtype=torch.float32, device=dev)
    m_st = torch.full((bsz, nh), float("-inf"), dtype=torch.float32,
                      device=dev)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dev))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    hs = []
    for j in range(nc):
        cut = slice(j * l, (j + 1) * l)
        qc, kc, vc = q[:, :, cut], k[:, :, cut], v[:, :, cut]
        ic, lfc = i_pre[:, :, cut], logf[:, :, cut]
        b_cum = torch.cumsum(lfc, dim=-1)                      # (B,H,L)
        u = ic - b_cum
        m_run = torch.maximum(m_st[..., None],
                              torch.cummax(u, dim=2).values)   # M_t
        # intra-chunk decay-masked scores
        w_decay = torch.exp(u[:, :, None, :] - m_run[..., None])
        w_decay = torch.where(tri, w_decay, zero)              # (B,H,Lq,Ls)
        sc = torch.matmul(qc, kc.transpose(-1, -2)) * w_decay
        num_intra = torch.matmul(sc, vc)
        den_intra = sc.sum(dim=-1)
        # inter-chunk contribution
        scale_in = torch.exp(m_st[..., None] - m_run)          # (B,H,L)
        num_inter = (torch.matmul(qc, c_st.transpose(-1, -2))
                     * scale_in[..., None])
        den_inter = torch.matmul(qc, n_st[..., None])[..., 0] * scale_in
        m_t = b_cum + m_run
        denom = torch.maximum(torch.abs(den_intra + den_inter),
                              torch.exp(-m_t))
        hs.append((num_intra + num_inter) / denom[..., None])
        # state update to the end of the chunk
        m_end = torch.maximum(m_st, u.max(dim=-1).values)
        w_end = torch.exp(u - m_end[..., None])                # (B,H,L)
        decay = torch.exp(m_st - m_end)
        c_st = (decay[..., None, None] * c_st
                + torch.matmul((vc * w_end[..., None]).transpose(-1, -2),
                               kc))
        n_st = (decay[..., None] * n_st
                + torch.matmul(w_end[..., None, :], kc)[..., 0, :])
        m_st = b_cum[..., -1] + m_end
    h = hs[0] if nc == 1 else torch.cat(hs, dim=2)
    return h, (c_st, n_st, m_st)


def mlstm_sequence(params, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, MLSTMState]:
    """Full-sequence mLSTM block and its final state.  x: (B,S,d)."""
    w, nh, hd = _mlstm_dims(cfg)
    q, k, v, i_pre, f_pre, z, xu = _mlstm_qkvif(params, x, nh, hd)
    b, s = x.shape[:2]
    hs, (C, n, m) = mlstm_chunkwise(q, k, v, i_pre, f_pre)
    hs = hs.transpose(1, 2).reshape(b, s, w).to(x.dtype)
    y = (hs * z) @ params["w_down"]
    tail = xu[:, -(CONV_WIDTH - 1):].to(x.dtype)
    return y, MLSTMState(C=C, n=n, m=m, conv_tail=tail)


def mlstm_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence mLSTM block (chunkwise-parallel). x: (B,S,d)."""
    return mlstm_sequence(params, x, cfg)[0]


def mlstm_decode_step(params, x: torch.Tensor, state: MLSTMState,
                      cfg: ModelConfig):
    """x: (B,1,d) -> (y (B,1,d), new state)."""
    w, nh, hd = _mlstm_dims(cfg)
    xu = x @ params["w_up"]                                     # (B,1,W)
    conv_in = torch.cat([state.conv_tail, xu], dim=1)           # (B,4,W)
    xc = (conv_in[:, -CONV_WIDTH:] * params["conv_w"]).sum(dim=1)
    xc = F.silu(xc + params["conv_b"])                          # (B,W)
    xh = xc.reshape(-1, nh, 1, hd)
    f32 = torch.float32
    q = torch.matmul(xh, params["w_q"])[:, :, 0].to(f32)
    k = (torch.matmul(xh, params["w_k"])[:, :, 0] * (hd ** -0.5)).to(f32)
    v = torch.matmul(xh, params["w_v"])[:, :, 0].to(f32)
    i_pre = (xc @ params["w_i"] + params["b_i"]).to(f32)
    f_pre = (xc @ params["w_f"] + params["b_f"]).to(f32)
    (C, n, m), h_t = _mlstm_step((state.C, state.n, state.m),
                                 (q, k, v, i_pre, f_pre))
    z = F.silu(x @ params["w_z"])[:, 0]
    out = (h_t.reshape(-1, w).to(x.dtype) * z)[:, None]
    return out @ params["w_down"], MLSTMState(C=C, n=n, m=m,
                                              conv_tail=conv_in[:, 1:])


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype=torch.float32):
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    dev = gen.device
    p = {"w_down": dense_init(gen, (d, d), dtype),
         "w_z_gate": dense_init(gen, (d, d), dtype)}
    for gate in _GATES:
        p[f"w_{gate}"] = dense_init(gen, (d, d), dtype)
        # recurrent connection: block-diagonal per head
        p[f"r_{gate}"] = dense_init(gen, (h, hd, hd), dtype, fan_in=hd)
        p[f"b_{gate}"] = (torch.full((d,), 3.0, dtype=dtype, device=dev)
                          if gate == "f" else
                          torch.zeros((d,), dtype=dtype, device=dev))
    return p


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d)
    n: torch.Tensor   # (B, d)
    m: torch.Tensor   # (B, H)
    h: torch.Tensor   # (B, d)


def init_slstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> SLSTMState:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMState(
        c=torch.zeros((batch, d), **f32),
        n=torch.zeros((batch, d), **f32),
        m=torch.full((batch, cfg.n_heads), float("-inf"), **f32),
        h=torch.zeros((batch, d), **f32),
    )


def _slstm_gate_inputs(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,d) -> the gates' input projections (S, B, 4, d) in f32, in
    the order z, i, f, o."""
    pre = [(x @ params[f"w_{g}"] + params[f"b_{g}"]).to(torch.float32)
           for g in _GATES]
    return torch.stack(pre, dim=2).transpose(0, 1)


def _slstm_recurrent(params, n_heads: int) -> torch.Tensor:
    """The four gates' block-diagonal recurrent weights as one (H, hd,
    4*hd) operand: column g*hd + e is gate g's output e."""
    return torch.cat([params[f"r_{g}"].to(torch.float32) for g in _GATES],
                     dim=-1)


def _slstm_steps(rw: torch.Tensor, n_heads: int, state: SLSTMState,
                 xs: torch.Tensor) -> Tuple[SLSTMState, torch.Tensor]:
    """Run the recurrence over xs (S, B, 4, d).  Returns the final state
    and the hidden states (B, S, d)."""
    c, n, m, h = state
    b, d = c.shape
    hd = d // n_heads
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    hs = []
    for x_t in xs:
        # the gates' recurrent products in one batched product:
        # (H, B, hd) @ (H, hd, 4*hd) -> (B, 4, H, hd)
        r = torch.bmm(h.view(b, n_heads, hd).transpose(0, 1), rw)
        pre = x_t.view(b, 4, n_heads, hd) + r.view(
            n_heads, b, 4, hd).permute(1, 2, 0, 3)
        z = torch.tanh(pre[:, 0])
        i_pre, f_pre = pre[:, 1], pre[:, 2]
        o = torch.sigmoid(pre[:, 3])
        logf = -torch.logaddexp(-f_pre, zero)       # log sigmoid
        # head-wise stabiliser (max over the head's dims)
        logf_m = logf + m[..., None]
        m = torch.maximum(logf_m.amax(-1), i_pre.amax(-1))
        i_g = torch.exp(i_pre - m[..., None]).reshape(b, d)
        f_g = torch.exp(logf_m - m[..., None]).reshape(b, d)
        c = f_g * c + i_g * z.reshape(b, d)
        n = f_g * n + i_g
        h = o.reshape(b, d) * (c / torch.clamp_min(n, 1e-6))
        hs.append(h)
    return SLSTMState(c=c, n=n, m=m, h=h), torch.stack(hs, dim=1)


def slstm_sequence(params, x: torch.Tensor, cfg: ModelConfig,
                   state: SLSTMState = None
                   ) -> Tuple[torch.Tensor, SLSTMState]:
    """Full-sequence sLSTM block (strictly sequential) and its final state,
    from ``state`` (zeros and m = -inf by default).  x: (B,S,d)."""
    b = x.shape[0]
    if state is None:
        state = init_slstm_state(cfg, b, device=x.device)
    xs = _slstm_gate_inputs(params, x)
    rw = _slstm_recurrent(params, cfg.n_heads)
    with record_function(SLSTM_RANGE):
        state, hs = _slstm_steps(rw, cfg.n_heads, state, xs)
    out = hs.to(x.dtype) * F.silu(x @ params["w_z_gate"])
    return out @ params["w_down"], state


def slstm_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence sLSTM block. x: (B,S,d)."""
    return slstm_sequence(params, x, cfg)[0]


def slstm_decode_step(params, x: torch.Tensor, state: SLSTMState,
                      cfg: ModelConfig):
    """x: (B,1,d) -> (y (B,1,d), new state)."""
    return slstm_sequence(params, x, cfg, state)
