"""Plain float32 reference of the decoder LMs that the benchmark runs.

Written from the model's equations, in plain ``torch`` operations, with no
kernel, cache or batching of the program under test, and importing nothing
of it.  It follows the program's model as the configuration file states it:

* token embedding times sqrt(d_model), RMSNorm with the scale (1 + w)
  and eps ``norm_eps``;
* attention with grouped kv heads (query head h reads kv head h // G),
  optional q/k/v biases, RoPE on the two halves of each head at
  ``rope_theta``, causal, scores scaled by head_dim ** -0.5;
* a SwiGLU MLP, or a top-k mixture of SwiGLU experts: an f32 router,
  softmax over the experts, the top k gates renormalised to sum to 1;
* a final RMSNorm and the output head (the embedding's transpose when
  tied), logits in f32.

Weights come as a plain dict (``embed``, ``final_norm``, ``lm_head``, and
``layers``: name -> tensor with a leading layer axis); any float dtype is
taken to f32 where it is used.  Everything runs in f32 with TF32 off.

``precision="fp8"`` makes the control: every matrix product (projections,
experts, attention's two products, the head; not the f32 router) takes its
two operands rounded to float8 e4m3, each scaled per row along the
contracted axis, and accumulates in f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the enclosed products (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Ref:
    """One configuration's reference.  ``cfg`` is the configuration file's
    ``model`` block (a dict)."""

    def __init__(self, cfg: Dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.c = cfg
        self.fp8 = precision == "fp8"

    # -- products ---------------------------------------------------------
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., K) @ b (K, N) in f32 (both in e4m3 for the control)."""
        a, b = a.float(), b.float()
        if self.fp8:
            a, b = _fp8(a, -1), _fp8(b, 0)
        return a @ b

    def rms(self, x, w):
        x = x.float()
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.c["norm_eps"]) * (1.0 + w.float())

    def rope(self, x, pos):
        """x (T, H, D), pos (T,): rotate the halves of D."""
        d = x.shape[-1]
        inv = 1.0 / self.c["rope_theta"] ** (
            torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d)
        ang = (pos.double()[:, None] * inv).float()[:, None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    # -- attention --------------------------------------------------------
    def qkv(self, lw, l, h, pos):
        """h (T, d) -> q (T, H, D), k, v (T, Kh, D), RoPE applied."""
        c = self.c
        t = h.shape[0]
        q = self.mm(h, lw["wq"][l].reshape(c["d_model"], -1)).reshape(
            t, c["n_heads"], c["head_dim"])
        k = self.mm(h, lw["wk"][l].reshape(c["d_model"], -1)).reshape(
            t, c["n_kv_heads"], c["head_dim"])
        v = self.mm(h, lw["wv"][l].reshape(c["d_model"], -1)).reshape(
            t, c["n_kv_heads"], c["head_dim"])
        if c["qkv_bias"]:
            q = q + lw["bq"][l].float()
            k = k + lw["bk"][l].float()
            v = v + lw["bv"][l].float()
        return self.rope(q, pos), self.rope(k, pos), v

    def attend(self, q, k, v, q_pos, k_pos, block: int = 1024):
        """Causal attention of q (S, H, D) at q_pos over k, v (T, Kh, D) at
        k_pos (both ascending), a block of queries at a time, each over the
        keys up to its last query.  Returns (S, H, D)."""
        g = q.shape[1] // k.shape[1]
        kk = k.float().repeat_interleave(g, dim=1).transpose(0, 1)  # H,T,D
        vv = v.float().repeat_interleave(g, dim=1).transpose(0, 1)
        if self.fp8:
            kk, vv = _fp8(kk, -1), _fp8(vv, 1)
        outs = []
        for s0 in range(0, q.shape[0], block):
            qp = q_pos[s0:s0 + block]
            t = int((k_pos <= qp[-1]).sum())         # the keys any can see
            qb = q[s0:s0 + block].float().transpose(0, 1) \
                * q.shape[-1] ** -0.5                            # H,s,D
            if self.fp8:
                qb = _fp8(qb, -1)
            sc = qb @ kk[:, :t].transpose(1, 2)
            sc = sc.masked_fill(k_pos[None, :t] > qp[:, None],
                                float("-inf"))
            p = torch.softmax(sc, dim=-1)
            del sc
            if self.fp8:
                p = _fp8(p, -1)
            outs.append((p @ vv[:, :t]).transpose(0, 1))
        return torch.cat(outs, 0)

    def out_proj(self, lw, l, o):
        c = self.c
        return self.mm(o.reshape(o.shape[0], -1),
                       lw["wo"][l].reshape(-1, c["d_model"]))

    # -- feed-forward -----------------------------------------------------
    def swiglu(self, h, wg, wu, wd):
        return self.mm(F.silu(self.mm(h, wg)) * self.mm(h, wu), wd)

    def ffn(self, lw, l, h, block: int = 8192):
        """h (T, d) -> y (T, d)."""
        c = self.c
        moe = c.get("moe")
        if moe is None:
            ys = [self.swiglu(h[i:i + block], lw["w_gate"][l],
                              lw["w_up"][l], lw["w_down"][l])
                  for i in range(0, h.shape[0], block)]
            return torch.cat(ys, 0)
        e, k = moe["n_experts"], moe["top_k"]
        wg, wu, wd = (lw[n][l].unbind(0) for n in ("we_gate", "we_up",
                                                   "we_down"))
        probs = torch.softmax(h.float() @ lw["router"][l].float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates = top.values[:, :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        ids = top.indices[:, :k]
        y = torch.zeros_like(h, dtype=torch.float32)
        for j in range(e):
            rows, slot = (ids == j).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            out = self.swiglu(h[rows], wg[j], wu[j], wd[j])
            y = y.index_add(0, rows, out * gates[rows, slot][:, None])
        return y

    # -- the model --------------------------------------------------------
    def embed(self, w, tokens):
        return w["embed"][tokens.long()].float() * math.sqrt(
            self.c["d_model"])

    def head(self, w, x):
        hw = w["embed"].t() if self.c["tie_embeddings"] else w["lm_head"]
        return self.mm(self.rms(x, w["final_norm"]), hw)

    def layer(self, w, l, x, pos):
        """Block ``l`` over x (T, d) at positions pos.  Returns (x, k,
        v)."""
        lw = w["layers"]
        h = self.rms(x, lw["ln1"][l])
        q, k, v = self.qkv(lw, l, h, pos)
        x = x + self.out_proj(lw, l, self.attend(q, k, v, pos, pos))
        return x + self.ffn(lw, l, self.rms(x, lw["ln2"][l])), k, v

    @torch.no_grad()
    def forward(self, w, tokens, n_logits: int = 1,
                on_kv: Optional[Callable] = None):
        """One sequence (S,) -> the logits of its last ``n_logits``
        positions (n, V); ``on_kv(l, k, v)`` sees each layer's keys and
        values (S, Kh, D)."""
        with exact_f32():
            pos = torch.arange(tokens.shape[0], device=tokens.device)
            x = self.embed(w, tokens)
            for l in range(self.c["n_layers"]):
                x, k, v = self.layer(w, l, x, pos)
                if on_kv is not None:
                    on_kv(l, k, v)
            return self.head(w, x[-n_logits:])
