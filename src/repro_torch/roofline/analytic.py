"""Analytic roofline terms per (architecture x input shape).

Why analytic: XLA *CPU* ``cost_analysis()`` counts each ``while``-loop body
ONCE, so with scan-over-layers / flash scans / CE chunk scans the reported
FLOPs under-count by the trip counts (validated in EXPERIMENTS.md §Roofline
against an unrolled compile).  The analytic model below reproduces what the
compiled program actually executes — including deliberate overcompute
(dense-MoE E/k inflation, unskipped masked attention chunks, remat) — and is
cross-checked against the HLO-parsed collective op *kinds*.

All quantities are per-device on the single-pod (16,16) mesh.

Copy of ``repro.roofline.analytic``, its imports redirected to the port's
``configs``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import (FFN_DENSE, FFN_MOE, MIX_ATTN,
                                      MIX_MLSTM, MIX_RGLRU, MIX_SLSTM,
                                      ModelConfig)
from repro_torch.configs.shapes import InputShape
from repro_torch.roofline.hardware import TPU_V5E, Chip

BF16 = 2
F32 = 4


@dataclass
class AnalyticReport:
    flops: float          # per device
    hbm_bytes: float      # per device
    coll_bytes: float     # per device
    # decomposition for the perf log
    flops_ideal: float    # without remat/dense-MoE/masked-chunk waste
    detail: dict

    def terms(self, chip: Chip = TPU_V5E):
        return {
            "compute": self.flops / chip.peak_flops_bf16,
            "memory": self.hbm_bytes / chip.hbm_bandwidth,
            "collective": self.coll_bytes / (
                chip.ici_links_per_chip * chip.ici_link_bandwidth),
        }

    def bottleneck(self, chip: Chip = TPU_V5E) -> str:
        t = self.terms(chip)
        return max(t, key=t.get)


def _layer_flops(cfg: ModelConfig, spec, tokens: int, ctx: int,
                 moe_dense: bool):
    """Forward FLOPs of one layer over ``tokens`` tokens with attention
    context ``ctx`` (= kv length actually computed against)."""
    d = cfg.d_model
    f = 0.0
    if spec.mixer == MIX_ATTN:
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        f += 2 * tokens * d * (h + 2 * kh) * hd      # qkv proj
        f += 2 * tokens * h * hd * d                 # out proj
        f += 4 * tokens * ctx * h * hd               # qk^T + pv
    elif spec.mixer == MIX_RGLRU:
        w = cfg.lru_width or d
        f += 2 * tokens * d * w * 3                  # in/gate/out projections
        f += tokens * w * (2 * cfg.conv1d_width + 12)  # conv + gates + scan
    elif spec.mixer in (MIX_MLSTM, MIX_SLSTM):
        w = int(d * cfg.xlstm_proj_factor) if spec.mixer == MIX_MLSTM else d
        hd = w // cfg.n_heads
        f += 2 * tokens * d * w * 3                  # up/z/down projections
        if spec.mixer == MIX_MLSTM:
            f += 2 * tokens * w * hd * 3             # per-head q/k/v proj
            chunk = 128
            f += 4 * tokens * chunk * w              # within-chunk quadratic
            f += 2 * (tokens / chunk) * cfg.n_heads * hd * hd * 2  # states
        else:
            f += 2 * tokens * d * hd * 4             # recurrent R_gate
    if spec.ffn == FFN_DENSE:
        f += 2 * tokens * d * cfg.d_ff * 3
    elif spec.ffn == FFN_MOE:
        experts = cfg.moe.n_experts if moe_dense else cfg.moe.top_k
        f += 2 * tokens * d * cfg.moe.d_ff_expert * 3 * experts
        f += 2 * tokens * d * cfg.moe.n_experts      # router
    return f


def _param_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * BF16


def analyze(cfg: ModelConfig, shape: InputShape, *, n_devices: int = 256,
            data_axis: int = 16, model_axis: int = 16,
            moe_dense: bool = True, remat: bool = True,
            causal_skip: bool = False) -> AnalyticReport:
    b, s = shape.global_batch, shape.seq_len
    kind = shape.kind
    p_bytes = _param_bytes(cfg)

    if kind == "decode":
        tokens = b                        # ONE new token per sequence
        force_window = (not cfg.subquadratic) and s > 65536
    else:
        tokens = b * s
        force_window = False

    def ctx_for(spec):
        if kind == "decode":
            w = spec.window if spec.window is not None else (
                cfg.long_context_window if force_window else s)
            return min(w if w else s, s)
        # train/prefill blocked fallback computes every chunk (masked):
        full = s if not causal_skip else s / 2
        if spec.window is not None and causal_skip:
            return min(spec.window, s)
        return full

    def ctx_ideal(spec):
        if kind == "decode":
            return ctx_for(spec)   # the SW serving policy is semantic, not waste
        w = spec.window or s
        return min(w, s) / (2 if spec.window is None else 1)

    fwd = sum(_layer_flops(cfg, spec, tokens, ctx_for(spec), moe_dense)
              for spec in cfg.layers)
    fwd_ideal = sum(_layer_flops(cfg, spec, tokens, ctx_ideal(spec), False)
                    for spec in cfg.layers)
    # encoder (audio enc-dec): frontend frames
    if cfg.encoder is not None and cfg.frontend is not None:
        e = cfg.encoder
        etok = (b if kind != "decode" else b) * cfg.frontend.seq_len \
            if kind != "decode" else 0
        if kind != "decode":
            enc = etok * (2 * e.d_model * (e.n_heads + 2 * e.n_kv_heads)
                          * e.head_dim + 2 * e.n_heads * e.head_dim * e.d_model
                          + 6 * e.d_model * e.d_ff) \
                + 4 * etok * cfg.frontend.seq_len * e.n_heads * e.head_dim
            fwd += enc
            fwd_ideal += enc
    # unembed / CE
    head = 2 * tokens * cfg.d_model * cfg.vocab_size
    fwd += head
    fwd_ideal += head

    if kind == "train":
        mult = 4.0 if remat else 3.0      # fwd + 2x bwd (+ remat refwd)
        flops = mult * fwd
        flops_ideal = 3.0 * fwd_ideal
    else:
        flops = fwd
        flops_ideal = fwd_ideal

    # ---------------- HBM bytes (per device) ----------------
    act_unit = tokens / data_axis * cfg.d_model * BF16
    n_layers = cfg.n_layers
    if kind == "train":
        # FSDP: every device streams ALL gathered weights fwd+bwd+remat
        w_traffic = 3.0 * p_bytes
        opt_traffic = 4.0 * p_bytes / n_devices * (F32 / BF16)
        act_traffic = n_layers * act_unit * 12 * (2 if remat else 1)
        hbm = w_traffic + opt_traffic + act_traffic
    elif kind == "prefill":
        hbm = p_bytes + n_layers * act_unit * 8
        # KV cache write
        hbm += (cfg.n_layers * tokens / data_axis * 2
                * cfg.n_kv_heads * cfg.head_dim * BF16)
    else:
        # decode: read all weights once + read the whole KV cache / states
        cache_tokens = sum(
            min(spec.window or (cfg.long_context_window if force_window
                                else s), s)
            for spec in cfg.layers if spec.mixer == MIX_ATTN)
        cache_bytes = (b * cache_tokens * 2 * cfg.n_kv_heads
                       * cfg.head_dim * BF16) / n_devices
        hbm = p_bytes / n_devices * (1 if kind == "decode" else 1) \
            + cache_bytes + p_bytes / n_devices
        # every device holds p/n but READS weights via collectives; count
        # the local share twice (read + resident)
        hbm = p_bytes / n_devices * 2 + cache_bytes

    # ---------------- collective bytes (per device) ----------------
    if kind == "train":
        # FSDP all-gather (fwd + bwd remat) + grad reduce-scatter (f32)
        coll = 2.0 * p_bytes + p_bytes * (F32 / BF16)
        # sequence-parallel gathers + TP reduces per layer (fwd+bwd)
        coll += n_layers * act_unit * 4
        # FedAvg weighted grad psum IS the reduce-scatter above (counted)
    elif kind == "prefill":
        coll = p_bytes + n_layers * act_unit * 2
    else:
        # weight gathers dominate decode on 2D-sharded params
        coll = p_bytes / data_axis  # all-gather over data axis share
        coll += b / max(data_axis, 1) * cfg.d_model * BF16 * n_layers * 2

    return AnalyticReport(
        flops=flops / n_devices,
        hbm_bytes=hbm if kind == "train" else hbm,
        coll_bytes=coll,
        flops_ideal=flops_ideal / n_devices,
        detail={"fwd": fwd, "param_bytes": p_bytes, "tokens": tokens},
    )
