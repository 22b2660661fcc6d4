"""Model configuration system.

A single ``ModelConfig`` dataclass describes every architecture family the
framework supports (dense / MoE / hybrid-recurrent / ssm / audio enc-dec /
VLM).  Each layer is described by a ``LayerSpec`` (sequence mixer + ffn kind),
so heterogeneous block patterns (RecurrentGemma's 1:2 RG-LRU:attention,
xLSTM's sLSTM/mLSTM alternation, Gemma-2's local/global alternation) are
first-class rather than special-cased.

Configs are *static* pytree-free dataclasses: they are hashable and can be
closed over by jit'd functions without retracing hazards.

Copy of ``repro.configs.base``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer-level specs
# ---------------------------------------------------------------------------

# Sequence-mixer kinds.
MIX_ATTN = "attn"          # (optionally windowed) self attention
MIX_RGLRU = "rglru"        # RecurrentGemma RG-LRU recurrent block
MIX_MLSTM = "mlstm"        # xLSTM matrix-memory LSTM
MIX_SLSTM = "slstm"        # xLSTM scalar-memory LSTM

# Feed-forward kinds.
FFN_DENSE = "dense"        # gated (SwiGLU/GeGLU) MLP
FFN_MOE = "moe"            # top-k mixture of experts
FFN_NONE = "none"          # mixer-only block (e.g. xLSTM blocks)


@dataclass(frozen=True)
class LayerSpec:
    """One transformer block: a sequence mixer plus a feed-forward."""

    mixer: str = MIX_ATTN
    ffn: str = FFN_DENSE
    # Attention window (tokens). None = full causal attention.
    window: Optional[int] = None

    def __post_init__(self):
        assert self.mixer in (MIX_ATTN, MIX_RGLRU, MIX_MLSTM, MIX_SLSTM), self.mixer
        assert self.ffn in (FFN_DENSE, FFN_MOE, FFN_NONE), self.ffn


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # load-balancing auxiliary loss coefficient (Switch-style)
    aux_loss_coef: float = 0.01
    router_jitter: float = 0.0


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for encoder-decoder models (seamless-m4t)."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int


@dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend (audio conv-codec / ViT are NOT implemented;
    ``input_specs`` provides precomputed frame/patch embeddings)."""

    kind: str                 # "audio_frames" | "vision_patches"
    seq_len: int              # number of frames / patches
    feature_dim: int          # embedding dim delivered by the (stub) frontend


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    layers: Tuple[LayerSpec, ...] = ()
    moe: Optional[MoEConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None

    qkv_bias: bool = False
    o_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "silu"

    # RG-LRU / recurrent-block parameters (hybrid family)
    lru_width: Optional[int] = None
    conv1d_width: int = 4

    # xLSTM parameters (ssm family)
    xlstm_proj_factor: float = 2.0

    # Serving: window used when forcing a long-context sliding-window variant
    # onto a full-attention architecture (documented beyond-paper adaptation).
    long_context_window: int = 4096

    source: str = ""          # citation for the architecture

    # ------------------------------------------------------------------
    def __post_init__(self):
        if not self.layers:
            object.__setattr__(
                self, "layers", tuple(LayerSpec() for _ in range(self.n_layers))
            )
        assert len(self.layers) == self.n_layers, (
            f"{self.name}: len(layers)={len(self.layers)} != n_layers={self.n_layers}"
        )
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA requires n_heads % n_kv == 0"
        if any(l.ffn == FFN_MOE for l in self.layers):
            assert self.moe is not None, f"{self.name}: MoE layers need moe config"

    # ------------------------------------------------------------------
    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None

    @property
    def uses_attention(self) -> bool:
        return any(l.mixer == MIX_ATTN for l in self.layers)

    @property
    def subquadratic(self) -> bool:
        """True iff no layer performs *full* (unwindowed) attention."""
        return all(l.mixer != MIX_ATTN or l.window is not None for l in self.layers)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        n = self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for spec in self.layers:
            n += self._mixer_params(spec)
            n += self._ffn_params(spec)
            n += 2 * self.d_model  # two rmsnorm scales
        n += self.d_model  # final norm
        if self.encoder is not None:
            e = self.encoder
            per_layer = (
                2 * e.d_model * e.n_heads * e.head_dim
                + 2 * e.d_model * e.n_kv_heads * e.head_dim
                + 3 * e.d_model * e.d_ff
                + 2 * e.d_model
            )
            n += e.n_layers * per_layer + e.d_model
            # decoder cross-attention (one per decoder layer)
            n += self.n_layers * (
                2 * self.d_model * self.n_heads * self.head_dim
                + 2 * e.d_model * self.n_kv_heads * self.head_dim
                + self.d_model
            )
        return n

    def _mixer_params(self, spec: LayerSpec) -> int:
        d, hd = self.d_model, self.head_dim
        if spec.mixer == MIX_ATTN:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
            return q + kv + o + bias
        if spec.mixer == MIX_RGLRU:
            w = self.lru_width or d
            # in/out proj (x2 for gate branch), conv1d, RG-LRU gates
            return 2 * d * w + w * d + self.conv1d_width * w + 3 * w
        if spec.mixer in (MIX_MLSTM, MIX_SLSTM):
            w = int(d * self.xlstm_proj_factor)
            # up-proj (x2), qkv-like projections, gates, down-proj
            return 2 * d * w + 3 * w * w // max(self.n_heads, 1) + 6 * w + w * d
        raise ValueError(spec.mixer)

    def _ffn_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        if spec.ffn == FFN_DENSE:
            return 3 * d * self.d_ff
        if spec.ffn == FFN_MOE:
            m = self.moe
            return m.n_experts * 3 * d * m.d_ff_expert + d * m.n_experts
        return 0

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts only top-k experts)."""
        n = self.param_count()
        if self.moe is None:
            return n
        dead = 0
        for spec in self.layers:
            if spec.ffn == FFN_MOE:
                m = self.moe
                dead += (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return n - dead


# ---------------------------------------------------------------------------
# Pattern helpers
# ---------------------------------------------------------------------------

def uniform_layers(n: int, mixer: str = MIX_ATTN, ffn: str = FFN_DENSE,
                   window: Optional[int] = None) -> Tuple[LayerSpec, ...]:
    return tuple(LayerSpec(mixer=mixer, ffn=ffn, window=window) for _ in range(n))


def cycled_layers(n: int, pattern: Tuple[LayerSpec, ...]) -> Tuple[LayerSpec, ...]:
    return tuple(pattern[i % len(pattern)] for i in range(n))


# ---------------------------------------------------------------------------
# Reduced (smoke-test) variants
# ---------------------------------------------------------------------------

def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 128,
            vocab: int = 512) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests (2 layers, d_model<=512,
    <=4 experts) that preserves every structural feature of the config."""
    assert d_model <= 512
    scale = d_model / cfg.d_model
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    head_dim = max(8, d_model // n_heads)
    # preserve the layer pattern, cycled down to n_layers
    layers = tuple(
        dataclasses.replace(cfg.layers[i % cfg.n_layers],
                            window=None if cfg.layers[i % cfg.n_layers].window is None
                            else min(cfg.layers[i % cfg.n_layers].window, 64))
        for i in range(n_layers)
    )
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            n_experts=min(4, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k),
            d_ff_expert=max(16, int(cfg.moe.d_ff_expert * scale)),
            aux_loss_coef=cfg.moe.aux_loss_coef,
        )
    encoder = None
    if cfg.encoder is not None:
        encoder = EncoderConfig(
            n_layers=2, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
            d_ff=max(32, int(cfg.encoder.d_ff * scale)), head_dim=head_dim,
        )
    frontend = None
    if cfg.frontend is not None:
        frontend = FrontendConfig(kind=cfg.frontend.kind, seq_len=16,
                                  feature_dim=d_model)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=max(32, int(cfg.d_ff * scale)),
        vocab_size=vocab,
        layers=layers,
        moe=moe,
        encoder=encoder,
        frontend=frontend,
        lru_width=None if cfg.lru_width is None else d_model,
        long_context_window=64,
    )
