"""xlstm-350m — 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.
Alternating sLSTM / mLSTM blocks (block-internal projections; no separate FFN).
[arXiv:2405.04517]

Copy of ``repro.configs.xlstm_350m``; the port imports nothing of ``repro``.
"""

from repro_torch.configs.base import (FFN_NONE, LayerSpec, MIX_MLSTM, MIX_SLSTM,
                                      ModelConfig, cycled_layers)

# xLSTM[7:1]-style stacks interleave mLSTM-heavy patterns with sLSTM blocks;
# we use the paper's 1:1 alternation variant for the 350M scale.
_PATTERN = (
    LayerSpec(mixer=MIX_MLSTM, ffn=FFN_NONE),
    LayerSpec(mixer=MIX_SLSTM, ffn=FFN_NONE),
)

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50_304,
    layers=cycled_layers(24, _PATTERN),
    xlstm_proj_factor=2.0,
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
