"""gemma2-2b — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Alternating local(4096)/global attention, attention + final logit soft-caps.
[arXiv:2408.00118]

Copy of ``repro.configs.gemma2_2b``; the port imports nothing of ``repro``.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, cycled_layers

_PATTERN = (
    LayerSpec(window=4096),   # local sliding-window layer
    LayerSpec(window=None),   # global layer
)

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layers=cycled_layers(26, _PATTERN),
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
