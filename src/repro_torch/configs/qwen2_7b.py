"""qwen2-7b — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
GQA with QKV bias.  [arXiv:2407.10671]

Copy of ``repro.configs.qwen2_7b``; the port imports nothing of ``repro``.
"""

from repro_torch.configs.base import ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    layers=uniform_layers(28),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="arXiv:2407.10671",
)
