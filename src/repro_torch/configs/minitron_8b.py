"""minitron-8b — 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Width/depth-pruned Nemotron-4.  [arXiv:2407.14679]

Copy of ``repro.configs.minitron_8b``; the port imports nothing of ``repro``.
"""

from repro_torch.configs.base import ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=256_000,
    layers=uniform_layers(32),
    tie_embeddings=False,
    source="arXiv:2407.14679",
)
