"""command-r-35b — 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
No biases anywhere.  [hf:CohereForAI/c4ai-command-r-v01]

Copy of ``repro.configs.command_r_35b``; the port imports nothing of ``repro``.
"""

from repro_torch.configs.base import ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_528,
    vocab_size=256_000,
    layers=uniform_layers(40),
    qkv_bias=False,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
