"""internvl2-1b — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
InternViT vision encoder + projector is a STUB: ``input_specs`` provides
precomputed patch embeddings; we implement the InternLM2/Qwen2-style language
backbone.  [arXiv:2404.16821]

Copy of ``repro.configs.internvl2_1b``; the port imports nothing of ``repro``.
"""

from repro_torch.configs.base import FrontendConfig, ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    layers=uniform_layers(24),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="vision_patches", seq_len=256, feature_dim=896),
    tie_embeddings=True,
    source="arXiv:2404.16821",
)
