"""seamless-m4t-medium — enc-dec, 12L d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=256206, multimodal (speech).  The audio frontend (mel + conv feature
extractor) is a STUB: ``input_specs`` provides precomputed frame embeddings.
[arXiv:2308.11596]

Copy of ``repro.configs.seamless_m4t_medium``; the port imports nothing of ``repro``.
"""

from repro_torch.configs.base import (EncoderConfig, FrontendConfig, ModelConfig,
                                      uniform_layers)

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    layers=uniform_layers(12),
    encoder=EncoderConfig(n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
                          d_ff=4096, head_dim=64),
    frontend=FrontendConfig(kind="audio_frames", seq_len=1024, feature_dim=1024),
    tie_embeddings=True,
    source="arXiv:2308.11596",
)
