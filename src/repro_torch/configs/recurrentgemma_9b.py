"""recurrentgemma-9b — 38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000.
RG-LRU + local attention in a 1:2 (attn : recurrent) pattern.  [arXiv:2402.19427]

Copy of ``repro.configs.recurrentgemma_9b``; the port imports nothing of ``repro``.
"""

from repro_torch.configs.base import (FFN_DENSE, LayerSpec, MIX_ATTN, MIX_RGLRU,
                                      ModelConfig, cycled_layers)

# Griffin pattern: two RG-LRU blocks then one local-attention block.
_PATTERN = (
    LayerSpec(mixer=MIX_RGLRU, ffn=FFN_DENSE),
    LayerSpec(mixer=MIX_RGLRU, ffn=FFN_DENSE),
    LayerSpec(mixer=MIX_ATTN, ffn=FFN_DENSE, window=2048),
)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    layers=cycled_layers(38, _PATTERN),
    lru_width=4096,
    conv1d_width=4,
    tie_embeddings=True,
    source="arXiv:2402.19427",
)
