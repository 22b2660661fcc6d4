"""dbrx-132b — 40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert vocab=100352,
fine-grained MoE: 16 experts top-4.  [hf:databricks/dbrx-base]

Copy of ``repro.configs.dbrx_132b``; the port imports nothing of ``repro``.
"""

from repro_torch.configs.base import FFN_MOE, ModelConfig, MoEConfig, uniform_layers

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10_752,
    vocab_size=100_352,
    layers=uniform_layers(40, ffn=FFN_MOE),
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10_752),
    rope_theta=500_000.0,
    tie_embeddings=False,
    source="hf:databricks/dbrx-base",
)
