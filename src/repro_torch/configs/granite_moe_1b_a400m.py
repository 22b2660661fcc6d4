"""granite-moe-1b-a400m — 24L d_model=1024 16H (GQA kv=8) d_ff=512/expert,
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]

Copy of ``repro.configs.granite_moe_1b_a400m``; the port imports nothing of ``repro``.
"""

from repro_torch.configs.base import FFN_MOE, ModelConfig, MoEConfig, uniform_layers

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    layers=uniform_layers(24, ffn=FFN_MOE),
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
