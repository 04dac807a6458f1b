"""granite-moe-3b-a800m [moe] — 40 experts, top-8, narrow experts (d_ff=512).
[hf:ibm-granite/granite-3.0-1b-a400m-base family]"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                      # per-expert hidden size
    vocab_size=49155,
    pattern=(ATTN,),
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
    rope_theta=10000.0,
    tie_embeddings=True,
    vocab_pad_to=2048,             # 49155 -> 51200 allocation-friendly on 16-way meshes
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
