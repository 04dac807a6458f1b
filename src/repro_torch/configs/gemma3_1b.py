"""gemma3-1b [dense] — 5:1 local:global attention, MQA (kv=1), 262k vocab,
head_dim decoupled from d_model.  [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ATTN, SWA, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,           # 26 = 2 units... pattern unit is 13? use 5:1 pattern below
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    # gemma3: five local (window) layers for every global layer
    # 26 layers = 4 full units of 6 + 2 extra locals folded as one 13-layer unit x2
    pattern=(SWA, SWA, SWA, SWA, SWA, ATTN, SWA, SWA, SWA, SWA, SWA, ATTN, SWA),
    sliding_window=512,
    rope_theta=1_000_000.0,
    embed_scale=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
