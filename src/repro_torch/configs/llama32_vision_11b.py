"""llama-3.2-vision-11b [vlm] — decoder with cross-attention image layers every
5th layer; the vision tower is the sanctioned frontend stub (input_specs()
supplies precomputed patch embeddings).  [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ATTN, CROSS, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    # every 5th layer cross-attends to the image patch embeddings
    pattern=(ATTN, ATTN, ATTN, ATTN, CROSS),
    rope_theta=500000.0,
    frontend_tokens=1600,      # 4 tiles x 400 patches, projected by the stub
    frontend_dim=4096,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
