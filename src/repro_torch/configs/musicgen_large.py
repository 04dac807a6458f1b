"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens
(vocab 2048); the EnCodec encoder/mel frontend is the sanctioned stub.
[arXiv:2306.05284]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,               # MHA (GQA kv=32)
    d_ff=8192,
    vocab_size=2048,
    pattern=(ATTN,),
    rope_theta=10000.0,            # source uses sinusoidal; RoPE noted in DESIGN
    source="arXiv:2306.05284",
)
