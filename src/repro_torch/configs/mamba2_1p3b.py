"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality), no MLP blocks.
[arXiv:2405.21060]"""
from repro_torch.configs.base import SSM, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                        # pure mixer stack, no MLP
    vocab_size=50280,
    pattern=(SSM,),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=64),
    tie_embeddings=True,
    vocab_pad_to=2048,             # 50280 -> 51200
    source="arXiv:2405.21060",
)
