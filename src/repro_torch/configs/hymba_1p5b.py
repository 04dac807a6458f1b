"""hymba-1.5b [hybrid] — parallel attention + Mamba heads in every block,
sliding-window on the attention heads.  [arXiv:2411.13676]"""
from repro_torch.configs.base import HYBRID, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    pattern=(HYBRID,),
    sliding_window=1024,          # attention heads are windowed (3 global in the
                                  # source model; we window all for sub-quadratic decode)
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, d_conv=4, chunk=64),
    rope_theta=10000.0,
    vocab_pad_to=2048,            # 32001 -> 32768
    source="arXiv:2411.13676",
)
