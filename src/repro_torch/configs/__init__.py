"""Architecture registry: ``get_config("qwen3-1.7b")`` and friends."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ATTN, CROSS, HYBRID, SSM, SWA, ModelConfig,
                                MoEConfig, SSMConfig)

from repro_torch.configs.qwen3_1p7b import CONFIG as _qwen3
from repro_torch.configs.h2o_danube_1p8b import CONFIG as _danube
from repro_torch.configs.llama32_vision_11b import CONFIG as _llama32v
from repro_torch.configs.granite_moe_3b import CONFIG as _granite
from repro_torch.configs.llama3_8b import CONFIG as _llama3
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3
from repro_torch.configs.hymba_1p5b import CONFIG as _hymba
from repro_torch.configs.llama4_scout import CONFIG as _llama4
from repro_torch.configs.mamba2_1p3b import CONFIG as _mamba2
from repro_torch.configs.musicgen_large import CONFIG as _musicgen

ARCHITECTURES: Dict[str, ModelConfig] = {
    c.name: c for c in [
        _qwen3, _danube, _llama32v, _granite, _llama3,
        _gemma3, _hymba, _llama4, _mamba2, _musicgen,
    ]
}

# Input shapes assigned to this paper (see system brief).
INPUT_SHAPES = {
    "train_4k":    dict(seq_len=4096,    global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768,   global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32768,   global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524288,  global_batch=1,   kind="decode"),
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown architecture {name!r}; have {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


def list_architectures() -> List[str]:
    return sorted(ARCHITECTURES)


def long_context_ok(cfg: ModelConfig) -> bool:
    """Whether the long_500k decode shape applies.

    SSM / hybrid / sliding-window stacks qualify outright; mixed local:global
    stacks (gemma3's 5:1) qualify when unbounded-attention layers are a small
    minority (<=20%) — their KV caches are seq-sharded over the mesh "data"
    axis while the windowed majority stays O(window).  Pure full-attention
    archs are skipped (see DESIGN.md §4)."""
    if cfg.sub_quadratic:
        return True
    kinds = cfg.layer_kinds()
    unbounded = sum(k in (ATTN, CROSS) for k in kinds)
    bounded = sum(k in (SWA, SSM, HYBRID) for k in kinds)
    return bounded > 0 and unbounded / len(kinds) <= 0.2


# ---------------------------------------------------------------------------
# Paper-style ensembles, rebuilt from the assigned architecture pool.
# The paper's IMN1/IMN4/IMN12 are ensembles of 1/4/12 heterogeneous CNNs;
# we mirror the sizes with heterogeneous *reduced* LM variants so the
# allocation problem keeps the paper's shape (heterogeneous memory/latency).
# ENS* members are (config, instance-suffix) -- an arch may appear twice with
# different reductions, like the paper's ResNet50 vs ResNet101.
# ---------------------------------------------------------------------------
def ensemble(name: str) -> List[ModelConfig]:
    import dataclasses
    reds = {k: v.reduced() for k, v in ARCHITECTURES.items()}

    def resize(cfg: ModelConfig, layers: int, d_model: int, tag: str) -> ModelConfig:
        unit = len(cfg.pattern)
        layers = max(unit, (layers // unit) * unit)
        base = ARCHITECTURES[cfg.name.replace("-reduced", "")]
        out = base.reduced(layers=layers, d_model=d_model)
        return dataclasses.replace(out, name=f"{base.name}-{tag}")

    if name == "ENS1":        # paper IMN1: one single heavy DNN
        return [resize(_llama3, 4, 384, "ens1")]
    if name == "ENS4":        # paper IMN4: 4 heterogeneous models
        return [
            resize(_qwen3, 2, 256, "s"),
            resize(_llama3, 4, 384, "m"),
            resize(_gemma3, 13, 256, "s"),
            resize(_granite, 2, 256, "moe"),
        ]
    if name == "ENS12":       # paper IMN12: 12 heterogeneous models
        out = []
        # every member a distinct (layers, width) like the paper's mix of
        # ResNet18..152 / VGG / Inception — no two identical latency profiles
        sizes = [(2, 192), (2, 224), (2, 256), (2, 288), (4, 224), (4, 256),
                 (4, 288), (4, 320), (4, 384), (6, 256), (6, 320), (8, 384)]
        archs = [_qwen3, _danube, _llama3, _gemma3, _granite, _hymba,
                 _mamba2, _musicgen, _llama4, _llama32v, _qwen3, _llama3]
        for i, a in enumerate(archs):
            L, D = sizes[i]
            out.append(resize(a, L, D, f"e{i}"))
        return out
    raise KeyError(f"unknown ensemble {name!r} (have ENS1, ENS4, ENS12)")
