"""Per-channel symmetric int8 / fp8 quantization (PyTorch port).

Same scheme as the JAX package: ``scale = max(|x|, axis) / qmax`` (clamped to
1e-8 so all-zero channels stay finite), ``q = clip(round(x / scale))``.  int8
uses qmax=127; fp8 (``torch.float8_e4m3fn``) uses qmax=448 and stores the
scaled value directly (the cast rounds).

Quantized parameter trees wrap every leaf: ``{"q": int8/fp8, "s": f32
scales}`` for every leaf with ndim >= 2 (one scale per slice along the last
axis), ``{"w": tensor}`` for 1-D leaves and for "fp32"/"bf16" members.  Every
layer leaf carries the leading ``repeats`` dim, so the per-layer vectors
(``pre_norm``, ``mlp_norm``, ``q_norm``, ``k_norm`` and the SSM's ``A_log``,
``dt_bias``, ``D``, ``norm``) are ``(repeats, n)`` and are quantized too, one
scale per repeat; only ``final_norm`` stays in f32.  The JAX package does the
same (its comment says otherwise), and the port matches it.
The model forward reads wrapped leaves through :func:`leaf`, which
dequantizes one matrix just before it is used, so the device holds only the
narrow tree.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

# Bytes per parameter for each supported member execution dtype
MEMBER_DTYPES = {"fp32": 4, "bf16": 2, "int8": 1, "fp8": 1}

_FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)
_FP8_MAX = 448.0  # largest finite e4m3 value

# precision ordering for PredictOptions.member_dtype: fp32 > bf16 > int8 == fp8
_PRECISION_RANK = {"fp32": 3, "bf16": 2, "int8": 1, "fp8": 1}


def validate_member_dtype(name: str) -> str:
    """Check ``name`` is a supported member dtype; returns it unchanged."""
    if name not in MEMBER_DTYPES:
        raise ValueError(
            f"unknown member dtype {name!r}; expected one of "
            f"{sorted(MEMBER_DTYPES)}")
    if name == "fp8" and _FP8_DTYPE is None:
        raise ValueError("fp8 member dtype requires a torch build with "
                         "float8_e4m3fn support")
    return name


def dtype_bytes(name: Optional[str]) -> int:
    """Param bytes-per-element for a member dtype (None -> fp32)."""
    if name is None:
        return MEMBER_DTYPES["fp32"]
    return MEMBER_DTYPES[validate_member_dtype(name)]


def is_quantized_dtype(name: Optional[str]) -> bool:
    return name in ("int8", "fp8")


def meets_precision(member_dtype: Optional[str],
                    floor: Optional[str]) -> bool:
    """True when a member executing at ``member_dtype`` (None -> fp32)
    satisfies a request's minimum-precision ``floor`` (None -> any)."""
    if floor is None:
        return True
    have = _PRECISION_RANK[member_dtype or "fp32"]
    return have >= _PRECISION_RANK[validate_member_dtype(floor)]


def quantize_symmetric(x: torch.Tensor, axis: int = -1,
                       dtype: str = "int8") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric quantization along ``axis``.  Returns ``(q,
    scale)`` with ``scale`` keeping a size-1 dim on ``axis``."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    if dtype == "int8":
        scale = torch.clamp(amax / 127.0, min=1e-8)
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    elif dtype == "fp8":
        if _FP8_DTYPE is None:  # pragma: no cover - depends on torch build
            raise ValueError("fp8 unavailable in this torch build")
        scale = torch.clamp(amax / _FP8_MAX, min=1e-8)
        q = (xf / scale).to(_FP8_DTYPE)
    else:
        raise ValueError(f"quantize_symmetric: unsupported dtype {dtype!r}")
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_symmetric` (lossy)."""
    return (q.float() * scale).to(dtype)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cache quantization: symmetric int8 per (..., head) over the
    trailing head dim; the scale keeps a size-1 trailing dim."""
    return quantize_symmetric(x, axis=-1, dtype="int8")


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return dequantize(q, scale, dtype)


def _is_wrapped(node: Any) -> bool:
    if not isinstance(node, dict):
        return False
    keys = set(node)
    return keys == {"q", "s"} or keys == {"w"}


def tree_map(fn, node, is_leaf=None):
    """Map ``fn`` over the leaves of a nested dict/list parameter tree."""
    if is_leaf is not None and is_leaf(node):
        return fn(node)
    if isinstance(node, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_map(fn, v, is_leaf) for v in node]
    return fn(node)


def quantize_params(params: Any, dtype: str = "int8") -> Any:
    """Wrap a parameter tree for reduced-precision storage; undo with
    :func:`dequantize_params` (whole tree) or :func:`leaf` (one matrix)."""
    validate_member_dtype(dtype)

    def wrap(x):
        if x.ndim < 2 or dtype == "fp32":
            return {"w": x}
        if dtype == "bf16":
            return {"w": x.to(torch.bfloat16)}
        q, s = quantize_symmetric(x, axis=-1, dtype=dtype)
        return {"q": q, "s": s}

    return tree_map(wrap, params)


def _unwrap(node, dtype, index=None):
    if "w" in node:
        w = node["w"] if index is None else node["w"][index]
        return w.to(dtype) if w.dtype != dtype else w
    if index is None:
        return dequantize(node["q"], node["s"], dtype)
    return dequantize(node["q"][index], node["s"][index], dtype)


def dequantize_params(qparams: Any, dtype=torch.float32) -> Any:
    """Recover a compute-dtype parameter tree from :func:`quantize_params`."""
    return tree_map(lambda n: _unwrap(n, dtype), qparams, is_leaf=_is_wrapped)


def leaf(node, index: Optional[int] = None) -> torch.Tensor:
    """One parameter as an f32-compute tensor: a plain tensor passes through
    (indexed by ``index`` along the leading ``repeats`` dim when given); a
    wrapped leaf is dequantized here, just before its one use."""
    if _is_wrapped(node):
        return _unwrap(node, torch.float32, index)
    return node if index is None else node[index]


def quantized_param_bytes(params: Any, dtype: str = "int8") -> int:
    """Bytes the wrapped tree occupies on device (q + scales + fp32 rest)."""
    total = [0]

    def add(t):
        total[0] += t.numel() * t.element_size()
        return t

    tree_map(add, quantize_params(params, dtype))
    return total[0]
