"""Logical sharding rules: param/cache/batch trees -> partition-spec trees,
and the DTensor placements they mean on a ``DeviceMesh``.

Strategy (DESIGN.md §5): batch over ("pod","data"), width over "model".
Every rule is a preference list of (dim, mesh-axis) candidates; the first
candidate whose dimension size divides the axis size wins, otherwise the
tensor is replicated -- so every architecture places on the production mesh
whatever its head or expert counts.  The rule tables and fallbacks are the
JAX package's, and :class:`P` equals ``jax.sharding.PartitionSpec`` element
for element.  The rules take an abstract ``launch.mesh.Mesh`` or a
``DeviceMesh``; :func:`to_placements` needs the latter.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_names, axis_sizes, batch_axes

# name -> preference list of (dim, axis) in LAYER-LOCAL coords (no repeats dim)
_PARAM_RULES: Dict[str, List[Tuple[int, str]]] = {
    "embed":    [(0, "model")],
    "head":     [(1, "model")],
    "wq":       [(1, "model"), (2, "model")],
    "wk":       [(1, "model"), (2, "model")],
    "wv":       [(1, "model"), (2, "model")],
    "wo":       [(0, "model"), (1, "model")],
    # dense mlp
    "w_gate":   [(1, "model")],          # (D,F) -- overridden for MoE below
    "w_up":     [(1, "model")],
    "w_down":   [(0, "model")],
    "ws_gate":  [(1, "model")],
    "ws_up":    [(1, "model")],
    "ws_down":  [(0, "model")],
    # moe experts (E,D,F)/(E,F,D)
    "w_gate_moe": [(0, "model"), (2, "model")],
    "w_up_moe":   [(0, "model"), (2, "model")],
    "w_down_moe": [(0, "model"), (1, "model")],
    # ssm
    "in_proj":  [(1, "model")],
    "out_proj": [(0, "model")],
}


class P(tuple):
    """A partition spec: per tensor dim, a mesh-axis name, a tuple of names
    (major to minor) or None (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _pick(shape: Sequence[int], prefs: List[Tuple[int, str]], mesh) -> P:
    sizes = axis_sizes(mesh)
    spec: List[Optional[str]] = [None] * len(shape)
    for dim, axis in prefs:
        if axis in sizes and dim < len(shape) and shape[dim] % sizes[axis] == 0:
            spec[dim] = axis
            return P(*spec)
    return P(*spec)


def param_specs(cfg: ModelConfig, shapes, mesh):
    """Spec tree matching ``transformer.param_shapes(cfg)``."""
    from repro_torch import runtime_flags
    moe = cfg.moe is not None
    sizes = axis_sizes(mesh)
    repl_small = runtime_flags.SHARDING_OPTS.get("attn_replicate_small_heads")
    fsdp = runtime_flags.SHARDING_OPTS.get("fsdp_params")

    def _add_fsdp(spec: P, shape) -> P:
        """Variant "fsdp": additionally shard the largest free dim that
        divides "data" over it (ZeRO-3 for params and optimizer state)."""
        if not fsdp or "data" not in sizes or len(shape) < 2:
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        order = sorted(range(len(shape)), key=lambda d: -shape[d])
        for dim in order:
            if parts[dim] is None and shape[dim] % sizes["data"] == 0:
                parts[dim] = "data"
                return P(*parts)
        return spec

    def leaf_spec(name: str, shape, stacked: bool) -> P:
        key = name
        if moe and name in ("w_gate", "w_up", "w_down") and stacked:
            key = name + "_moe"
        prefs = _PARAM_RULES.get(key, [])
        if stacked:    # leading repeats dim is never sharded
            prefs = [(d + 1, a) for d, a in prefs]
        if repl_small and name in ("wq", "wk", "wv", "wo") and prefs:
            # when the head-count dim doesn't divide the model axis,
            # replicate the (small) attention projections rather than shard
            # head_dim
            head_dim_idx, axis = prefs[0]
            if shape[head_dim_idx] % sizes[axis] != 0:
                return _add_fsdp(P(*([None] * len(shape))), shape)
        return _add_fsdp(_pick(shape, prefs, mesh), shape)

    out = {}
    for name, node in shapes.items():
        if name == "layers":
            out["layers"] = [
                {k: leaf_spec(k, v, True) for k, v in unit.items()}
                for unit in node
            ]
        else:
            out[name] = leaf_spec(name, node, False)
    return out


def batch_spec(mesh, global_batch: int, ndim: int = 2, *,
               seq_dim: Optional[int] = None, seq_len: int = 0) -> P:
    """Shard the leading batch dim over ("pod","data") when divisible;
    otherwise (long_500k, batch=1) shard the sequence dim over "data"."""
    sizes = axis_sizes(mesh)
    axes = batch_axes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    spec: List = [None] * ndim
    if global_batch % size == 0:
        spec[0] = axes if len(axes) > 1 else axes[0]
    elif seq_dim is not None and seq_len and "data" in sizes and \
            seq_len % sizes["data"] == 0:
        spec[seq_dim] = "data"
    return P(*spec)


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """Spec tree matching ``models.cache.cache_struct``."""
    from repro_torch import runtime_flags
    from repro_torch.models.cache import layer_cache_struct
    sizes = axis_sizes(mesh)
    axes = batch_axes(mesh)
    bsize = 1
    for a in axes:
        bsize *= sizes[a]
    b_ax = (axes if len(axes) > 1 else axes[0]) if batch % bsize == 0 else None
    seq_ok = b_ax is None and "data" in sizes
    seq_shard = runtime_flags.SHARDING_OPTS.get("decode_cache_seq")
    repl_small = runtime_flags.SHARDING_OPTS.get("attn_replicate_small_heads")
    model = sizes["model"]

    def kv_spec(shape):   # (R,B,L,KV,hd)
        spec = [None, b_ax, None, None, None]
        if seq_ok and shape[2] % sizes["data"] == 0:
            spec[2] = "data"
        if seq_shard and shape[2] % model == 0:
            # flash-decoding layout: each rank owns an L/model slice of the
            # cache (parallel.collectives.flash_decode)
            if spec[2] == "data" and \
                    shape[2] % (sizes["data"] * model) == 0:
                spec[2] = ("data", "model")
            else:
                spec[2] = "model"
            return P(*spec)
        # KV heads over model; when heads don't divide and attn_repl is on,
        # prefer a sequence-sharded cache, else head_dim
        if shape[3] % model == 0:
            spec[3] = "model"
        elif repl_small:
            if spec[2] is None and shape[2] % model == 0:
                spec[2] = "model"
        elif shape[4] % model == 0:
            spec[4] = "model"
        return P(*spec)

    def ssm_h_spec(shape):  # (R,B,H,P,N)
        spec = [None, b_ax, None, None, None]
        if shape[2] % model == 0:
            spec[2] = "model"
        elif shape[3] % model == 0:
            spec[3] = "model"
        return P(*spec)

    def conv_spec(shape):   # (R,B,K-1,C)
        spec = [None, b_ax, None, None]
        if shape[3] % model == 0:
            spec[3] = "model"
        return P(*spec)

    quantized = bool(runtime_flags.SHARDING_OPTS.get("kv_quant"))
    layers = []
    for kind in cfg.pattern:
        entry = {}
        struct = layer_cache_struct(cfg, kind, batch, max_len,
                                    quantized=quantized)
        for name, (shape, _) in struct.items():
            full = (cfg.repeats,) + shape
            if name in ("k", "v", "k_scale", "v_scale"):
                entry[name] = kv_spec(full)
            elif name == "h":
                entry[name] = ssm_h_spec(full)
            else:
                entry[name] = conv_spec(full)
        layers.append(entry)
    return {"layers": layers}


def to_placements(spec: Sequence, mesh) -> list:
    """DTensor placements, one per mesh dim, of ``spec``: ``Shard(d)`` on
    every mesh axis that tensor dim ``d`` names, ``Replicate()`` on the
    others.  A dim over two axes gets two ``Shard(d)`` in mesh order, which
    splits it major to minor as the spec's tuple does."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def local_slices(shape: Sequence[int], mesh, placements) -> tuple:
    """The slice of a tensor of ``shape`` that this rank holds under
    ``placements`` on ``mesh``: each ``Shard(d)`` splits what is left of
    dim d into ``torch.chunk``'s pieces, mesh dims in order (major to
    minor), as DTensor does."""
    from torch.distributed.tensor import Shard
    start = [0] * len(shape)
    size = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            d, n = p.dim, mesh.size(m)
            chunk = -(-size[d] // n)
            c = mesh.get_local_rank(m)
            start[d] += min(c * chunk, size[d])
            size[d] = max(0, min(chunk, size[d] - c * chunk))
    return tuple(slice(a, a + s) for a, s in zip(start, size))


def _map_specs(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return [_map_specs(fn, v) for v in tree]


def spec_leaves(tree) -> list:
    """A spec tree's leaves in ``training.tree``'s order (dict keys
    sorted), to pair with the leaves of the tree it describes."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    return [s for v in tree for s in spec_leaves(v)]


def place(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor placed per its spec in
    ``specs`` (a tree of the same structure) on ``mesh``.  Every rank holds
    the whole tensor (made from the same seed, or a fake one) and keeps its
    own slice: nothing is sent.  A replicated leaf is the given tensor
    itself, so an update in place reaches the caller's tensor."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.training import tree as T
    return T.unflatten(tree, [
        distribute_tensor(t, mesh, to_placements(s, mesh),
                          src_data_rank=None)
        for t, s in zip(T.leaves(tree), spec_leaves(specs))])


def zeros(shape, dtype, spec, mesh):
    """A DTensor of zeros of ``shape`` placed per ``spec`` on ``mesh``,
    each rank allocating only its own slice (:func:`place` takes a whole
    tensor on every rank)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.collectives import contiguous_strides
    pl = to_placements(spec, mesh)
    local = torch.zeros([s.stop - s.start for s in
                         local_slices(shape, mesh, pl)],
                        dtype=dtype, device=mesh.device_type)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def to_named(tree, mesh):
    """A spec tree -> the same tree of placement lists on ``mesh``."""
    return _map_specs(lambda s: to_placements(s, mesh), tree)


def param_shardings(cfg: ModelConfig, mesh):
    """Placement tree of the params (``param_specs`` on ``mesh``)."""
    from repro_torch.models.transformer import param_shapes
    return to_named(param_specs(cfg, param_shapes(cfg), mesh), mesh)


def constrain(t, spec: Sequence, mesh):
    """``jax.lax.with_sharding_constraint``'s counterpart: a DTensor
    redistributed to ``spec``'s placements on ``mesh``; a plain tensor, or
    no mesh, leaves ``t`` as it is."""
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(t, DTensor):
        return t
    return t.redistribute(mesh, to_placements(spec, mesh))
