"""Step functions, their inputs as fake tensors, and the sharded trace the
dry-run reads (the JAX package's ``launch/steps.py``).

Three step kinds, chosen by the input shape's ``kind``:
  * train   -- the full AdamW ``train_step`` (remat'd units)
  * prefill -- prompt pass returning last-token logits and the filled cache
  * decode  -- ONE new token against a seq_len KV cache

:func:`lower_step` is the counterpart of the JAX package's ``jit(...).lower``
on a mesh: under ``FakeTensorMode`` (no memory is allocated) it places the
params, optimizer state, batch and cache as DTensors per the sharding rules
on a ``DeviceMesh`` and runs the step once under
``hlo_analysis.record``.  PyTorch has no ``compile()`` of such a step, so
the traced run -- every op of every rank-local shard and every collective
DTensor needed -- is the dry-run's proof that the step shards, and the
record it returns stands in for JAX's ``Lowered``.  The step runs the plain
path (``use_kernel=False``), as the JAX dry-run lowers the plain path too.

The record's bytes are one rank's, in the field names of XLA's memory
analysis and with their meaning: arguments and outputs (local shards),
``temp`` -- the peak of the live bytes of the storages the step allocates,
its outputs left out, as XLA's temp holds neither arguments nor outputs --
and ``alias``, the outputs that share an argument's storage (the AdamW
update runs in place).  So ``argument + output - alias + temp`` bounds the
rank's peak for one step.  A train step's outputs are its arguments,
updated in place, and a few scalars, so there ``argument + temp`` is the
peak; the optimizer's state is an argument (``optimizer.init`` makes it
before the first step), so every training step has it, the first too.  The
prefill step makes its zero cache inside, as the JAX step does: the cache
is an output, not an argument.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import hlo_analysis
from repro_torch.models import cache as cache_mod
from repro_torch.models import decode_step as model_decode
from repro_torch.models import prefill as model_prefill
from repro_torch.models.attention import slot_valid
from repro_torch.models.transformer import param_shapes
from repro_torch.parallel import sharding as shd
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as T
from repro_torch.training.train_loop import make_train_step


# ---------------------------------------------------------------------------
# input specs (meta or fake tensors; no allocation)
# ---------------------------------------------------------------------------
def param_struct(cfg: ModelConfig, dtype=torch.bfloat16, device="meta"):
    """The params as empty tensors of their shapes (meta unless made under
    ``FakeTensorMode`` on another device)."""
    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return torch.empty(node, dtype=dtype, device=device)
    return build(param_shapes(cfg))


def opt_state_struct(params_struct) -> opt.AdamWState:
    f32 = lambda t: T.unflatten(t, [torch.empty(x.shape, dtype=torch.float32,
                                                device=x.device)
                                    for x in T.leaves(t)])
    dev = T.leaves(params_struct)[0].device
    return opt.AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          f32(params_struct), f32(params_struct))


def input_specs(cfg: ModelConfig, shape_name: str, *,
                param_dtype=torch.bfloat16, device="meta") -> Dict[str, Any]:
    """All step inputs for (cfg, shape) as empty tensors."""
    from repro_torch import runtime_flags
    sh = INPUT_SHAPES[shape_name]
    b, s, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    i32 = dict(dtype=torch.int32, device=device)
    specs: Dict[str, Any] = {"params": param_struct(cfg, param_dtype, device)}
    frontend = (torch.empty((b, cfg.frontend_tokens, cfg.fdim),
                            dtype=param_dtype, device=device)
                if cfg.frontend_tokens else None)
    if kind == "train":
        specs["opt_state"] = opt_state_struct(specs["params"])
        specs["batch"] = {"tokens": torch.zeros((b, s), **i32),
                          "labels": torch.zeros((b, s), **i32)}
        if frontend is not None:
            specs["batch"]["frontend"] = frontend
    elif kind == "prefill":
        specs["tokens"] = torch.zeros((b, s), **i32)
        if frontend is not None:
            specs["frontend"] = frontend
    elif kind == "decode":
        specs["cache"] = cache_mod.cache_struct(
            cfg, b, s, param_dtype,
            quantized=bool(runtime_flags.SHARDING_OPTS.get("kv_quant")),
            device=device)
        specs["token"] = torch.zeros((b, 1), **i32)
        specs["pos"] = s - 1
    else:
        raise ValueError(kind)
    return specs


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------
def build_train_step(cfg: ModelConfig, *, remat: bool = True):
    return make_train_step(cfg, opt.AdamWConfig(), remat=remat)


def build_prefill_step(cfg: ModelConfig, max_len: int, mesh):
    """The prompt pass, which makes its zero cache inside, as the JAX
    step does: each rank allocates its slice of the cache placed per
    ``cache_specs`` on ``mesh`` (``prefill``'s own cache would be whole on
    every rank)."""
    def step(params, tokens, frontend=None):
        b = tokens.shape[0]
        specs = shd.cache_specs(cfg, mesh, b, max_len)["layers"]
        cache = {"layers": [
            {name: shd.zeros((cfg.repeats,) + shape, dt, spec[name], mesh)
             for name, (shape, dt) in cache_mod.layer_cache_struct(
                 cfg, kind, b, max_len, params["embed"].dtype).items()}
            for kind, spec in zip(cfg.pattern, specs)]}
        return model_prefill(params, cfg, tokens, max_len, frontend,
                             cache=cache)
    return step


def build_decode_step(cfg: ModelConfig):
    def step(params, cache, token, pos):
        return model_decode(params, cfg, cache, token, pos)
    return step


# ---------------------------------------------------------------------------
# the sharded trace: the (arch x shape x mesh) run the dry-run reads
# ---------------------------------------------------------------------------
@dataclass
class Traced:
    """What :func:`lower_step` returns in place of JAX's ``Lowered``; the
    bytes are this rank's (see the module docstring)."""
    kind: str
    trace: List[hlo_analysis.TracedOp] = field(repr=False)
    argument_bytes: int        # this rank's shards of the step's inputs
    output_bytes: int          # ... and of its outputs
    temp_bytes: int            # peak live bytes the step allocates, outputs out
    alias_bytes: int           # outputs in an argument's storage

    def memory_analysis(self) -> Dict[str, int]:
        """XLA's field names; ``generated_code_size_in_bytes`` has no
        counterpart, as eager PyTorch runs no compiled program."""
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": self.temp_bytes,
                "alias_size_in_bytes": self.alias_bytes}


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in T.leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += hlo_analysis.shape_bytes(t.shape, t.dtype)
    return total


def _alias_bytes(out, args) -> int:
    """Bytes of the outputs whose storage is an argument's."""
    inputs = hlo_analysis.storage_ids(args)
    return sum(_local_bytes(t) for t in T.leaves(out)
               if isinstance(t, torch.Tensor)
               and hlo_analysis.storage_ids(t) <= inputs)


def lower_step(cfg: ModelConfig, shape_name: str, mesh, *,
               param_dtype=torch.bfloat16, remat: bool = True,
               fake: bool = True) -> Traced:
    """Trace the (cfg, shape) step on ``mesh`` (a ``DeviceMesh``), sharded
    by the rules, under ``FakeTensorMode``; see the module docstring.
    ``fake=False`` runs the same step on real (uninitialized) tensors of
    the mesh's device, which the tests hold the fake trace's bytes to."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    sh = INPUT_SHAPES[shape_name]
    b, s, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    device = mesh.device_type
    pspecs = shd.param_specs(cfg, param_shapes(cfg), mesh)
    bspec = {"tokens": shd.batch_spec(mesh, b, 2),
             "labels": shd.batch_spec(mesh, b, 2),
             "frontend": shd.batch_spec(mesh, b, 3)}
    mode = FakeTensorMode() if fake else contextlib.nullcontext()
    with mode, implicit_replication():
        specs = input_specs(cfg, shape_name, param_dtype=param_dtype,
                            device=device)
        one = lambda t, spec: shd.place([t], [spec], mesh)[0]
        params = shd.place(specs["params"], pspecs, mesh)
        if kind == "train":
            ost = specs["opt_state"]
            state = opt.AdamWState(ost.step, shd.place(ost.mu, pspecs, mesh),
                                   shd.place(ost.nu, pspecs, mesh))
            batch = {k: one(v, bspec[k]) for k, v in specs["batch"].items()}
            args = (params, state, batch)
            fn = build_train_step(cfg, remat=remat)
        elif kind == "prefill":
            front = specs.get("frontend")
            args = (params, one(specs["tokens"], bspec["tokens"]),
                    None if front is None else one(front, bspec["frontend"]))
            fn = build_prefill_step(cfg, s, mesh)
        elif kind == "decode":
            args = (params, shd.place(specs["cache"],
                                      shd.cache_specs(cfg, mesh, b, s), mesh),
                    one(specs["token"], bspec["tokens"]), specs["pos"])
            fn = build_decode_step(cfg)
        else:
            raise ValueError(kind)
        # the decode masks are cached per (L, pos, window, device): a mask
        # made under another trace's fake mode cannot be reused in this one
        slot_valid.cache_clear()
        try:
            out, trace, memory = hlo_analysis.record_with_memory(fn, *args)
        finally:
            slot_valid.cache_clear()
        return Traced(kind, trace, _local_bytes(list(args)),
                      _local_bytes(list(out)),
                      memory.peak_without(hlo_analysis.storage_ids(out)),
                      _alias_bytes(out, list(args)))
