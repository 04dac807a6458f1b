"""Training launcher of the port.

    python -m repro_torch.launch.train --arch qwen3-1.7b --shape train_4k \\
        [--multi-pod] [--steps N] [--cpu] [--ckpt-dir DIR]
    torchrun --nproc-per-node 8 -m repro_torch.launch.train ...
    python -m repro_torch.launch.train --arch llama3-8b --dry-run
    python -m repro_torch.launch.train --host-demo --steps 20 [--cpu]

The pod path trains the full config at the global batch and sequence of
``--shape`` (``configs.INPUT_SHAPES``) on a ``DeviceMesh`` over the process
group it joins: the one ``torchrun`` describes, or a group of one when no
``WORLD_SIZE`` is set; ``nccl`` on the card, ``gloo`` with ``--cpu``.  A
group of 256 ranks (512 with ``--multi-pod``) gets the production mesh,
any other the (ranks, 1) host mesh over ("data", "model").  Params and
AdamW state are placed per ``parallel.sharding.param_specs``, each rank
keeping its shard, and each step's global batch goes through
``data.pipeline.shard_batch``; the step is ``make_train_step`` with remat
on DTensors (gradients reduced onto the params' placements).  The data is
the ``copy`` task of ``SyntheticLM``: the JAX launcher's ``ngram`` task
builds a (vocab, vocab) table, 184.7 GB at qwen3's vocabulary.  Rank 0
prints the losses and saves the gathered params with ``--ckpt-dir``.

``--dry-run`` traces the step on the production mesh with no devices
(``launch.dryrun.run_one``).  ``--host-demo`` trains the reduced config at
batch 8, seq 64 on the n-gram task on one device, without a process group.
Every path runs with remat and no kernels (the kernels have no backward).
"""
from __future__ import annotations

import argparse
import time


def pod_mesh(multi_pod: bool):
    """The production mesh when the group has its size, else the host mesh
    (ranks, 1); ``--multi-pod`` needs the 512-rank group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (PRODUCTION_SHAPES, make_host_mesh,
                                         make_production_mesh)
    sizes = PRODUCTION_SHAPES[multi_pod][0]
    n = 1
    for s in sizes:
        n *= s
    world = dist.get_world_size()
    if world == n:
        return make_production_mesh(multi_pod=multi_pod)
    if multi_pod:
        raise SystemExit(f"--multi-pod needs {n} ranks; the group has "
                         f"{world}")
    return make_host_mesh(world, 1)


def _scalar(v) -> float:
    from torch.distributed.tensor import DTensor
    return float(v.full_tensor() if isinstance(v, DTensor) else v)


def train_pod(arch: str, shape: str, *, steps: int, multi_pod: bool = False,
              cpu: bool = False, ckpt_dir: str = "", seed: int = 0,
              log=print):
    """The pod path (module docstring) -> one {"loss", "s"} per step: the
    step's loss and its seconds, the host clock around the step and the
    read of its loss (which waits for the device)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.launch.mesh import batch_axes, join_process_group
    from repro_torch.models import init_params
    from repro_torch.models.transformer import param_shapes
    from repro_torch.parallel import sharding as shd
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training import tree as T
    from repro_torch.training.train_loop import make_train_step

    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("the pod path: no CUDA device is available "
                           "(pass --cpu to train on the host)")
    join_process_group(cpu=cpu)
    mesh = pod_mesh(multi_pod)
    cfg = get_config(arch)
    sh = INPUT_SHAPES[shape]
    batch_size, seq = sh["global_batch"], sh["seq_len"]
    params = shd.place(init_params(cfg, seed, mesh.device_type),
                       shd.param_specs(cfg, param_shapes(cfg), mesh), mesh)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt.AdamWConfig(total_steps=steps),
                              remat=True)
    it = SyntheticLM(cfg.vocab_size, seq, task="copy", seed=seed).iterator(
        batch_size, cfg)
    bax = batch_axes(mesh) or ("data",)
    rank0 = dist.get_rank() == 0
    history = []
    with implicit_replication():
        for i in range(steps):
            batch = shard_batch(next(it), mesh, bax)
            t0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch)
            loss = _scalar(metrics["loss"])
            history.append({"loss": loss, "s": time.perf_counter() - t0})
            if rank0:
                log(f"step {i:4d} loss {loss:.6f} "
                    f"({history[-1]['s']:.2f}s)")
        if ckpt_dir:
            gathered = T.unflatten(params, [p.full_tensor()
                                            for p in T.leaves(params)])
            if rank0:
                ckpt.save(ckpt_dir, steps, gathered)
                log(f"checkpoint saved to {ckpt_dir}")
    return history


def main(argv=None):
    from repro_torch.configs import INPUT_SHAPES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--host-demo", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.shape not in INPUT_SHAPES:
        ap.error(f"--shape {args.shape!r}: have {sorted(INPUT_SHAPES)}")

    if args.dry_run:
        from repro_torch.launch.dryrun import run_one
        rec = run_one(args.arch, args.shape,
                      "multi" if args.multi_pod else "single")
        return 0 if rec["ok"] else 1

    if not args.host_demo:
        train_pod(args.arch, args.shape, steps=args.steps,
                  multi_pod=args.multi_pod, cpu=args.cpu,
                  ckpt_dir=args.ckpt_dir, log=lambda m: print(m, flush=True))
        return 0

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config(args.arch).reduced()
    batch_size, seq = 8, 64
    params = init_params(cfg, 0, "cpu" if args.cpu else "cuda")
    state = opt.init(params)
    ocfg = opt.AdamWConfig(total_steps=args.steps)
    step_fn = make_train_step(cfg, ocfg, remat=True)
    it = SyntheticLM(cfg.vocab_size, seq, task="ngram").iterator(batch_size,
                                                                 cfg)
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, next(it))
        loss = float(metrics["loss"])
        print(f"step {i:4d} loss {loss:.4f} "
              f"({time.perf_counter() - t0:.2f}s)", flush=True)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, params)
        print("checkpoint saved to", args.ckpt_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
