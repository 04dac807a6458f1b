"""Training launcher of the port.

    python -m repro_torch.launch.train --host-demo --steps 20 [--cpu]
        [--arch qwen3-1.7b] [--ckpt-dir DIR]

``--host-demo`` trains the reduced config at batch 8, seq 64 on the n-gram
task, on the card (``--cpu``: on the CPU), with remat and no kernels (the
kernels have no backward), and saves the params to ``--ckpt-dir`` in the
JAX package's checkpoint layout.  The JAX launcher's pod path (the full
config on the production mesh with sharded batches, with its ``--shape``
and ``--multi-pod``) and ``--dry-run`` wait for the port's parallel and
analysis tooling (ROADMAP Queue 1 item 15); asking for either exits with
that message, and the two pod flags are not accepted until then.
"""
from __future__ import annotations

import argparse
import time

_ITEM_15 = ("waits for the port's parallel and analysis tooling "
            "(ROADMAP Queue 1 item 15); use --host-demo")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--host-demo", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise SystemExit(f"--dry-run {_ITEM_15}")
    if not args.host_demo:
        raise SystemExit(f"the pod path (full config, production mesh) "
                         f"{_ITEM_15}")

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
