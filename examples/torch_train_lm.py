"""Training example of the PyTorch port: train a reduced assigned-pool LM for
a few hundred steps on the synthetic bigram task, with checkpointing in the
JAX package's layout (``examples/train_lm.py`` can resume from it, and this
script from one of that example's).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --arch qwen3-1.7b \
          --steps 300 --d-model 256 [--resume] [--cpu]
On the CUDA card unless ``--cpu`` is given; no kernels (they have no
backward).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import PrefetchIterator, SyntheticLM  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.train_loop import train  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced(layers=args.layers,
                                        d_model=args.d_model)
    print(f"training {cfg.name}: {cfg.param_count():,} params, "
          f"{cfg.num_layers}L d={cfg.d_model}")
    params = init_params(cfg, 0, "cpu" if args.cpu else "cuda")
    start_step = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        params = ckpt.restore(args.ckpt_dir, params)
        start_step = ckpt.latest_step(args.ckpt_dir)
        print(f"resumed from step {start_step}")

    data = PrefetchIterator(
        SyntheticLM(cfg.vocab_size, args.seq, task="ngram").iterator(
            args.batch, cfg))
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=20,
                           total_steps=args.steps)

    def log(m):
        print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}  "
              f"({m['elapsed_s']:.0f}s)")

    params, hist = train(cfg, params, data, ocfg, steps=args.steps,
                         log_every=20, callback=log)
    path = ckpt.save(args.ckpt_dir, start_step + args.steps, params)
    print(f"final loss {hist[-1]['loss']:.4f}; checkpoint -> {path}")
    data.close()


if __name__ == "__main__":
    main()
