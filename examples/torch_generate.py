"""Autoregressive generation in the PyTorch port: train a tiny model on
repeated text (no kernels: they have no backward), then decode greedily from
a prompt through ``prefill`` + ``decode_step`` with ``use_kernel=True`` (on
the card: the decode-attention kernel, and the SSD scan in an SSM or hybrid
model's prefill), optionally with the int8 KV cache.

Run:  PYTHONPATH=src python examples/torch_generate.py [--arch gemma3-1b]
          [--steps 150] [--int8-cache] [--tokens 80] [--cpu]
On the CUDA card unless ``--cpu`` is given (then the kernels' plain
versions run).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import tokenizer as tok  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.train_loop import train  # noqa: E402

TEXT = ("the quick brown fox jumps over the lazy dog. "
        "pack my box with five dozen liquor jugs. ") * 40


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--tokens", type=int, default=80)
    ap.add_argument("--int8-cache", action="store_true")
    ap.add_argument("--prompt", default="the quick brown ")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    device = torch.device("cpu" if args.cpu else "cuda")
    print(f"model: {cfg.name} ({cfg.param_count():,} params), "
          f"int8 cache: {args.int8_cache}, device: {device}")

    corpus = tok.TextCorpus(TEXT, seq_len=64, vocab_size=cfg.vocab_size)
    params = init_params(cfg, 0, device)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)
    params, hist = train(cfg, params, corpus.iterator(16), ocfg,
                         steps=args.steps, log_every=50,
                         callback=lambda m: print(
                             f"  step {m['step']:4d} loss {m['loss']:.3f}"))

    prompt_ids = np.asarray(tok.encode(args.prompt, bos=False),
                            np.int32) % cfg.vocab_size
    max_len = len(prompt_ids) + args.tokens
    ops.reset_counts()
    with torch.no_grad():
        tokens = torch.from_numpy(prompt_ids)[None, :].to(device)
        logits, cache = prefill(params, cfg, tokens, max_len,
                                use_kernel=True,
                                quantize_cache=args.int8_cache)
        out = list(prompt_ids)
        tok_next = int(logits[0].argmax())
        for _ in range(args.tokens):
            out.append(tok_next)
            logits, cache = decode_step(
                params, cfg, cache,
                torch.tensor([[tok_next]], dtype=torch.int32, device=device),
                len(out) - 1, use_kernel=True)
            tok_next = int(logits[0].argmax())

    print("\nprompt:    " + repr(args.prompt))
    print("generated: " + repr(tok.decode(out[len(prompt_ids):])))
    print("kernel launches:", ops.kernel_launches(), "plain calls:",
          ops.plain_calls())


if __name__ == "__main__":
    main()
