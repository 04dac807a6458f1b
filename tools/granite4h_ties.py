"""Measure what sets granite4h-pair's tie handling on the card: how far the
served router logits lie from the reference's, how close the top-10
boundary comes, and how far resolving one boundary tie the other way
moves a member's answer, by the tie's position and layer.

    python3 tools/granite4h_ties.py [--seed S] [--rows 4] [--out FILE]

Draws the configuration's trees at full size from the seed (as the
benchmark does), runs member 0 (float32) and member 1 (int8) through the
program's kernels and the family module's reference on the same rows, and
prints JSON lines: ``logit_diff`` (max |served - reference| router logit
per layer, over all tokens and over the last position), ``gaps`` (the
share of token-layers whose k-th and (k+1)-th logits lie within each
threshold, one of the two experts held), and ``flip`` (for a token at a
given position and layer, the largest change of the member's class
scores, times its combine weight, when its boundary is resolved the other
way).  Needs the card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "servebench"), str(ROOT / "src")]

import torch  # noqa: E402

from harness import cell, weights  # noqa: E402
from reference import granite4h, model  # noqa: E402

THRESHOLDS = (1e-6, 1e-5, 1e-4, 1e-3)
POSITIONS = (255, 254, 252, 248, 240, 224, 192, 128, 0)


def emit(out, **rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def served_router_logits(cfg, port, tree, dtype, tok):
    """Each MoE layer's router logits (T, E) of the program's forward."""
    from repro_torch.kernels import quant as kquant
    from repro_torch.models import moe as pmoe
    from repro_torch.models.transformer import hidden
    params = tree if dtype == "fp32" else kquant.quantize_params(tree, dtype)
    got, orig = [], pmoe._router

    def spy(x, w_router, top_k):
        got.append((x @ w_router).float())
        return orig(x, w_router, top_k)
    pmoe._router = spy
    try:
        with torch.no_grad():
            hidden(params, port, tok, use_kernel=True)
    finally:
        pmoe._router = orig
    return got


def reference_router_logits(cfg, layers, w, tok):
    got, orig = [], granite4h.moe

    def spy(c, p, h, layer=0, ties=None):
        got.append(model.mm_einsum("td,de->te", h.reshape(-1, h.shape[-1]),
                                   p["router"]))
        return orig(c, p, h, layer, ties)
    granite4h.moe = spy
    try:
        lg = granite4h.member_logits(cfg, layers, w, tok)
    finally:
        granite4h.moe = orig
    return got, lg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 29001)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--flip-rows", type=int, default=2)
    ap.add_argument("--diagnose", action="store_true",
                    help="compare the program's routing with the "
                         "reference's, token by token, in served batches")
    ap.add_argument("--traffic", type=int, default=0,
                    help="with --diagnose: the rows of the closed mix's "
                         "first N requests of each of its 8 callers at "
                         "--seed, as a run of the cell draws them")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = cell.load_config("granite4h-pair")
    if args.diagnose:
        tok = None
        if args.traffic:
            from harness.traffic import tokens
            tok = torch.from_numpy(__import__("numpy").concatenate([
                tokens(args.seed, c + 1, k, 16, cfg["max_seq"],
                       cfg["vocab_size"])
                for c in range(8) for k in range(args.traffic)])).to(dev)
        diagnose(cfg, args.seed, args.rows, dev, args.out, tok)
    else:
        measure(cfg, args.seed, args.rows, args.flip_rows, dev, args.out)
    return 0


def _held_sets(idx, first, held):
    """(T, k) expert choices -> (T, held) bool: which held experts each
    token chose."""
    local = idx - first
    out = torch.zeros(idx.shape[0], held, dtype=torch.bool,
                      device=idx.device)
    ok = (local >= 0) & (local < held)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(
        idx)
    out[rows[ok], local[ok]] = True
    return out


def diagnose(cfg, seed, rows, dev, out="", tok=None):
    """Each member on ``rows`` rows, the program in its served batches: the
    token-layers where its held-expert choices differ from the
    reference's (layer, position, the reference's boundary gap), and each
    row's largest change of class scores times the combine weight."""
    from repro_torch.kernels import quant as kquant
    from repro_torch.models import moe as pmoe
    from repro_torch.models.transformer import hidden, logits_from_hidden
    ports = cell.port_models(cfg)
    trees = weights.make_trees(cfg, seed, dev)
    if tok is None:
        g = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
        tok = torch.randint(0, cfg["vocab_size"], (rows, cfg["max_seq"]),
                            generator=g, device=dev, dtype=torch.int32)
    rows = tok.shape[0]
    m = cfg["moe"]
    k, first, held = m["top_k"], m["first_expert"], m["experts_held"]
    s = cfg["max_seq"]
    wsum = sum(x["weight"] for x in cfg["members"])
    for i, mem in enumerate(cfg["members"]):
        bsz = cfg["allocation"][0][i]
        params = trees[i] if mem["dtype"] == "fp32" else \
            kquant.quantize_params(trees[i], mem["dtype"])
        served, lg_served, orig = [], [], pmoe._router

        def spy(x, w_router, top_k):
            r = orig(x, w_router, top_k)
            served[-1].append(r[1])
            return r
        pmoe._router = spy
        try:
            with torch.no_grad():
                for lo in range(0, rows, bsz):
                    served.append([])
                    h = hidden(params, ports[i], tok[lo:lo + bsz],
                               use_kernel=True)
                    lg_served.append(logits_from_hidden(
                        params, ports[i], h[:, -1])[:, :cfg["vocab_size"]])
        finally:
            pmoe._router = orig
        del params
        refd, lg_ref, origm = [], [], granite4h.moe

        def rspy(c, p, hh, layer=0, ties=None):
            x = hh.reshape(-1, hh.shape[-1])
            lgt = model.mm_einsum("td,de->te", x, p["router"])
            srt, idx = torch.sort(lgt, dim=-1, descending=True, stable=True)
            refd[-1].append((idx[:, :k], srt[:, k - 1] - srt[:, k]))
            return origm(c, p, hh, layer, ties)
        granite4h.moe = rspy
        w = model.Weights(trees[i], mem["dtype"] == "int8")
        sites = {}
        try:
            with torch.no_grad(), model.precision("fp32", dev):
                for lo in range(0, rows, 16):
                    refd.append([])
                    ties = granite4h.Ties(cfg)
                    lg_ref.append(granite4h.member_logits(
                        cfg, mem["num_layers"], w, tok[lo:lo + 16].long(),
                        ties))
                    for r, *where in ties.sites:
                        sites.setdefault(lo + r, []).append((lo + r, *where))
        finally:
            granite4h.moe = origm
        lg_served, lg_ref = torch.cat(lg_served), torch.cat(lg_ref)
        n_layers = mem["num_layers"]
        sv = [torch.cat([served[b][l].reshape(-1, s, k)
                         for b in range(len(served))])
              for l in range(n_layers)]
        rf = [torch.cat([refd[b][l][0].reshape(-1, s, k)
                         for b in range(len(refd))]) for l in range(n_layers)]
        gp = [torch.cat([refd[b][l][1].reshape(-1, s)
                         for b in range(len(refd))]) for l in range(n_layers)]
        scale = mem["weight"] / wsum
        for row in range(rows):
            diffs = []
            for l in range(n_layers):
                a = _held_sets(sv[l][row], first, held)
                b = _held_sets(rf[l][row], first, held)
                for p in (a != b).any(-1).nonzero()[:, 0].tolist():
                    diffs.append([l, p, float(gp[l][row, p])])
            change = scale * float((lg_served[row] - lg_ref[row]).abs().max())
            # where it moved: the nearest of the row's alternates (its
            # block's sites resolved in passes of the block's size)
            nearest = None
            if change > 1e-4 and sites.get(row):
                lo = row - row % 16
                with torch.no_grad(), model.precision("fp32", dev):
                    alts = granite4h.resolved(cfg, n_layers, w, tok.long(),
                                              sites[row], min(16, rows - lo))
                nearest = min(scale * float((lg_served[row] - a).abs().max())
                              for a in alts)
            emit(out, member=i, what="diagnose", row=row, change=change,
                 flips=diffs, nearest_alt=nearest,
                 sites=[site[1:3] for site in sites.get(row, [])])


def measure(cfg, seed, rows, flip_rows, dev, out=""):
    """The readings above for ``cfg``'s members on ``rows`` rows drawn
    from ``seed``, flips in the first ``flip_rows``."""
    ports = cell.port_models(cfg)
    trees = weights.make_trees(cfg, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
    tok = torch.randint(0, cfg["vocab_size"], (rows, cfg["max_seq"]),
                        generator=g, device=dev, dtype=torch.int32)
    m = cfg["moe"]
    k, first, held = m["top_k"], m["first_expert"], m["experts_held"]
    s = cfg["max_seq"]
    for i, mem in enumerate(cfg["members"]):
        int8 = mem["dtype"] == "int8"
        w = model.Weights(trees[i], int8)
        t = time.perf_counter()
        served = served_router_logits(cfg, ports[i], trees[i], mem["dtype"],
                                      tok)
        with torch.no_grad(), model.precision("fp32", dev):
            refl, base = reference_router_logits(cfg, mem["num_layers"], w,
                                                 tok.long())
        diffs, last, near = [], [], {x: 0 for x in THRESHOLDS}
        for a, b in zip(served, refl):
            d = (a - b).abs()
            diffs.append(float(d.max()))
            last.append(float(d.reshape(-1, s, d.shape[-1])[:, -1].max()))
            srt, idx = torch.sort(b, dim=-1, descending=True, stable=True)
            gap = srt[:, k - 1] - srt[:, k]
            pair = idx[:, k - 1:k + 1] - first
            hit = ((pair >= 0) & (pair < held)).any(-1)
            for x in THRESHOLDS:
                near[x] += int(((gap < x) & hit).sum())
        total = len(refl) * tok.numel()
        emit(out, member=i, what="logit_diff", max=max(diffs),
             last_max=max(last), by_layer=diffs,
             logit_abs_max=max(float(b.abs().max()) for b in refl),
             seconds=time.perf_counter() - t)
        emit(out, member=i, what="gaps", token_layers=total,
             near={str(x): near[x] / total for x in THRESHOLDS})
        # resolve one boundary the other way at a token of each position,
        # at a few layers, for the first rows
        scale = mem["weight"] / sum(x["weight"] for x in cfg["members"])
        for row in range(min(flip_rows, rows)):
            for layer in (0, mem["num_layers"] // 2, mem["num_layers"] - 1):
                srt, idx = torch.sort(refl[layer], dim=-1, descending=True,
                                      stable=True)
                pair = idx[:, k - 1:k + 1] - first
                hit = ((pair >= 0) & (pair < held)).any(-1).reshape(-1, s)
                for pos in POSITIONS:
                    # the nearest token at or before pos whose boundary
                    # involves a held expert
                    cands = hit[row, :pos + 1].nonzero()[:, 0]
                    if not cands.numel():
                        continue
                    p = int(cands[-1])
                    t = time.perf_counter()
                    token = row * s + p
                    experts = idx[token, :k].clone()
                    experts[k - 1] = idx[token, k]
                    with torch.no_grad(), model.precision("fp32", dev):
                        alt = granite4h.resolved(
                            cfg, mem["num_layers"], w, tok.long(),
                            [(row, layer, p, tuple(experts.tolist()))],
                            rows)[0][None]
                    a0 = granite4h._as_combined(mem, alt)
                    b0 = granite4h._as_combined(mem, base[row:row + 1])
                    emit(out, member=i, what="flip", row=row,
                         layer=layer, position=p,
                         gap=float(srt[row * s + p, k - 1] -
                                   srt[row * s + p, k]),
                         y_change=scale * float((a0 - b0).abs().max()),
                         raw_change=scale * float(
                             (alt - base[row:row + 1]).abs().max()),
                         seconds=time.perf_counter() - t)
        del served, refl


if __name__ == "__main__":
    sys.exit(main())
