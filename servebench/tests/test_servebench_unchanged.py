"""The family modules change nothing that the accepted cells read: the trees
drawn, the FLOPs counted, the reference's answer and the comparison are
those of the harness before it asked a configuration's module, whose
functions are frozen here."""
from typing import Dict, Tuple

import pytest
import torch

from harness import cell, check, family, weights, work
from reference import model
from servebench_fixtures import reduce_cfg

CONFIGS = ["mamba2-pair", "hymba-pair"]


# ------------------------------------------------- frozen: harness/weights.py
def frozen_layer_shapes(cfg: dict, kind: str) -> Dict[str, Tuple[int, ...]]:
    d = cfg["d_model"]
    shapes: Dict[str, Tuple[int, ...]] = {"pre_norm": (d,)}
    if kind in ("attn", "swa", "hybrid"):
        h, kv = cfg["num_heads"], cfg["num_kv_heads"]
        hd = cfg["head_dim"] or d // h
        shapes.update(wq=(d, h, hd), wk=(d, kv, hd), wv=(d, kv, hd),
                      wo=(h, hd, d))
    if kind in ("ssm", "hybrid"):
        sc = cfg["ssm"]
        di = sc["expand"] * d
        nh = di // sc["head_dim"]
        shapes.update(in_proj=(d, 2 * di + 2 * sc["d_state"] + nh),
                      conv_w=(sc["d_conv"], di + 2 * sc["d_state"]),
                      dt_bias=(nh,), A_log=(nh,), D=(nh,), norm=(di,),
                      out_proj=(di, d))
    if cfg["d_ff"] > 0:
        f = cfg["d_ff"]
        shapes.update(mlp_norm=(d,), w_gate=(d, f), w_up=(d, f),
                      w_down=(f, d))
    return shapes


def frozen_tree_shapes(cfg: dict, layers: int):
    pattern = cfg["pattern"]
    reps = layers // len(pattern)
    d, vp = cfg["d_model"], weights.padded_vocab(cfg)
    tree = {"embed": (vp, d), "final_norm": (d,)}
    if not cfg["tie_embeddings"]:
        tree["head"] = (d, vp)
    tree["layers"] = [{k: (reps,) + v for k, v in
                       frozen_layer_shapes(cfg, kind).items()}
                      for kind in pattern]
    return tree


# ---------------------------------------------------- frozen: harness/work.py
def frozen_member_flops_per_row(cfg: dict, layers: int, s: int) -> float:
    d = cfg["d_model"]
    pattern = cfg["pattern"]
    total = 0.0
    for r in range(layers):
        kind = pattern[r % len(pattern)]
        if kind in ("attn", "swa", "hybrid"):
            h, kv = cfg["num_heads"], cfg["num_kv_heads"]
            hd = cfg["head_dim"] or d // h
            total += 2 * s * d * hd * (2 * h + 2 * kv)
            window = cfg["sliding_window"] if kind != "attn" else 0
            total += work.flash_call(1, s, h, kv, hd, window)[1]
        if kind in ("ssm", "hybrid"):
            di, n, p, h, k = work.ssm_dims(cfg)
            total += 2 * s * d * (2 * di + 2 * n + h)
            total += 2 * s * k * (di + 2 * n)
            total += work.ssd_call(1, s, h, p, n, cfg["ssm"]["chunk"])[1]
            total += 2 * s * di * d
        if cfg["d_ff"] > 0:
            total += 3 * 2 * s * d * cfg["d_ff"]
    return total + 2 * d * cfg["vocab_size"]


def frozen_pair_flops_per_row(cfg: dict) -> float:
    return sum(frozen_member_flops_per_row(cfg, m["num_layers"],
                                           cfg["max_seq"])
               for m in cfg["members"])


# --------------------------------------------------- frozen: harness/check.py
def frozen_compare(Y, ref, members):
    Y_ref = ref["Y"]
    diff = Y.double() - Y_ref.double()
    int8 = [i for i, m in enumerate(members) if m["dtype"] == "int8"]
    if len(int8) == 1:
        i = int8[0]
        step = (ref["weights"][i] * ref["scales"][i]).double()[:, None]
        k = torch.round(diff / step)
    else:
        step, k = torch.zeros_like(diff[:, :1]), torch.zeros_like(diff)
    one = k.abs() <= 1
    err = torch.where(one, (diff - k * step).abs(), diff.abs())
    scale = max(1.0, float(Y_ref.abs().max()))
    return {"max_err": float(err.max()) / scale,
            "flip_share": float(((k != 0) & one).double().mean())}


# ------------------------------------------ frozen: reference.model.combined
def frozen_combined(cfg, trees, tokens, *, block_rows=16, prec="fp32"):
    members = cfg["members"]
    wsum = sum(m["weight"] for m in members)
    wts = [m["weight"] / wsum for m in members]
    out, scales = [], {i: [] for i, m in enumerate(members)
                       if m["dtype"] == "int8"}
    with torch.no_grad(), model.precision(prec, tokens.device):
        for lo in range(0, tokens.shape[0], block_rows):
            tok = tokens[lo:lo + block_rows]
            y = None
            for i, (m, tree) in enumerate(zip(members, trees)):
                lg = model.member_logits(
                    cfg, m["num_layers"],
                    model.Weights(tree, m["dtype"] == "int8"), tok)
                if m["dtype"] == "int8":
                    q, s = model.quantize_rows(lg)
                    lg = q * s
                    scales[i].append(s[:, 0])
                y = wts[i] * lg if y is None else y + wts[i] * lg
            out.append(y)
    return {"Y": torch.cat(out),
            "scales": {i: torch.cat(v) for i, v in scales.items()},
            "weights": wts}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 7])
@pytest.mark.parametrize("name", CONFIGS)
def test_trees_are_todays(monkeypatch, name, seed):
    cfg = reduce_cfg(cell.load_config(name))
    now = weights.make_trees(cfg, seed, "cpu")
    monkeypatch.setattr(weights, "tree_shapes", frozen_tree_shapes)
    then = weights.make_trees(cfg, seed, "cpu")
    for a, b in zip(now, then):
        la, lb = _leaves(a), _leaves(b)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (p, x), (_, y) in zip(la, lb):
            assert torch.equal(x, y), p


@pytest.mark.parametrize("name", CONFIGS)
def test_shapes_are_todays(name):
    cfg = cell.load_config(name)
    for m in cfg["members"]:
        assert weights.tree_shapes(cfg, m["num_layers"]) == \
            frozen_tree_shapes(cfg, m["num_layers"])


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", CONFIGS)
def test_flops_are_todays_to_the_bit(name, reduced):
    cfg = cell.load_config(name)
    cfg = reduce_cfg(cfg) if reduced else cfg
    got, want = work.pair_flops_per_row(cfg), frozen_pair_flops_per_row(cfg)
    assert got.hex() == want.hex()


@pytest.mark.parametrize("name", CONFIGS)
def test_combined_is_todays(name):
    cfg = reduce_cfg(cell.load_config(name))
    trees = weights.make_trees(cfg, 13, "cpu")
    g = torch.Generator().manual_seed(4)
    tok = torch.randint(0, cfg["vocab_size"], (5, cfg["max_seq"]),
                        generator=g, dtype=torch.int32)
    got = family.module(cfg).combined(cfg, trees, tok, block_rows=2)
    want = frozen_combined(cfg, trees, tok, block_rows=2)
    assert torch.equal(got["Y"], want["Y"])
    assert got["scales"].keys() == want["scales"].keys()
    for i in want["scales"]:
        assert torch.equal(got["scales"][i], want["scales"][i])
    assert got["weights"] == want["weights"]
    assert "alternates" not in got


@pytest.mark.parametrize("dtypes", [("fp32", "int8"), ("fp32", "fp32"),
                                    ("int8", "int8")])
def test_compare_is_todays_to_the_bit(dtypes):
    """Elements on a neighbouring code, two codes off, and plain errors."""
    g = torch.Generator().manual_seed(9)
    members = [{"dtype": d} for d in dtypes]
    Y_ref = torch.randn(6, 40, generator=g) * 3
    scales = {i: torch.rand(6, generator=g) * 0.05 + 0.01
              for i, d in enumerate(dtypes) if d == "int8"}
    ref = {"Y": Y_ref, "scales": scales, "weights": [0.6, 0.4]}
    Y = Y_ref + torch.randn(6, 40, generator=g) * 1e-6
    step = 0.4 * scales.get(1, torch.full((6,), 0.02))
    Y[:, 3] += step
    Y[1, 5] -= step[1]
    Y[2, 9] += 2 * step[2]
    Y[4, 11] += 1e-3
    got, want = check.compare(Y, ref, members), frozen_compare(Y, ref,
                                                               members)
    assert got.keys() == want.keys()
    assert want["flip_share"] > 0 or dtypes != ("fp32", "int8")
    for k in want:
        assert got[k].hex() == want[k].hex(), k
