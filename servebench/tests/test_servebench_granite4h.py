"""granite-4.0-h-small's family module (``reference/granite4h.py``) against
the program, on the CPU at a reduced size: one period of the layer
pattern, d 64, 8 experts of which 2 are held, top-3, the shared expert on.

Tolerances: the program and the reference compute the same float32 sums
in other orders (the router's softmax over all experts renormalised, the
reference's over the top k; the scan in chunks), so their class scores
agree to a few float32 roundings of the scores' size (1e-5 absolute on
scores of about 0.01-0.1); the program's shares and its dropless layer
against the dense one agree to 1e-6 (sums of the same products)."""
import dataclasses
import time
from types import SimpleNamespace

import pytest
import torch

from harness import cell, check, devtrace, family, weights, work
from reference import granite4h, model

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4629


def granite_cfg(held: int = 2, first: int = 0) -> dict:
    """granite4h-pair at CPU size: one period, d 64, 8 experts, ``held``
    of them held from ``first``, top-3, both members one period."""
    cfg = cell.load_config("granite4h-pair")
    cfg.update(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
               attention_multiplier=1 / 16, vocab_size=120, vocab_pad_to=8,
               max_seq=32, segment_size=8, allocation=[[4, 2]])
    cfg["ssm"].update(d_state=16, head_dim=16, chunk=16)
    cfg["moe"].update(num_experts=8, top_k=3, d_ff_expert=32,
                      d_ff_shared=48, experts_held=held, first_expert=first)
    cfg["members"][0]["num_layers"] = 10
    cfg["members"][1]["num_layers"] = 10
    return cfg


def _spec(cfg: dict) -> dict:
    spec = cell.load_spec("granite4h-pair.bulk")
    spec["cfg"] = cfg
    spec["traffic"] = {"kind": "closed", "clients": 2, "rows": 4,
                       "warmup_rows": [4]}
    return spec


def _tokens(cfg, rows=3, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg["vocab_size"], (rows, cfg["max_seq"]),
                         generator=g)


def _member(cfg, i=0):
    tree = weights.make_trees(cfg, SEED, "cpu")[i]
    return tree, cell.port_models(cfg)[i]


# ---------------------------------------------------- the program's layout
def test_trees_follow_the_program_layout():
    from repro_torch.models.transformer import param_shapes
    cfg = granite_cfg()
    for m, port in zip(cfg["members"], cell.port_models(cfg)):
        assert weights.tree_shapes(cfg, m["num_layers"]) == param_shapes(port)
    layers = weights.make_trees(cfg, 3, "cpu")[0]["layers"]
    assert layers[0]["w_gate"].shape == (1, 2, 64, 32)
    assert layers[0]["conv_b"].shape == (1, 128 + 32)
    assert layers[0]["router"].shape == (1, 64, 8)
    assert "conv_b" not in layers[5] and "wq" in layers[5]


def test_port_config_takes_the_published_multipliers():
    full = cell.port_models(cell.load_config("granite4h-pair"))[0]
    assert (full.attention_multiplier, full.embedding_multiplier,
            full.residual_multiplier, full.logits_scaling) == \
        (0.0078125, 12, 0.22, 16)
    assert not full.rope and full.ssm.conv_bias
    assert (full.moe.num_experts, full.moe.held, full.moe.top_k,
            full.moe.impl) == (72, 9, 10, "dropless")
    assert full.ssm_heads == 128 and full.num_layers == 40
    assert family.module(cell.load_config("granite4h-pair")) is granite4h


def test_layer_flops_by_hand():
    cfg = granite_cfg()
    s, d, di, n, h = 32, 64, 128, 16, 8
    ssm = 2 * s * d * (2 * di + 2 * n + h) + 2 * s * 4 * (di + 2 * n) + \
        2 * s * di * d
    attn = 2 * s * (2 * d * 4 * 16 + 2 * d * 2 * 16)     # q, o; k, v
    moe = 2 * s * d * 8 + 3 * 2 * s * (3 * 2 / 8) * d * 32 + \
        3 * 2 * s * d * 48
    assert granite4h.layer_flops(cfg, "ssm", s) == ssm + moe
    assert granite4h.layer_flops(cfg, "attn", s) == attn + moe
    scan = work.ssd_call(1, s, h, 16, n, 16)[1]
    flash = work.flash_call(1, s, 4, 2, 16, 0)[1]
    head = 2 * d * 120
    assert work.member_flops_per_row(cfg, 10, s) == \
        9 * (ssm + moe + scan) + attn + moe + flash + head


# ---------------------------------------------- the program vs the reference
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_the_reference(use_kernel):
    from repro_torch.models.transformer import forward
    cfg = granite_cfg()
    tree, port = _member(cfg)
    tok = _tokens(cfg)
    with torch.no_grad():
        got = forward(tree, port, tok, use_kernel=use_kernel)[0][:, -1]
        want = granite4h.member_logits(cfg, 10, model.Weights(tree, False),
                                       tok)
    assert got.shape[1] == 120
    assert float(want.abs().max()) > 1e-3
    torch.testing.assert_close(got[:, :120], want, rtol=0, atol=1e-5)


def test_prefill_then_decode_matches_the_forward():
    from repro_torch.models.transformer import decode_step, forward, prefill
    cfg = granite_cfg()
    tree, port = _member(cfg)
    tok = _tokens(cfg, rows=2)
    with torch.no_grad():
        full = forward(tree, port, tok)[0]
        lg, cache = prefill(tree, port, tok[:, :24], 32)
        torch.testing.assert_close(lg, full[:, 23], rtol=0, atol=1e-6)
        for pos in range(24, 32):
            lg, cache = decode_step(tree, port, cache, tok[:, pos:pos + 1],
                                    pos)
            torch.testing.assert_close(lg, full[:, pos], rtol=0, atol=1e-6)


def _moe_layer(cfg, held, first):
    """Layer 0's MoE leaves of a tree with every expert, cut to the share
    of ``held`` experts from ``first``."""
    tree = weights.make_trees(cfg, SEED, "cpu")[0]
    p = {k: v[0] for k, v in tree["layers"][0].items()}
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = p[k][first:first + held]
    return p


@pytest.mark.parametrize("side", ["reference", "program"])
def test_the_shares_sum_to_the_whole_layer(side):
    """Four cards of two experts each: their partial layers, the shared
    expert (which every card computes) counted once, add up to the uncut
    layer's."""
    from repro_torch.models.moe import moe_ffn
    full = granite_cfg(held=8)
    h = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(1))

    def layer(cfg, p):
        if side == "reference":
            return granite4h.moe(cfg, p, h)
        return moe_ffn(cell.port_models(cfg)[0], p, h)[0]
    whole = layer(full, _moe_layer(full, 8, 0))
    parts = sum(layer(granite_cfg(2, f), _moe_layer(full, 2, f))
                for f in (0, 2, 4, 6))
    p = _moe_layer(full, 8, 0)
    shared = model.swiglu({"w_gate": p["ws_gate"], "w_up": p["ws_up"],
                           "w_down": p["ws_down"]}, h)
    torch.testing.assert_close(parts - 3 * shared, whole, rtol=0, atol=1e-6)
    assert float((whole - shared).abs().max()) > 1e-3


def test_dropless_with_every_expert_held_is_the_dense_layer():
    from repro_torch.models.moe import moe_ffn
    cfg = granite_cfg(held=8)
    port = cell.port_models(cfg)[0]
    dense = dataclasses.replace(
        port, moe=dataclasses.replace(port.moe, impl="dense",
                                      experts_held=0))
    p = _moe_layer(cfg, 8, 0)
    h = torch.randn(3, 32, 64, generator=torch.Generator().manual_seed(2))
    got = moe_ffn(port, p, h)[0]
    torch.testing.assert_close(got, moe_ffn(dense, p, h)[0], rtol=0,
                               atol=1e-6)


def test_a_share_refuses_the_dropping_implementations():
    from repro_torch.models.moe import moe_ffn
    cfg = granite_cfg()
    port = cell.port_models(cfg)[0]
    cap = dataclasses.replace(port, moe=dataclasses.replace(
        port.moe, impl="capacity"))
    with pytest.raises(ValueError, match="dropless"):
        moe_ffn(cap, _moe_layer(cfg, 2, 0), torch.zeros(1, 4, 64))


# ------------------------------------------------------------- the cell
def _run(cfg, control=False):
    return cell.run_cell(_spec(cfg), SEED, 1.0, False,
                         t_start=time.perf_counter(), device=CPU,
                         control=control)


def test_run_is_correct():
    """At this size the sound run reads ``max_err`` about 1.5e-8 and the
    TF32 control about 7e-6 (``flip_share`` 0.0025, under the full size's
    limit): a limit of 1e-6 lies between them with room on both sides."""
    cfg = granite_cfg()
    cfg["check"] = dict(cfg["check"], max_err=1e-6)
    res = _run(cfg, control=True)
    assert res["correct"], res["numbers"]
    assert set(res["numbers"]) == {"max_err", "flip_share", "alt_share"}
    assert res["failed"] == 0 and res["sampled_rows"] >= 1
    # the TF32 control fails a limit that the sound run keeps
    assert not check.limits_hold(res["control"], res["limits"]), \
        res["control"]


def test_serving_counts_the_held_rows_on_the_device():
    """The dropless layers' device counters reach ``serving_counters``
    from the timers' last reset on, per member."""
    cfg = granite_cfg()
    trees = weights.make_trees(cfg, SEED, "cpu")
    system = cell.build_system(cfg, trees, CPU, tracing=False)
    try:
        tok = _tokens(cfg, rows=4).numpy()
        system.predict_async(tok).result(timeout=120)
        system.timers.reset()
        assert not any(k.startswith("moe_")
                       for k, v in system.serving_counters().items() if v)
        system.predict_async(tok).result(timeout=120)
        c = system.serving_counters()
    finally:
        system.shutdown()
    # member 0 runs the 4 rows as one batch, member 1 as two of 2, each
    # forward through 10 layers
    assert (c["moe_calls.m0"], c["moe_calls.m1"]) == (10, 20)
    for i in (0, 1):
        # 4 rows x 32 tokens x top-3, at most 2 of each token's on the 2
        # held experts
        assert 0 < c[f"moe_assignments.m{i}"] <= 10 * 4 * 32 * 2
        assert c[f"moe_max_rows.m{i}"] <= c[f"moe_assignments.m{i}"]
    ctx = SimpleNamespace(cfg=cfg, counters=c)
    rows = cell.reader("expert_rows_per_call.moe")(ctx)
    assert rows == pytest.approx(
        (c["moe_assignments.m0"] + c["moe_assignments.m1"]) / (30 * 2))


# ------------------------------------------------------------ alternates
def test_a_near_tie_at_the_last_position_names_an_alternate():
    """Held expert 0's router column moved so that, at layer 0 and the
    last token of row 1, its logit lies 2e-5 from the top-k boundary: the
    reference names the row's answer with the tie resolved the other way
    as an alternate, and a served answer that resolved the tie so is held to
    that alternate."""
    cfg = granite_cfg()
    cfg["ties"] = {"logit_gap": 1e-4, "last_positions": 1, "min_change": 0}
    trees = weights.make_trees(cfg, SEED, "cpu")
    tok = _tokens(cfg, rows=2)
    ref = granite4h.combined(cfg, trees, tok)
    assert ref["alternates"] == {}
    seen = []
    orig = granite4h.moe

    def spy(c, p, h, layer=0, ties=None):
        if layer == 0 and not seen:
            seen.append(h[1, -1].clone())
        return orig(c, p, h, layer, ties)
    granite4h.moe = spy
    try:
        granite4h.member_logits(cfg, 10, model.Weights(trees[0], False), tok)
    finally:
        granite4h.moe = orig
    x = seen[0]
    router = trees[0]["layers"][0]["router"][0]
    lg = x @ router
    k = cfg["moe"]["top_k"]
    order = torch.argsort(lg, descending=True, stable=True).tolist()
    # held expert 0 just inside the boundary if it is in the top k, just
    # outside it if not
    target = lg[order[k]] + 2e-5 if 0 in order[:k] else \
        lg[order[k - 1]] - 2e-5
    router[:, 0] += (target - lg[0]) * x / float(x @ x)
    # an answer that moves less than ``min_change`` is no alternate
    cfg["ties"]["min_change"] = 1.0
    assert granite4h.combined(cfg, trees, tok)["alternates"] == {}
    cfg["ties"]["min_change"] = 0
    ref = granite4h.combined(cfg, trees, tok)
    assert list(ref["alternates"]) == [1]
    assert len(ref["alternates"][1]) == 1
    alt = ref["alternates"][1][0]
    assert float((alt["Y"] - ref["Y"][1]).abs().max()) > 1e-6
    Y = ref["Y"].clone()
    Y[1] = alt["Y"]
    got = check.compare(Y, ref, cfg["members"])
    assert got["alt_share"] == 0.5 and got["max_err"] < 1e-9


def test_alternates_combine_the_members_and_the_control_names_none():
    """With every boundary of the last token a near-tie, a row's
    alternates are each combination of its members' answers, one site
    resolved the other way in each member or none, but for the
    reference's own; the TF32 control names none."""
    cfg = granite_cfg()
    cfg["ties"] = {"logit_gap": 1e9, "last_positions": 1, "min_change": 0}
    trees = weights.make_trees(cfg, SEED, "cpu")
    tok = _tokens(cfg, rows=1)
    assert "alternates" not in granite4h.combined(cfg, trees, tok,
                                                  prec="tf32")
    sites = []
    for i, m in enumerate(cfg["members"]):
        ties = granite4h.Ties(cfg)
        granite4h.member_logits(cfg, 10, model.Weights(
            trees[i], m["dtype"] == "int8"), tok, ties)
        sites.append(len(ties.sites))
    assert all(1 < n <= 10 for n in sites)
    ref = granite4h.combined(cfg, trees, tok)
    assert len(ref["alternates"][0]) == (1 + sites[0]) * (1 + sites[1]) - 1


# ---------------------------------------------------------------- readers
def test_the_expert_gemm_roofline_reads_work_and_time_per_launch():
    cfg = granite_cfg()
    counters = {"moe_calls.m0": 10.0, "moe_assignments.m0": 1000.0,
                "moe_calls.m1": 10.0, "moe_assignments.m1": 500.0}
    trace = {"window_s": 1.0, "busy_s": 1.0, "idle_gaps": [], "ops": {
        "(anonymous namespace)::gemm_tf32x3_grouped_kernel(Args)":
            [0.06, 60], "gemm_tf32x3_kernel": [5.0, 7]}}
    ctx = SimpleNamespace(cfg=cfg, counters=counters, trace=trace,
                          work=work, devtrace=devtrace)
    mod_path = cell.reader_path("expert_gemm_roofline.moe")
    assert mod_path.name == "expert_gemm_roofline.moe.py"
    share = cell.reader("expert_gemm_roofline.moe")(ctx)
    import importlib.util
    spec = importlib.util.spec_from_file_location("r", mod_path)
    r = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(r)
    bound = 10 * r.call_bound_s(work, cfg, 100.0) + \
        10 * r.call_bound_s(work, cfg, 50.0)
    assert share == pytest.approx(100 * (bound / 60) / (0.06 / 60))
    # nothing to read: no launches, or a program without the counters
    assert cell.reader("expert_gemm_roofline.moe")(
        SimpleNamespace(cfg=cfg, counters={}, trace=trace, work=work,
                        devtrace=devtrace)) is None
    assert cell.reader("expert_rows_per_call.moe")(
        SimpleNamespace(cfg=cfg, counters={})) is None


def test_an_alternate_is_the_programs_answer_with_that_tie_flipped():
    """Where the program routes a token of the last position to the
    (k+1)-th expert in place of the k-th, its class scores are the
    reference's alternate for that site, and not the reference's own."""
    from repro_torch.models import moe as pmoe
    from repro_torch.models.transformer import forward
    cfg = granite_cfg()
    cfg["ties"] = {"logit_gap": 1e9, "last_positions": 1, "min_change": 0}
    tree, port = _member(cfg)
    tok = _tokens(cfg, rows=1)
    k = cfg["moe"]["top_k"]
    ties = granite4h.Ties(cfg)
    with torch.no_grad():
        base = granite4h.member_logits(cfg, 10, model.Weights(tree, False),
                                       tok, ties)[0]
    site = ties.sites[len(ties.sites) // 2]
    calls, orig = [], pmoe._router

    def flipped(x, w_router, top_k):
        probs = torch.softmax((x @ w_router).float(), -1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        if len(calls) == site[1]:
            for t in (w, idx):
                t[-1, [k - 1, k]] = t[-1, [k, k - 1]]
        calls.append(1)
        w = w[:, :top_k] / w[:, :top_k].sum(-1, keepdim=True)
        return w, idx[:, :top_k], probs
    pmoe._router = flipped
    try:
        with torch.no_grad():
            got = forward(tree, port, tok)[0][0, -1, :120]
    finally:
        pmoe._router = orig
    with torch.no_grad():
        alt = granite4h.resolved(cfg, 10, model.Weights(tree, False), tok,
                                 [site], 1)[0]
    torch.testing.assert_close(got, alt, rtol=0, atol=1e-7)
    assert float((got - base).abs().max()) > 1e-6
