"""A configuration's family module, with modules the tests register
themselves: a layer kind that ``reference/model.py`` does not know (an MoE
after each SSM mixer) is drawn, served, counted and checked through
``run_cell`` with nothing of the harness edited, and a reference's
admissible alternates are taken only where the configuration sets an
``alt_share`` limit."""
import sys
import time
import types

import pytest
import torch

import servebench_moe_reference as moe_reference
from harness import cell, check, family, weights, work
from reference import model
from servebench_fixtures import CLOSED, reduce_cfg

CPU = torch.device("cpu")
MOE = {"num_experts": 4, "top_k": 2, "d_ff_expert": 32,
       "shared_expert": True, "d_ff_shared": 48, "impl": "dense"}


def _moe_cfg() -> dict:
    """mamba2-pair at CPU size, each SSM mixer followed by the MoE."""
    cfg = reduce_cfg(cell.load_config("mamba2-pair"))
    cfg.update(name="moe-pair", reference="moe_test", moe=dict(MOE))
    return cfg


def _spec(cfg: dict) -> dict:
    spec = cell.load_spec("mamba2-pair.bulk")
    spec["cfg"], spec["traffic"] = cfg, dict(CLOSED)
    return spec


def _run(cfg, control=False, fault=None):
    return cell.run_cell(_spec(cfg), 2 ** 31 + 91, 1.0, False,
                         t_start=time.perf_counter(), device=CPU,
                         control=control, fault=fault)


@pytest.fixture
def registered(monkeypatch):
    """``register(name, module)``: ``module`` as ``reference.<name>``."""
    def register(name, mod):
        monkeypatch.setitem(sys.modules, f"reference.{name}", mod)
    register("moe_test", moe_reference)
    return register


# ------------------------------------------------------- a new layer kind
def test_moe_trees_follow_the_program_layout(registered):
    from repro_torch.models.transformer import param_shapes
    cfg = _moe_cfg()
    for m, port in zip(cfg["members"], cell.port_models(cfg)):
        assert weights.tree_shapes(cfg, m["num_layers"]) == param_shapes(port)
    tree = weights.make_trees(cfg, 3, "cpu")[0]["layers"][0]
    assert tree["w_gate"].shape == (2, 4, 64, 32)
    assert float(tree["router"].std()) == pytest.approx(0.02, rel=0.2)


def test_moe_flops_by_hand(registered):
    cfg = _moe_cfg()
    s, d, di, n, h = 32, 64, 128, 16, 8
    mixer = (2 * s * d * (2 * di + 2 * n + h) + 2 * s * 4 * (di + 2 * n) +
             work.ssd_call(1, s, h, 16, n, 16)[1] + 2 * s * di * d)
    moe = 2 * s * d * 4 + 3 * 2 * s * 2 * d * 32 + 3 * 2 * s * d * 48
    head = 2 * d * 120
    assert work.pair_flops_per_row(cfg) == 3 * (mixer + moe) + 2 * head


def test_moe_run_is_correct(registered):
    """Also where the configuration allows alternates and the module
    names none: ``alt_share`` reads 0."""
    cfg = _moe_cfg()
    cfg["check"] = dict(cfg["check"], alt_share=0.01)
    res = _run(cfg, control=True)
    assert res["correct"], res["numbers"]
    assert res["numbers"]["alt_share"] == res["control"]["alt_share"] == 0.0
    assert set(res["numbers"]) == {"max_err", "flip_share", "alt_share"}
    assert res["sampled_rows"] >= 1 and res["failed"] == 0
    # the TF32 control fails a limit that the sound run keeps
    assert not check.limits_hold(res["control"], res["limits"]), \
        res["control"]


def _drop_shared_expert(cfg, p, h, _moe=moe_reference.moe):
    return _moe(cfg, p, h) - model.swiglu(
        {"w_gate": p["ws_gate"], "w_up": p["ws_up"],
         "w_down": p["ws_down"]}, h)


def _top_one(cfg, p, h, _moe=moe_reference.moe):
    return _moe(dict(cfg, moe=dict(cfg["moe"], top_k=1)), p, h)


@pytest.mark.parametrize("wrong", [_drop_shared_expert, _top_one])
def test_moe_check_sees_the_experts(registered, monkeypatch, wrong):
    """A reference that leaves out the shared expert, or routes each token
    to one expert, fails the run."""
    monkeypatch.setattr(moe_reference, "moe", wrong)
    res = _run(_moe_cfg())
    assert not res["correct"]
    assert res["numbers"]["max_err"] > res["limits"]["max_err"]


# ------------------------------------------------------ the module contract
@pytest.mark.parametrize("name,missing", [
    ("nowhere", None), ("partial", "layer_flops"), (None, None)])
def test_a_missing_module_stops_the_run_before_set_up(registered, monkeypatch,
                                                       name, missing):
    if missing:
        mod = types.ModuleType("reference.partial")
        mod.layer_shapes, mod.combined = model.layer_shapes, model.combined
        registered(name, mod)
    cfg = reduce_cfg(cell.load_config("mamba2-pair"))
    if name is None:
        del cfg["reference"]
    else:
        cfg["reference"] = name
    monkeypatch.setattr(weights, "make_trees",
                        lambda *a: pytest.fail("set-up began"))
    with pytest.raises(ValueError, match=missing or "reference"):
        _run(cfg)


def test_the_module_is_found_by_the_configurations_name(registered):
    assert family.module(_moe_cfg()) is moe_reference
    assert family.module(cell.load_config("mamba2-pair")) is model


# --------------------------------------------------------------- alternates
def _alternates_module(right_rows=None):
    """``model``'s forward, whose answer ``Y`` is wrong in every row (one
    class score moved by 0.5) and whose one alternate a row is right; a
    row not in ``right_rows`` (all where None) has a wrong alternate too
    (another class score moved)."""
    mod = types.ModuleType("reference.alt_test")
    mod.layer_shapes, mod.layer_flops = model.layer_shapes, model.layer_flops

    def combined(cfg, trees, tokens, **kw):
        ref = model.combined(cfg, trees, tokens, **kw)
        right = ref["Y"]
        wrong = right.clone()
        wrong[:, 7] += 0.5
        alternates = {}
        for r in range(right.shape[0]):
            y = right[r].clone()
            if right_rows is not None and r not in right_rows:
                y[11] += 0.5
            alternates[r] = [{"Y": y, "scales": {
                i: s[r] for i, s in ref["scales"].items()}}]
        return dict(ref, Y=wrong, alternates=alternates)
    mod.combined = combined
    return mod


def _alt_cfg(limit):
    cfg = reduce_cfg(cell.load_config("mamba2-pair"))
    cfg["reference"] = "alt_test"
    if limit is not None:
        cfg["check"] = dict(cfg["check"], alt_share=limit)
    return cfg


def test_a_right_alternate_passes(registered):
    registered("alt_test", _alternates_module())
    res = _run(_alt_cfg(1.0), control=True)
    assert res["correct"], res["numbers"]
    assert res["numbers"]["alt_share"] == 1.0
    assert res["numbers"]["max_err"] <= res["limits"]["max_err"]
    # the TF32 control, nearest to the reference's own answer, still fails
    assert not check.limits_hold(res["control"], res["limits"]), \
        res["control"]


@pytest.mark.parametrize("limit", [0.5, None], ids=["half", "no_limit"])
def test_alternates_beyond_their_limit_fail(registered, limit):
    registered("alt_test", _alternates_module())
    res = _run(_alt_cfg(limit))
    assert not res["correct"]
    assert res["numbers"]["alt_share"] == 1.0
    assert res["numbers"]["max_err"] <= res["limits"]["max_err"]
    assert ("alt_share" in res["limits"]) == (limit is not None)


def test_a_row_that_matches_neither_answer_fails(registered):
    registered("alt_test", _alternates_module(right_rows=range(1, 10 ** 6)))
    res = _run(_alt_cfg(1.0))
    assert not res["correct"]
    assert res["numbers"]["max_err"] > res["limits"]["max_err"]
    assert res["numbers"]["alt_share"] < 1.0


def test_compare_takes_the_nearest_answer():
    """Row by row: the reference answer, an alternate, or neither."""
    members = [{"dtype": "fp32"}, {"dtype": "int8"}]
    Y_ref = torch.zeros(3, 4)
    ref = {"Y": Y_ref, "weights": [0.6, 0.4],
           "scales": {1: torch.full((3,), 0.01)}}
    Y = torch.tensor([[0.0, 0, 0, 0], [1.0, 0, 0, 0], [0, 0, 2.0, 0]])
    alt = {"Y": torch.tensor([1.0, 0, 0, 0]), "scales": {1: torch.tensor(0.01)}}
    got = check.compare(Y, dict(ref, alternates={0: [alt], 1: [alt],
                                                 2: [alt]}), members)
    assert got == {"max_err": 2.0 / 1.0, "flip_share": 0.0,
                   "alt_share": 1 / 3}
    # an alternate one int8 code step off counts the flip, as the reference
    Y, ref["Y"], ref["scales"] = Y[:2], Y_ref[:2], {1: torch.full((2,), 0.01)}
    Y[1, 1] += 0.4 * 0.01
    got = check.compare(Y, dict(ref, alternates={1: [alt]}), members)
    assert got["max_err"] < 1e-9 and got["flip_share"] == 1 / 8
    assert got["alt_share"] == 0.5
