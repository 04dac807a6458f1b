"""The plain reference against the served program's own plain path, on
the CPU at a reduced size: each member's last-token class scores, fp32 and
int8, and the combined answer, for both configurations."""
import numpy as np
import pytest
import torch

from servebench_fixtures import reduce_cfg
from harness import cell, weights
from reference import model as ref

CONFIGS = ["mamba2-pair", "hymba-pair"]


def _cfg(name):
    return reduce_cfg(cell.load_config(name))


def _tokens(cfg, rows=5, seed=3):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(0, cfg["vocab_size"],
                                       (rows, cfg["max_seq"])).astype(np.int32))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("member", [0, 1], ids=["fp32", "int8"])
def test_member_matches_program_plain_path(name, member):
    from repro_torch.kernels import quant
    from repro_torch.serving.worker import make_predict_fn
    cfg = _cfg(name)
    trees = weights.make_trees(cfg, 11, "cpu")
    m = cfg["members"][member]
    model = cell.port_models(cfg)[member]
    params = trees[member]
    if m["dtype"] != "fp32":
        params = quant.quantize_params(params, m["dtype"])
    tok = _tokens(cfg)
    got = make_predict_fn(model, use_kernel=False,
                          member_dtype=m["dtype"])(params, tok)
    with torch.no_grad(), ref.precision("fp32", tok.device):
        want = ref.member_logits(cfg, m["num_layers"],
                                 ref.Weights(trees[member],
                                             m["dtype"] == "int8"), tok)
    assert got.shape == want.shape == (5, cfg["vocab_size"])
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, scale)


@pytest.mark.parametrize("name", CONFIGS)
def test_combined_answer_matches_program_quantized_logits(name):
    """The int8 member's scores quantized per row, weighted 0.6 / 0.4."""
    from repro_torch.kernels import quant
    from repro_torch.serving.worker import make_predict_fn
    cfg = _cfg(name)
    trees = weights.make_trees(cfg, 12, "cpu")
    models = cell.port_models(cfg)
    tok = _tokens(cfg, rows=3)
    p0 = make_predict_fn(models[0])(trees[0], tok)
    q, s = make_predict_fn(models[1], member_dtype="int8", quant_out=True)(
        quant.quantize_params(trees[1], "int8"), tok)
    want = 0.6 * p0 + 0.4 * q.float() * s
    got = ref.combined(cfg, trees, tok, block_rows=2)
    assert got["weights"] == pytest.approx([0.6, 0.4])
    assert float((got["Y"] - want).abs().max()) <= 1e-5


def test_ssd_matches_sequential_recurrence():
    """The chunked scan against the recurrence h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t B_t^T, y_t = h_t C_t, with a ragged last chunk."""
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 2, 11, 3, 4, 5
    x = torch.randn(b, s, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(b, s, h, generator=g, dtype=torch.float64) * 0.3
    A = -torch.rand(h, generator=g, dtype=torch.float64) * 2
    bm = torch.randn(b, s, n, generator=g, dtype=torch.float64)
    cm = torch.randn(b, s, n, generator=g, dtype=torch.float64)
    y = ref.ssd(x, dt, A, bm, cm, chunk=4)
    st = torch.zeros(b, h, p, n, dtype=torch.float64)
    for t in range(s):
        st = st * torch.exp(dt[:, t] * A)[..., None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * bm[:, t, None, None, :]
        assert torch.allclose(y[:, t], torch.einsum("bhpn,bn->bhp", st,
                                                    cm[:, t]), atol=1e-10)


def test_weights_follow_the_program_layout():
    from repro_torch.models.transformer import param_shapes
    for name in CONFIGS:
        cfg = _cfg(name)
        for m, model in zip(cfg["members"], cell.port_models(cfg)):
            assert weights.tree_shapes(cfg, m["num_layers"]) == \
                param_shapes(model)


def test_weights_are_the_seeds():
    cfg = _cfg("hymba-pair")
    a = weights.make_trees(cfg, 2 ** 31 + 5, "cpu")
    b = weights.make_trees(cfg, 2 ** 31 + 5, "cpu")
    c = weights.make_trees(cfg, 2 ** 31 + 6, "cpu")
    assert torch.equal(a[0]["layers"][0]["wq"], b[0]["layers"][0]["wq"])
    assert not torch.equal(a[0]["layers"][0]["wq"], c[0]["layers"][0]["wq"])
    assert not torch.equal(a[0]["embed"][:8], a[1]["embed"][:8])
    dt = torch.nn.functional.softplus(a[0]["layers"][0]["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
