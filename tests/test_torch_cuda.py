"""The port's Hopper kernels and its served path on a CUDA card.

Each kernel is held against its plain PyTorch version on the card, and a
small ensemble is served through the kernels.  Without a card every test
skips.  This file imports no JAX, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ensemble_combine as ec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import quant as kq  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(dev, seed, *shape):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


@pytest.mark.parametrize("b,s,h,kv,hd,window,dtype", [
    (2, 64, 4, 2, 32, 0, torch.float32),
    (2, 96, 8, 2, 80, 32, torch.float32),
    (1, 200, 2, 2, 48, 0, torch.float32),
    (1, 70, 4, 1, 256, 16, torch.float32),
    (1, 33, 2, 1, 50, 0, torch.float32),       # hd % 4 != 0: scalar loads
    (2, 64, 4, 2, 64, 0, torch.bfloat16),
])
def test_flash_kernel_matches_plain(dev, b, s, h, kv, hd, window, dtype):
    q = _randn(dev, 1, b, s, h, hd).to(dtype) * hd ** -0.5
    k = _randn(dev, 2, b, s, kv, hd).to(dtype)
    v = _randn(dev, 3, b, s, kv, hd).to(dtype)
    before = fa.launches.snapshot()["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                   scale=1.0)
    torch.cuda.synchronize()
    assert fa.launches.snapshot()["flash_attention"] == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_takes_unaligned_inputs(dev):
    """A contiguous view one float past an aligned base takes the kernel's
    scalar loads."""
    b, s, h, hd = 1, 40, 2, 64
    n = b * s * h * hd
    q, k, v = (_randn(dev, i, n + 1)[1:].view(b, s, h, hd) for i in (9, 10, 11))
    got = fa.flash_attention(q * hd ** -0.5, k, v, causal=True)
    want = ref.flash_attention_ref(q * hd ** -0.5, k, v, causal=True,
                                   scale=1.0)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("m,seg,c", [(4, 128, 100), (12, 44, 91),
                                     (1, 7, 13), (1, 32, 151936)])
def test_combine_kernel_matches_plain(dev, m, seg, c):
    p = _randn(dev, 4, m, seg, c)
    w = torch.softmax(_randn(dev, 5, m), 0)
    part = _randn(dev, 6, seg, c)
    torch.testing.assert_close(ec.ensemble_combine(p, w),
                               ref.ensemble_combine_ref(p, w),
                               atol=1e-5, rtol=0)
    want = ref.ensemble_accumulate_ref(part, p, w)
    ec.ensemble_combine(p, w, part, out=part)        # in place
    torch.testing.assert_close(part, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("m,seg,c", [(3, 40, 512), (2, 9, 131),
                                     (1, 32, 151936)])
def test_quant_kernel_matches_plain(dev, qdtype, m, seg, c):
    logits = _randn(dev, 7, m, seg, c) * 4.0
    part = _randn(dev, 8, seg, c)
    w = torch.rand((m,), device=dev) + 0.1
    qs = [kq.quantize_symmetric(x, axis=-1, dtype=qdtype) for x in logits]
    q = torch.stack([a for a, _ in qs])
    s = torch.stack([b[:, 0] for _, b in qs])
    want = ref.ensemble_accumulate_quant_ref(part, q, s, w)
    torch.testing.assert_close(ec.ensemble_combine_quant(part, q, s, w), want,
                               atol=1e-4, rtol=1e-4)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 8, 4, 32), device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))          # not contiguous
    with pytest.raises(TypeError):
        ec.ensemble_combine(torch.zeros((1, 4, 8), device=dev,
                                        dtype=torch.float64),
                            torch.ones(1, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        ec.ensemble_combine(torch.zeros((1, 4, 8), device=dev),
                            torch.ones(1))               # mixed devices


def test_served_ensemble_goes_through_the_kernels(dev):
    from repro_torch.configs import ensemble
    from repro_torch.core import AllocationMatrix, cuda_devices
    from repro_torch.models import init_params
    from repro_torch.models.transformer import hidden, logits_from_hidden
    from repro_torch.serving import InferenceSystem

    cfgs = ensemble("ENS4")[:2]
    params = [init_params(c, seed=i, device=dev) for i, c in enumerate(cfgs)]
    alloc = AllocationMatrix(cuda_devices()[:1], [c.name for c in cfgs],
                             np.array([[8, 16]]))
    X = np.random.default_rng(0).integers(0, 512, (40, 16)).astype(np.int32)
    with InferenceSystem(cfgs, params, alloc, max_seq=16, segment_size=16,
                         combine="pallas", use_kernel=True,
                         member_dtypes=["fp32", "int8"]) as s:
        ops.reset_counts()
        Y = s.predict(X)
        launches, plain = ops.kernel_launches(), ops.plain_calls()
        wparams = [w.params for w in s.workers]
    assert all(launches.values()), launches
    assert not any(plain.values()), plain
    tok = torch.from_numpy(X).to(dev)
    want = np.zeros_like(Y)
    scale = None
    with torch.no_grad():
        for i, (cfg, p) in enumerate(zip(cfgs, wparams)):
            lg = logits_from_hidden(p, cfg, hidden(p, cfg, tok)[:, -1])
            lg = lg[:, :cfg.vocab_size]
            if i == 1:
                qv, sv = kq.quantize_symmetric(lg, axis=-1)
                lg, scale = kq.dequantize(qv, sv), sv.cpu().numpy()
            want += 0.5 * lg.cpu().numpy()
    assert (np.abs(Y - want) <= 1e-4 + 0.5 * scale).all()
