"""The port's Hopper kernels and its served path on a CUDA card.

Each kernel is held against its plain PyTorch version on the card, a
small ensemble is served through the kernels, and reduced models generate
through them.  Without a card every test
skips.  This file imports no JAX, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import ensemble_combine as ec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gemm_tf32x3 as gemm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import quant as kq  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

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
    # edges of the tensor-core tiling: 64 query rows a block, kv tiles of 16
    # keys (f32 hd 128 and 256), 32 (f32 hd 64, bf16 hd 128) or 64 (bf16
    # hd 64)
    (2, 65, 4, 2, 128, 0, torch.float32),      # one row past a q tile
    (1, 200, 16, 8, 128, 0, torch.float32),    # S not a multiple of 64
    (1, 200, 25, 5, 64, 16, torch.float32),    # hymba's group, window < tile
    (2, 130, 4, 2, 256, 0, torch.float32),
    (2, 100, 4, 2, 50, 0, torch.float32),      # hd 50: padded to 64
    (2, 65, 16, 8, 128, 0, torch.bfloat16),
    (1, 200, 25, 5, 64, 16, torch.bfloat16),
    (1, 70, 4, 1, 256, 0, torch.bfloat16),
    (2, 100, 4, 2, 50, 0, torch.bfloat16),     # bf16 element loads
    (16, 256, 24, 8, 64, 0, torch.float32),    # granite: hd 64, group 3
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


def test_combine_kernel_on_a_row_offset_view(dev):
    """M > 1 and C % 4 != 0 folded in place into rows 1.. of a larger
    partial, as the combiner folds a span: element loads, no streaming
    store."""
    m, seg, c = 3, 20, 131
    p = _randn(dev, 12, m, seg, c)
    w = torch.softmax(_randn(dev, 13, m), 0)
    big = _randn(dev, 14, seg + 1, c)
    view = big[1:]
    want = ref.ensemble_accumulate_ref(view, p, w)
    first = big[0].clone()
    ec.ensemble_combine(p, w, view, out=view)
    torch.testing.assert_close(view, want, atol=1e-5, rtol=0)
    assert torch.equal(big[0], first)                # row 0 untouched


def test_combine_kernel_in_place_at_the_main_shape(dev):
    """The combiner's call at qwen3's segment (M 1, seg 32, C 151936), in
    place: one launch, and the plain version's result to the last bit."""
    p = _randn(dev, 15, 1, 32, 151936)
    w = torch.softmax(_randn(dev, 16, 1), 0)
    part = _randn(dev, 17, 32, 151936)
    want = ref.ensemble_accumulate_ref(part, p, w)
    before = ec.launches.snapshot()["ensemble_combine"]
    got = ec.ensemble_combine(p, w, part, out=part)
    torch.cuda.synchronize()
    assert got.data_ptr() == part.data_ptr()
    assert ec.launches.snapshot()["ensemble_combine"] == before + 1
    torch.testing.assert_close(part, want, atol=0, rtol=0)


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


SSD_CASES = [                  # (b, s, h, p, n, chunk)
    (2, 64, 4, 32, 16, 16),
    (1, 128, 8, 64, 32, 32),
    (2, 100, 4, 32, 16, 16),   # ragged S
    (1, 64, 2, 64, 128, 64),   # the mamba2 state, N = 128
    (2, 150, 3, 64, 128, 64),  # ragged S with the mamba2 state
    (2, 200, 8, 64, 128, 64),  # chip_smoke.py's ragged case
    (2, 40, 3, 32, 16, 64),    # S shorter than one chunk
    (1, 96, 2, 96, 32, 32),    # P 96: two blocks a head
    (2, 50, 2, 36, 8, 8),      # P, N and chunk not whole mma tiles
    (1, 70, 2, 32, 24, 32),    # N 24: three n tiles, not split
    (1, 130, 2, 64, 256, 64),  # N 256: one stage of the ring
    (16, 256, 64, 64, 128, 64),  # served: mamba2's chunk
    (16, 256, 50, 64, 16, 64),   # served: hymba's chunk
    (2, 512, 4, 64, 128, 64),  # a mamba2 prefill's 8 chunks
    # shapes whose layout at the caller's chunk is over 227 KB: the kernel
    # runs at the largest chunk that fits
    (2, 300, 4, 64, 128, 128),  # tensor cores at chunk 112
    (2, 300, 4, 64, 16, 256),   # CUDA cores at chunk 184
    (1, 200, 2, 8, 256, 128),
    (2, 150, 3, 64, 512, 64),   # N over 256: CUDA cores, chunk 20
    (1, 90, 2, 16, 1024, 64),   # a large state at a narrow head
    (1, 70, 2, 64, 760, 64),    # the largest state at head dim 64, chunk 4
    (2, 50, 2, 6, 10, 6),       # P, N and chunk not multiples of 4
]


def _ssd_inputs(dev, b, s, h, p, n):
    x = _randn(dev, 1, b, s, h, p)
    dt = torch.nn.functional.softplus(_randn(dev, 2, b, s, h))
    A = -torch.exp(_randn(dev, 3, h) * 0.5)
    return x, dt, A, _randn(dev, 4, b, s, n), _randn(dev, 5, b, s, n)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain(dev, b, s, h, p, n, chunk):
    x, dt, A, bm, cm = _ssd_inputs(dev, b, s, h, p, n)
    before = ssd.launches.snapshot()["ssd_scan"]
    got = ssd.ssd_scan(x, dt, A, bm, cm, chunk=chunk)
    want = ref.ssd_scan_ref(x, dt, A, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches.snapshot()["ssd_scan"] == before + 1
    tol = 1e-4 * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-4)


def test_ssd_kernel_takes_unaligned_inputs(dev):
    """Contiguous views one float past an aligned base take the kernel's
    scalar loads and stores."""
    b, s, h, p, n = 1, 70, 2, 32, 16
    x, dt, A, bm, cm = _ssd_inputs(dev, b, s, h, p, n)
    x, bm, cm = (_randn(dev, 6, t.numel() + 1)[1:].view(t.shape)
                 for t in (x, bm, cm))
    before = ssd.launches.snapshot()["ssd_scan"]
    got = ssd.ssd_scan(x, dt, A, bm, cm, chunk=16)
    want = ref.ssd_scan_ref(x, dt, A, bm, cm, chunk=16)
    torch.cuda.synchronize()
    assert ssd.launches.snapshot()["ssd_scan"] == before + 1
    tol = 1e-4 * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-4)


DECODE_CASES = [               # (b, L, h, kv, hd, dtype, first valid, last)
    (2, 64, 4, 2, 32, torch.float32, 0, 57),
    (1, 300, 8, 2, 80, torch.float32, 0, 293),      # danube's hd 80
    (3, 1024, 4, 1, 128, torch.float32, 0, 1017),
    (2, 128, 4, 4, 64, torch.bfloat16, 0, 121),
    (2, 1024, 4, 1, 256, torch.float32, 600, 1024),  # gemma3's hd 256,
    (2, 1024, 4, 1, 256, torch.bfloat16, 600, 1024),  # leading tiles invalid
    (4, 2048, 16, 8, 128, torch.float32, 0, 1088),   # trailing splits invalid
    (2, 1024, 25, 5, 64, torch.float32, 0, 1024),    # hymba's group of 5
    (1, 77, 64, 1, 128, torch.float32, 0, 77),       # a group over 2048 / hd
    (2, 100, 4, 2, 50, torch.float32, 0, 100),       # hd % 4 != 0
    # tiles dealt to the splits (tiles of 32 slots; 8 splits at 16x2048)
    (2, 1024, 16, 8, 128, torch.float32, 0, 20),     # prefix under a tile
    (2, 1024, 16, 8, 128, torch.bfloat16, 0, 20),
    (2, 2048, 16, 8, 128, torch.float32, 777, 778),  # one valid slot
    (2, 2048, 16, 8, 128, torch.bfloat16, 777, 778),
    (4, 2048, 16, 8, 128, torch.float32, 0, 1100),   # prefix ends mid-tile
    (4, 2048, 16, 8, 128, torch.bfloat16, 0, 1100),
    (16, 2048, 16, 8, 128, torch.float32, 0, 90),    # 3 valid tiles, 8 splits
    (16, 2048, 16, 8, 128, torch.bfloat16, 0, 90),
    (2, 100, 4, 2, 50, torch.bfloat16, 0, 100),      # bf16 element loads
    (2, 300, 8, 2, 80, torch.bfloat16, 0, 293),      # bf16 hd 80
    (16, 1024, 24, 8, 64, torch.float32, 0, 576),    # granite's last step
]


@pytest.mark.parametrize("b,L,h,kv,hd,dtype,lo,hi", DECODE_CASES)
def test_decode_kernel_matches_plain(dev, b, L, h, kv, hd, dtype, lo, hi):
    q = (_randn(dev, 1, b, 1, h, hd) * hd ** -0.5).to(dtype)
    k = _randn(dev, 2, b, L, kv, hd).to(dtype)
    v = _randn(dev, 3, b, L, kv, hd).to(dtype)
    pos = torch.arange(L, device=dev)
    valid = (pos >= lo) & (pos < hi)
    before = dec.launches.snapshot()["decode_attention"]
    got = dec.decode_attention(q, k, v, valid)
    want = ref.decode_attention_ref(q, k, v, valid, scale=1.0)
    torch.cuda.synchronize()
    assert dec.launches.snapshot()["decode_attention"] == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("mask", ["random", "none"])
def test_decode_kernel_takes_any_mask(dev, mask):
    """A random mask, and none valid (the plain version's softmax over equal
    -1e30 logits: the mean of V)."""
    b, L, h, kv, hd = 2, 700, 8, 2, 64
    q = _randn(dev, 4, b, 1, h, hd) * hd ** -0.5
    k, v = _randn(dev, 5, b, L, kv, hd), _randn(dev, 6, b, L, kv, hd)
    valid = (torch.rand(L, device=dev) < 0.3 if mask == "random" else
             torch.zeros(L, dtype=torch.bool, device=dev))
    got = dec.decode_attention(q, k, v, valid)
    want = ref.decode_attention_ref(q, k, v, valid, scale=1.0)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_takes_a_wrapped_window(dev, dtype):
    """hymba's window ring after it wraps: the valid slots are the ring's
    head and tail, in one launch."""
    b, L, h, kv, hd = 4, 1024, 25, 5, 64
    q = (_randn(dev, 7, b, 1, h, hd) * hd ** -0.5).to(dtype)
    k = _randn(dev, 8, b, L, kv, hd).to(dtype)
    v = _randn(dev, 9, b, L, kv, hd).to(dtype)
    pos = torch.arange(L, device=dev)
    valid = (pos < 37) | (pos >= L - 100)
    before = dec.launches.snapshot()["decode_attention"]
    got = dec.decode_attention(q, k, v, valid)
    want = ref.decode_attention_ref(q, k, v, valid, scale=1.0)
    torch.cuda.synchronize()
    assert dec.launches.snapshot()["decode_attention"] == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


GEMM_CASES = [                 # (M, K, N)
    (4096, 2048, 8512),        # mamba2 in_proj, a chunk of 16 rows x 256
    (2048, 2048, 8512),        # ... of 8 rows
    (4096, 4096, 2048),        # mamba2 out_proj
    (2048, 4096, 2048),
    (1000, 1212, 1004),        # M, K and N off every tile
    (4099, 2052, 8516),
]


@pytest.mark.parametrize("m,k,n", GEMM_CASES)
def test_gemm_kernel_error_within_twice_cublas(dev, m, k, n):
    """The 3xTF32 GEMM's largest error against the float64 product is
    within twice cuBLAS f32's on the same inputs (TF32 off), and a call is
    one launch."""
    x = _randn(dev, 1, m, k)
    w = _randn(dev, 2, k, n) * k ** -0.5
    before = gemm.launches.snapshot()["gemm_tf32x3"]
    got = gemm.gemm_tf32x3(x, w)
    lib = x @ w
    want = x.double() @ w.double()
    torch.cuda.synchronize()
    assert gemm.launches.snapshot()["gemm_tf32x3"] == before + 1
    assert torch.isfinite(got).all()
    err = (got.double() - want).abs().max().item()
    lib_err = (lib.double() - want).abs().max().item()
    assert err <= 2 * lib_err, (err, lib_err)


def test_gemm_kernel_takes_views_and_refuses_what_it_cannot(dev):
    """A row-offset view that stays 16-byte aligned runs; K or N off a
    multiple of 4, a misaligned base or a transposed operand raise."""
    k, n = 64, 96
    base = _randn(dev, 3, 40 * k + 4)
    x = base[4:4 + 32 * k].view(32, k)          # 16 bytes past the base
    w = _randn(dev, 4, k, n)
    torch.testing.assert_close(gemm.gemm_tf32x3(x, w), x @ w, atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError):
        gemm.gemm_tf32x3(base[1:1 + 32 * k].view(32, k), w)
    with pytest.raises(ValueError):
        gemm.gemm_tf32x3(_randn(dev, 5, 32, 66), _randn(dev, 6, 66, n))
    with pytest.raises(ValueError):
        gemm.gemm_tf32x3(x, _randn(dev, 7, k, 98))
    with pytest.raises(ValueError):
        gemm.gemm_tf32x3(x, _randn(dev, 8, n, k).t())
    with pytest.raises(TypeError):
        gemm.gemm_tf32x3(x.bfloat16(), w.bfloat16())


def test_dense_routes_by_its_rule_on_the_card(dev):
    """At M >= ``MIN_ROWS`` a plain f32 product takes the kernel, at f32
    accuracy; a small M, ``use_kernel=False`` or an operand under autograd
    run the einsum bit for bit; no plain version runs."""
    k, n, eq = 256, 512, "bsd,de->bse"
    big = _randn(dev, 1, 2, -(-gemm.MIN_ROWS // 2), k)
    small = _randn(dev, 2, 2, 8, k)
    w = _randn(dev, 3, k, n) * k ** -0.5
    ops.reset_counts()
    got = ops.dense(big, w, eq, use_kernel=True)
    want = torch.einsum(eq, big.double(), w.double())
    torch.cuda.synchronize()
    assert ops.kernel_launches()["gemm_tf32x3"] == 1
    assert ops.library_calls()["dense"] == 0
    assert got.shape == (2, big.shape[1], n)
    assert (got.double() - want).abs().max().item() <= \
        2 * (torch.einsum(eq, big, w).double() - want).abs().max().item()
    for x, use_kernel in ((small, True), (big, False)):
        assert torch.equal(ops.dense(x, w, eq, use_kernel=use_kernel),
                           torch.einsum(eq, x, w))
    with torch.enable_grad():
        wg = w.clone().requires_grad_(True)
        out = ops.dense(big, wg, eq, use_kernel=True)
        assert out.grad_fn is not None
        assert torch.equal(out.detach(), torch.einsum(eq, big, w))
    assert ops.kernel_launches()["gemm_tf32x3"] == 1
    assert ops.library_calls()["dense"] == 3
    assert not any(ops.plain_calls().values())


# (tokens T, K, N, experts E, rows of each expert, scatter): granite's
# gate/up (K 4096 -> 768) gathering token rows, its down (768 -> 4096)
# scattering onto T rows, empty experts, ragged shapes, a call of no rows
GROUPED_CASES = [
    (2048, 4096, 768, 9, [240, 0, 513, 128, 1, 300, 0, 129, 700], False),
    (2048, 768, 4096, 9, [240, 0, 513, 128, 1, 300, 0, 129, 700], True),
    (300, 1212, 1004, 5, [0, 130, 1, 0, 257], False),
    (300, 1004, 1212, 5, [0, 130, 1, 0, 257], True),
    (64, 256, 128, 3, [0, 0, 0], True),
]


def _grouped_operands(dev, t, k, n, e, counts, scatter):
    """x (T, K), w (E, K, N), offsets, and the grouped rows' tokens: each
    expert's rows drawn without repeats from the T tokens, as a top-k
    router gives them; ``scatter`` adds (T, N) out and row scales."""
    g = torch.Generator().manual_seed(sum(counts) + k)
    rows = torch.cat([torch.randperm(t, generator=g)[:c].sort().values
                      for c in counts] + [torch.zeros(0, dtype=torch.long)])
    a = len(rows) + 17                       # rows past offsets[E] unused
    rows = torch.cat([rows, torch.randint(0, t, (17,), generator=g)])
    offsets = torch.tensor([0] + list(np.cumsum(counts)), dtype=torch.int32)
    x = _randn(dev, 1, t if not scatter else a, k)
    w = _randn(dev, 2, e, k, n) * k ** -0.5
    extra = {}
    if scatter:
        extra = {"out": _randn(dev, 3, t, n),
                 "scatter": rows.to(dev, torch.int32),
                 "scale": torch.rand(a, generator=g).to(dev)}
    else:
        extra = {"rows": rows.to(dev, torch.int32)}
    return x, w, offsets.to(dev), extra, int(offsets[-1])


@pytest.mark.parametrize("t,k,n,e,counts,scatter", GROUPED_CASES)
def test_grouped_gemm_error_within_twice_cublas(dev, t, k, n, e, counts,
                                                scatter):
    """The grouped 3xTF32 GEMM's largest error against the float64 grouped
    products is within twice that of the plain version (cuBLAS f32, TF32
    off) on the same inputs; a call is one launch, whatever its rows."""
    x, w, offsets, extra, used = _grouped_operands(dev, t, k, n, e, counts,
                                                  scatter)
    before = gemm.launches.snapshot()["gemm_tf32x3_grouped"]
    start = extra["out"].clone() if scatter else None
    got = gemm.gemm_tf32x3_grouped(x, w, offsets, **extra)
    if scatter:
        extra["out"] = start.clone()
    plain = ref.gemm_tf32x3_grouped_ref(x, w, offsets, **extra)
    if scatter:
        extra["out"] = start.double()
        extra["scale"] = extra["scale"].double()
    want = ref.gemm_tf32x3_grouped_ref(x.double(), w.double(), offsets,
                                       **extra)
    torch.cuda.synchronize()
    assert gemm.launches.snapshot()["gemm_tf32x3_grouped"] == before + 1
    if not scatter:                  # rows past offsets[E] are unspecified
        got, plain, want = got[:used], plain[:used], want[:used]
    assert torch.isfinite(got).all()
    if used == 0:
        assert torch.equal(got, plain)
        return
    err = (got.double() - want).abs().max().item()
    lib_err = (plain.double() - want).abs().max().item()
    assert err <= 2 * lib_err, (err, lib_err)


def test_grouped_dense_routes_and_the_moe_layer_needs_no_sync(dev):
    """``ops.grouped_dense`` takes the kernel for plain f32 operands on the
    card and the plain version, counted in ``plain_calls``, otherwise; a
    dropless MoE layer through the kernel is captured in a CUDA graph
    (which any host wait breaks), and its replay matches the plain
    layer."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.transformer import init_params
    cfg = ModelConfig(
        name="moe", family="moe", num_layers=1, d_model=256, num_heads=4,
        num_kv_heads=2, d_ff=0, vocab_size=128, pattern=("attn",),
        moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=128,
                      shared_expert=True, d_ff_shared=192, impl="dropless",
                      experts_held=4, first_expert=4))
    p = {k: v[0] for k, v in init_params(cfg, 1, dev)["layers"][0].items()}
    x = _randn(dev, 4, 8, 256, 256)
    ops.reset_counts()
    want = moe_ffn(cfg, p, x)[0]
    assert ops.plain_calls()["gemm_tf32x3_grouped"] == 3
    assert ops.kernel_launches()["gemm_tf32x3_grouped"] == 0
    ops.reset_counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe_ffn(cfg, p, x, use_kernel=True)       # warm: build, attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe_ffn(cfg, p, x, use_kernel=True)[0]
    graph.replay()
    torch.cuda.synchronize()
    assert ops.kernel_launches()["gemm_tf32x3_grouped"] == 6
    assert not any(ops.plain_calls().values())
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    assert float((want - moe_ffn(dataclasses.replace(cfg, moe=dataclasses.
                  replace(cfg.moe, first_expert=0)), p, x)[0]).abs().max()) \
        > 1e-3


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
    x, dt, A, bm, cm = _ssd_inputs(dev, 1, 16, 2, 8, 16)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.double(), dt, A, bm, cm, chunk=16)
    with pytest.raises(ValueError):                      # not contiguous
        ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     bm, cm, chunk=16)
    q1 = torch.zeros((1, 1, 4, 32), device=dev)
    kc = torch.zeros((1, 16, 2, 32), device=dev)
    ok = torch.ones(16, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):                      # not contiguous
        dec.decode_attention(q1, kc.transpose(1, 2).contiguous().transpose(
            1, 2), kc, ok)
    with pytest.raises(TypeError):
        dec.decode_attention(q1.half(), kc.half(), kc.half(), ok)
    with pytest.raises(ValueError):                      # hd > 256
        big = torch.zeros((1, 16, 2, 320), device=dev)
        dec.decode_attention(torch.zeros((1, 1, 4, 320), device=dev), big,
                             big, ok)
    with pytest.raises(ValueError):                      # H % KV != 0
        dec.decode_attention(torch.zeros((1, 1, 3, 32), device=dev), kc, kc,
                             ok)


def _frontend(dev, cfg, rows):
    """One seeded frontend row repeated (rows, F, fdim), or None."""
    if not cfg.frontend_tokens:
        return None
    return _randn(dev, 9, 1, cfg.frontend_tokens, cfg.fdim).expand(
        rows, -1, -1).contiguous()


def _serve(dev, cfgs, X, alloc_row):
    """Serve ``X`` through the kernels (an fp32 and an int8 member, pallas
    combine; a cross-attention member fed a nonzero frontend) and hold
    ``Y`` to the members' plain forwards on the card.  Returns the kernel
    launches of the served run."""
    from repro_torch.core import AllocationMatrix, cuda_devices
    from repro_torch.models import init_params
    from repro_torch.models.transformer import hidden, logits_from_hidden
    from repro_torch.serving import InferenceSystem

    params = [init_params(c, seed=i, device=dev) for i, c in enumerate(cfgs)]
    alloc = AllocationMatrix(cuda_devices()[:1], [c.name for c in cfgs],
                             np.array([alloc_row]))
    fes = [_frontend(dev, c, rows) for c, rows in zip(cfgs, alloc_row)]
    with InferenceSystem(cfgs, params, alloc, max_seq=X.shape[1],
                         segment_size=16, combine="pallas", use_kernel=True,
                         member_dtypes=["fp32", "int8"],
                         frontends={i: f for i, f in enumerate(fes)
                                    if f is not None}) as s:
        ops.reset_counts()
        Y = s.predict(X)
        launches, plain = ops.kernel_launches(), ops.plain_calls()
        wparams = [w.params for w in s.workers]
    assert not any(plain.values()), plain
    tok = torch.from_numpy(X).to(dev)
    want = np.zeros_like(Y)
    scale = None
    with torch.no_grad():
        for i, (cfg, p) in enumerate(zip(cfgs, wparams)):
            fe = fes[i]
            if fe is not None:
                fe = fe[:1].expand(len(X), -1, -1)
            lg = logits_from_hidden(p, cfg, hidden(p, cfg, tok, fe)[:, -1])
            lg = lg[:, :cfg.vocab_size]
            if i == 1:
                qv, sv = kq.quantize_symmetric(lg, axis=-1)
                lg, scale = kq.dequantize(qv, sv), sv.cpu().numpy()
            want += 0.5 * lg.cpu().numpy()
    assert (np.abs(Y - want) <= 1e-4 + 0.5 * scale).all()
    return launches


def test_served_ensemble_goes_through_the_kernels(dev):
    from repro_torch.configs import ensemble
    X = np.random.default_rng(0).integers(0, 512, (40, 16)).astype(np.int32)
    launches = _serve(dev, ensemble("ENS4")[:2], X, [8, 16])
    assert launches.pop("ssd_scan") == 0          # attention members only
    assert launches.pop("gemm_tf32x3") == 0       # (it runs SSM projections)
    assert launches.pop("decode_attention") == 0  # no generation here
    assert launches.pop("gemm_tf32x3_grouped") == 0   # no dropless MoE
    assert all(launches.values()), launches


def test_served_ssm_and_hybrid_ensemble_goes_through_the_kernels(dev):
    """hymba (attention + SSM in every layer) in fp32 and mamba2 (SSM only)
    in int8: every kernel launches, the scan once per SSM layer per chunk."""
    from repro_torch.configs import ensemble
    cfgs = ensemble("ENS12")[5:7]
    X = np.random.default_rng(1).integers(0, 512, (40, 72)).astype(np.int32)
    launches = _serve(dev, cfgs, X, [16, 8])
    assert launches.pop("decode_attention") == 0  # no generation here
    assert launches.pop("gemm_tf32x3_grouped") == 0   # no dropless MoE
    # the projections of a chunk of 16 rows x 72 tokens take the GEMM kernel
    # where ops.dense's rule does (hymba, fp32); mamba2's 8-row chunks of
    # the int8 member may fall under its M threshold
    per_chunk = [sum(gemm.takes(16 * 72, k, n) for k, n in (
        (c.d_model, 2 * c.d_inner + 2 * c.ssm.d_state + c.ssm_heads),
        (c.d_inner, c.d_model))) * c.num_layers for c in cfgs]
    assert launches.pop("gemm_tf32x3") >= per_chunk[0] * 2
    assert all(launches.values()), launches
    chunks = [-(-40 // 16), -(-40 // 8)]
    assert launches["ssd_scan"] >= sum(
        c.num_layers * k for c, k in zip(cfgs, chunks))
    assert launches["flash_attention"] >= cfgs[0].num_layers * chunks[0]


def test_served_moe_and_cross_attention_ensemble_goes_through_the_kernels(
        dev):
    """llama4 (MoE with a shared expert) in fp32 and llama-3.2-vision
    (cross-attention, a nonzero frontend) in int8."""
    from repro_torch.configs import ensemble
    cfgs = ensemble("ENS12")[8:10]
    X = np.random.default_rng(2).integers(0, 512, (40, 16)).astype(np.int32)
    launches = _serve(dev, cfgs, X, [16, 8])
    assert launches.pop("ssd_scan") == 0
    assert launches.pop("gemm_tf32x3") == 0
    assert launches.pop("decode_attention") == 0
    assert launches.pop("gemm_tf32x3_grouped") == 0   # llama4's MoE: capacity
    assert all(launches.values()), launches


def test_cuda_cells_split_the_card(dev):
    """Two cells of one card: distinct names and keys, half the memory and
    half the rates each, the same card behind both."""
    from repro_torch.core import cuda_cells, cuda_devices
    card = cuda_devices()[0]
    cells = [c for c in cuda_cells(2) if c.torch_device == dev]
    assert len(cells) == 2 and len({c.key() for c in cells}) == 2
    assert len({c.name for c in cells}) == 2
    for c in cells:
        assert c.memory_bytes == card.memory_bytes // 2
        assert c.peak_flops == card.peak_flops / 2
        assert c.mem_bw == card.mem_bw / 2
        assert c.name.endswith(card.name.split(":", 1)[1])


def _tree_bytes(tree):
    total = [0]

    def add(t):
        total[0] += t.numel() * t.element_size()
        return t
    kq.tree_map(add, tree)
    return total[0]


def _cells_system(dev, A):
    """ENS4[:2] on two cells of the card, trees built on the host."""
    import gc

    from repro_torch.configs import ensemble
    from repro_torch.core import AllocationMatrix, cuda_cells
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSystem
    cfgs = ensemble("ENS4")[:2]
    params = [init_params(c, seed=i, device="cpu")
              for i, c in enumerate(cfgs)]
    cells = [c for c in cuda_cells(2) if c.torch_device == dev]
    gc.collect()
    torch.cuda.empty_cache()
    return InferenceSystem(cfgs, params, AllocationMatrix(
        cells, [c.name for c in cfgs], np.array(A)), max_seq=16,
        segment_size=16, use_kernel=True), _tree_bytes(params[0])


def test_spawn_and_drain_return_the_members_bytes(dev):
    """A live spawn on the second cell adds at least member 0's tree to the
    card; draining the old instance (wait=True) takes at least as much off,
    and the spawned instance serves the same answers."""
    import gc
    X = np.random.default_rng(1).integers(0, 512, (24, 16)).astype(np.int32)
    s, nbytes = _cells_system(dev, [[8, 8], [0, 0]])
    with s:
        Y = s.predict(X)
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        w = s.spawn_instance(1, 0, 8)
        spawned = torch.cuda.memory_allocated(dev)
        assert spawned - before >= nbytes
        (old,) = [x for x in s.instances(0) if x is not w]
        s.drain_instance(old, wait=True)
        del old
        gc.collect()
        drained = torch.cuda.memory_allocated(dev)
        assert spawned - drained >= nbytes
        assert s.instances(0) == [w] and s.alloc.A[:, 0].tolist() == [0, 8]
        np.testing.assert_allclose(s.predict(X), Y, atol=1e-5)


def test_failed_spawn_leaves_nothing_behind(dev):
    """A spawn that runs out of card memory raises, posts no global
    sentinel (the system keeps serving) and frees what it had moved."""
    import gc
    X = np.random.default_rng(2).integers(0, 512, (8, 16)).astype(np.int32)
    s, nbytes = _cells_system(dev, [[8, 8], [0, 0]])
    with s:
        Y = s.predict(X)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        total = torch.cuda.get_device_properties(dev).total_memory
        # room for half of member 0's tree beyond what is held now
        torch.cuda.set_per_process_memory_fraction(
            (torch.cuda.memory_reserved(dev) + nbytes // 2) / total, dev)
        failed = False
        try:
            s.spawn_instance(1, 0, 8)
        except torch.cuda.OutOfMemoryError:
            failed = True
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, dev)
        assert failed
        gc.collect()
        assert torch.cuda.memory_allocated(dev) == before
        assert len(s.instances(0)) == 1 and s.alloc.A[1, 0] == 0
        np.testing.assert_array_equal(s.predict(X), Y)


def _plain_mean(dev, cfgs, params, X):
    """The members' plain forwards on the card, last position, averaged."""
    from repro_torch.models.transformer import forward
    tok = torch.from_numpy(X).to(dev)
    with torch.no_grad():
        return sum(forward(p, c, tok)[0][:, -1, :c.vocab_size]
                   for c, p in zip(cfgs, params)).cpu().numpy() / len(cfgs)


def test_staged_uploads_under_load_hold_every_row(dev):
    """Many concurrent requests of distinct rows on four workers (both
    members on both cells of the card), three times in a row: every
    request's answer is the plain forwards', and the predictors staged
    uploads on their copy streams.  A staged buffer reused by the next
    upload before the forward read it (no ``record_stream``), or a forward
    that did not wait for its copy, gives some request another's rows."""
    from repro_torch.configs import ensemble
    from repro_torch.core import AllocationMatrix, cuda_cells
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSystem
    cfgs = ensemble("ENS4")[:2]
    params = [init_params(c, seed=i, device=dev) for i, c in enumerate(cfgs)]
    cells = [c for c in cuda_cells(2) if c.torch_device == dev]
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 70, 48)
    X = rng.integers(0, 512, (int(sizes.sum()), 16)).astype(np.int32)
    X[:, 0] = np.arange(len(X)) % 512          # rows differ
    want = _plain_mean(dev, cfgs, params, X)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    with InferenceSystem(cfgs, params, AllocationMatrix(
            cells, [c.name for c in cfgs], np.array([[8, 8], [8, 8]])),
            max_seq=16, segment_size=64, use_kernel=True) as s:
        assert len({w._copy for w in s.workers}) == 4
        for _ in range(3):
            hs = [s.predict_async(X[lo:hi])
                  for lo, hi in zip(bounds[:-1], bounds[1:])]
            for h, lo, hi in zip(hs, bounds[:-1], bounds[1:]):
                np.testing.assert_allclose(h.result(120.0), want[lo:hi],
                                           atol=1e-4)
        assert s.serving_counters().get("h2d_staged", 0) > 0


def test_staged_buffer_comes_from_the_copy_stream(dev, monkeypatch):
    """Each staged buffer is copied on its worker's copy stream, not the
    compute stream, and the compute stream waits for that copy's event
    before the forward that reads the buffer is enqueued."""
    from repro_torch.configs import ensemble
    from repro_torch.core import AllocationMatrix, cuda_devices
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSystem
    cfgs = ensemble("ENS4")[:2]
    params = [init_params(c, seed=i, device=dev) for i, c in enumerate(cfgs)]
    waited = {}                                 # id(event) -> stream id
    wait_event = torch.cuda.Stream.wait_event

    def recorded_wait(self, event):
        waited[id(event)] = self.stream_id
        return wait_event(self, event)

    monkeypatch.setattr(torch.cuda.Stream, "wait_event", recorded_wait)
    X = np.random.default_rng(6).integers(0, 512, (96, 16)).astype(np.int32)
    used = []
    with InferenceSystem(cfgs, params, AllocationMatrix(
            cuda_devices()[:1], [c.name for c in cfgs], np.array([[8, 8]])),
            max_seq=16, segment_size=64, use_kernel=True) as s:
        for w in s.workers:
            made = {}                   # id(buffer) -> the stream it came on
            staged = {}                 # id(staged buffer) -> its event

            def upload(c, made=made, inner=w._upload):
                x = inner(c)
                made[id(x)] = torch.cuda.current_stream(dev).stream_id
                return x

            def stage(c, staged=staged, inner=w._stage):
                out = inner(c)
                staged[id(out[1])] = out[2]
                return out

            def predict(params, x, fe, w=w, made=made, staged=staged,
                        inner=w.predict_fn):
                if id(x) in staged:
                    ev = staged.pop(id(x))
                    used.append((made[id(x)], w._copy.stream_id,
                                 waited.get(id(ev)),
                                 torch.cuda.current_stream(dev).stream_id))
                return inner(params, x, fe)

            w._upload, w._stage, w.predict_fn = upload, stage, predict
        Y = s.predict(X)
        assert s.serving_counters().get("h2d_staged", 0) == len(used) > 0
    np.testing.assert_allclose(Y, _plain_mean(dev, cfgs, params, X),
                               atol=1e-4)
    for made_on, copy, waited_on, compute in used:
        assert made_on == copy != compute
        assert waited_on == compute              # the forward's stream


def test_int8_member_alone_after_a_staged_chunk_is_skipped(dev):
    """The int8 member's ``(q, per-row scale)`` logits behind the device
    combiner under ``combine="weighted"``, with the fp32 member demoted
    just after its predictor staged its next chunk on the copy stream:
    that chunk is skipped (its copy settled, its slot recycled) and the
    member's rows forgiven.  Every forgiven row is held to the int8
    member's plain dequantized logits alone, every other row to the full
    combine, by ``chip_smoke.py``'s ``held_to`` rule (within atol of a
    whole int8 step, at most 1 % of elements a step off)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from repro_torch.configs import ensemble
    from repro_torch.core import AllocationMatrix, cuda_devices
    from repro_torch.models import init_params
    from repro_torch.models.transformer import hidden, logits_from_hidden
    from repro_torch.serving import InferenceSystem
    cfgs = ensemble("ENS4")[:2]
    params = [init_params(c, seed=i, device=dev) for i, c in enumerate(cfgs)]
    X = np.random.default_rng(7).integers(0, 512, (32, 16)).astype(np.int32)
    with InferenceSystem(cfgs, params, AllocationMatrix(
            cuda_devices()[:1], [c.name for c in cfgs], np.array([[4, 4]])),
            max_seq=16, segment_size=8, dispatch_ahead=2,
            combine="weighted", use_kernel=True,
            member_dtypes=["fp32", "int8"]) as s:
        (w0,), (w1,) = s.instances(0), s.instances(1)
        stage, hold, staged = w0._stage, [], []

        def stage_then_demote(c):
            out = stage(c)
            if not staged:
                staged.append(out)
                assert s.demote_request(hold[0].req.rid, {1})
            return out

        # a fresh system's predictor waits with both window tokens: its
        # first round pops both chunks of the first segment and stages
        # the second behind the first's forward
        w0._stage = stage_then_demote
        hold.append(s.predict_async(X))
        Y = hold[0].result(120.0)
        wparams = [w0.params, w1.params]
        weights = [float(x) for x in s.accumulator.weights]
    h = hold[0]
    assert staged and staged[0][2] is not None     # a copy-stream event
    forgiven = h._missing_w > 0
    assert forgiven.any() and h.quality < 1.0
    tok = torch.from_numpy(X).to(dev)
    with torch.no_grad():
        lg = [logits_from_hidden(p, c, hidden(p, c, tok)[:, -1])
              [:, :c.vocab_size] for c, p in zip(cfgs, wparams)]
    q, sc = kq.quantize_symmetric(lg[1], axis=-1)
    P = [lg[0].cpu().numpy(), kq.dequantize(q, sc).cpu().numpy()]
    scales = sc[:, 0].cpu().numpy()
    for rows, w in ((forgiven, [0.0, 1.0]), (~forgiven, weights)):
        if rows.any():
            c = chip_smoke.held_to(Y[rows], [p[rows] for p in P],
                                   scales[rows], w)
            assert chip_smoke.served_miss(c, Y[rows].size, "rows") is None


def _merged(spans):
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _overlap(a, b):
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def test_traced_forward_spans_cover_the_device_busy_time(dev):
    """A traced mamba2 pair at full width (4 + 2 layers, fp32 and int8)
    under the profiler.  Each chunk's ``forward`` span, on the host clock,
    is placed on the profiler's through a ``record_function`` mark, as
    ``servebench/harness/devtrace.reduce`` places the benchmark's own
    spans: the spans cover at least 95 % of the device's busy time, and
    none starts before its chunk's enqueue start or ends after the
    sender's sync returned, by more than 0.5 ms."""
    import dataclasses
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.core import AllocationMatrix, cuda_devices
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSystem
    base = get_config("mamba2-1.3b")
    cfgs = [dataclasses.replace(base, name=f"mamba2.m{i}", num_layers=n)
            for i, n in enumerate((4, 2))]
    params = [init_params(c, seed=i, device=dev) for i, c in enumerate(cfgs)]
    alloc = AllocationMatrix(cuda_devices()[:1], [c.name for c in cfgs],
                             np.array([[16, 8]]))
    rng = np.random.default_rng(7)
    sizes = rng.integers(1, 40, 24)
    X = rng.integers(0, 50000, (int(sizes.sum()), 256)).astype(np.int32)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    with InferenceSystem(cfgs, params, alloc, max_seq=256, segment_size=32,
                         combine="pallas", use_kernel=True,
                         member_dtypes=["fp32", "int8"], tracing=True) as s:
        s.predict(X[:40])                       # every bucket warm
        torch.cuda.synchronize()
        s.tracer.clear()
        s.timers.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("test.window.start"):
                t0 = time.perf_counter()
            hs = [s.predict_async(X[lo:hi])
                  for lo, hi in zip(bounds[:-1], bounds[1:])]
            for h in hs:
                h.result(300.0)
            torch.cuda.synchronize()
            with record_function("test.window.end"):
                pass
        tracks = s.tracer.tracks()
        stages, counters = s.stage_timings(), s.serving_counters()
    for m in (0, 1):                            # every row, each member
        assert sum(v for k, v in counters.items()
                   if k.startswith(f"forward_rows.m{m}.")) == len(X)
    spans = [ev for tid, evs in tracks.items() if tid.endswith("/device")
             for ev in evs]
    assert len(spans) == sum(st["count"] for k, st in stages.items()
                             if k.startswith("forward_device."))
    # causality on the host clock: (end after the sync returned, start
    # before the enqueue began)
    late = [(e[2] + e[3] - e[5]["synced"], e[5]["enqueued"] - e[2])
            for e in spans]
    worst = max(max(a, b) for a, b in late)
    assert worst <= 0.5e-3, worst
    marks, device = {}, []
    for e in prof.profiler.kineto_results.events():
        lo = float(e.start_ns())
        if e.device_type() == DeviceType.CUDA:
            device.append((lo, lo + e.duration_ns()))
        elif e.name() in ("test.window.start", "test.window.end"):
            marks[e.name()] = lo
    w0, w1 = marks["test.window.start"], marks["test.window.end"]
    busy = _merged([(max(lo, w0), min(hi, w1)) for lo, hi in device
                    if min(hi, w1) > max(lo, w0)])
    fwd = _merged([(w0 + (e[2] - t0) * 1e9, w0 + (e[2] + e[3] - t0) * 1e9)
                   for e in spans])
    busy_ns = sum(hi - lo for lo, hi in busy)
    covered = _overlap(busy, fwd) / busy_ns
    summed = sum(e[3] for e in spans) * 1e9
    union = sum(hi - lo for lo, hi in fwd)
    print(f"forward spans cover {100 * covered:.3f} % of "
          f"{busy_ns * 1e-6:.3f} ms busy; span sum / union "
          f"{summed / union:.4f}; worst causality break {1e3 * worst:.4f} ms")
    assert covered >= 0.95


@pytest.mark.parametrize("name", ["qwen3-1.7b-reduced", "hymba-1.5b-reduced",
                                  "granite-moe-3b-a800m-reduced",
                                  "llama-3.2-vision-11b-reduced"])
def test_generation_goes_through_the_kernels(dev, name):
    """prefill + decode on the card: every attention layer of every step
    launches the decode kernel, every SSM layer of the prefill the scan,
    no plain version runs, and the logits follow the plain decode path."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config(name)
    p = init_params(cfg, seed=0, device=dev)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 90)).astype(np.int32)).to(dev)
    s0, steps = 80, 10          # hymba's 64-slot ring wraps
    fe = _frontend(dev, cfg, 2)
    runs = {}
    for use_kernel in (True, False):
        ops.reset_counts()
        lg, cache = prefill(p, cfg, tok[:, :s0], 96, fe,
                            use_kernel=use_kernel)
        out = [lg]
        for t in range(steps):
            lg, cache = decode_step(p, cfg, cache, tok[:, s0 + t:s0 + t + 1],
                                    s0 + t, use_kernel=use_kernel)
            out.append(lg)
        runs[use_kernel] = (torch.stack(out), ops.kernel_launches(),
                            ops.plain_calls())
    got, launches, plain = runs[True]
    want = runs[False][0]
    assert not any(plain.values()), plain
    attn = sum(k in ("attn", "swa", "hybrid") for k in cfg.pattern)
    ssm = sum(k in ("ssm", "hybrid") for k in cfg.pattern)
    assert launches["decode_attention"] == attn * cfg.repeats * steps
    assert launches["ssd_scan"] == ssm * cfg.repeats
    assert launches["flash_attention"] == 0
    tol = 1e-4 * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


def test_every_wrapper_refuses_grad_on_the_card(dev):
    """The CUDA route refuses to record a kernel call, as the CPU route and
    the JAX package do: the kernels' outputs have no grad_fn."""
    q = _randn(dev, 1, 1, 8, 2, 16).requires_grad_(True)
    k, v = _randn(dev, 2, 1, 8, 1, 16), _randn(dev, 3, 1, 8, 1, 16)
    x, dt, A, bm, cm = _ssd_inputs(dev, 1, 16, 2, 8, 16)
    P = _randn(dev, 4, 2, 3, 5).requires_grad_(True)
    calls = {
        "flash_attention": lambda: fa.flash_attention(q, k, v),
        "decode_attention": lambda: dec.decode_attention(
            q[:, :1].detach().requires_grad_(True), k, v,
            torch.ones(8, dtype=torch.bool, device=dev)),
        "ssd_scan": lambda: ssd.ssd_scan(x.requires_grad_(True), dt, A, bm,
                                         cm, chunk=16),
        "ensemble_combine": lambda: ec.ensemble_combine(
            P, torch.ones(2, device=dev)),
        "ensemble_combine_quant": lambda: ec.ensemble_combine_quant(
            P[0], torch.ones((2, 3, 5), dtype=torch.int8, device=dev),
            torch.ones((2, 3), device=dev), torch.ones(2, device=dev)),
        "gemm_tf32x3": lambda: gemm.gemm_tf32x3(P[0], torch.ones(
            (5, 4), device=dev)),
    }
    before = ops.kernel_launches()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no "
                                               "backward"):
            call()
    assert ops.kernel_launches() == before     # refused before any launch


@pytest.mark.parametrize("name", ["qwen3-1.7b-reduced", "hymba-1.5b-reduced"])
def test_train_step_on_the_card_matches_the_cpu(dev, name):
    """A train step (remat, accumulation over 2 microbatches) on the card
    against the same step of the port on the CPU, from the same params and
    batch: the loss and every gradient leaf, then the step itself."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training import tree as T
    from repro_torch.training.train_loop import loss_and_grads, make_train_step
    cfg = get_config(name)
    host = init_params(cfg, seed=0, device="cpu")
    card = T.unflatten(host, [t.to(dev) for t in T.leaves(host)])
    batch = SyntheticLM(cfg.vocab_size, 32, seed=0).batch(4)
    ops.reset_counts()
    lc, _, gc_ = loss_and_grads(card, cfg, batch, remat=True, accum_steps=2)
    lh, _, gh = loss_and_grads(host, cfg, batch, remat=True, accum_steps=2)
    assert float(lc) == pytest.approx(float(lh), abs=1e-5)
    for a, b in zip(T.leaves(gc_), T.leaves(gh)):
        tol = 1e-5 * max(1.0, b.abs().max().item())
        torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=0)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = make_train_step(cfg, ocfg, remat=True, accum_steps=2)
    card, _, mc = step(card, opt.init(card), batch)
    host, _, mh = step(host, opt.init(host), batch)
    assert not any(ops.kernel_launches().values())   # no kernel trains
    assert float(mc["grad_norm"]) == pytest.approx(float(mh["grad_norm"]),
                                                   rel=1e-4)
    # at step 1 AdamW moves an entry by about lr·sign(g): one whose
    # gradient is near 0 may move the other way, so the leaves within 2·lr
    for a, b in zip(T.leaves(card), T.leaves(host)):
        torch.testing.assert_close(a.cpu(), b, atol=2.01e-3, rtol=0)


def test_checkpoint_from_the_card_restores_on_the_cpu(dev, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training import tree as T
    cfg = get_config("mamba2-1.3b-reduced")
    card = init_params(cfg, seed=0, device=dev)
    tree = {"params": card, "opt": opt.init(card)}
    ckpt.save(str(tmp_path), 1, tree)
    template = T.unflatten(tree, [torch.zeros_like(t, device="cpu")
                                  for t in T.leaves(tree)])
    back = ckpt.restore(str(tmp_path), template)
    for a, b in zip(T.leaves(tree), T.leaves(back)):
        assert b.device.type == "cpu" and b.dtype == a.dtype
        assert torch.equal(a.cpu(), b)
