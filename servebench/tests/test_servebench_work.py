"""The roofline and FLOP counts against hand counts at small shapes, and
the per-layer readers on a made-up trace."""
from types import SimpleNamespace

import pytest

from harness import cell, devtrace, work


def test_attended_pairs():
    assert work.attn_pairs(4, 0) == 10
    assert work.attn_pairs(4, 8) == 10
    assert work.attn_pairs(6, 2) == 1 + 2 + 2 + 2 + 2 + 2


def test_flash_call_by_hand():
    nbytes, ops = work.flash_call(2, 4, 2, 1, 8, 0)
    assert nbytes == 4 * 2 * 4 * 8 * (2 + 2 + 1 + 1)
    # per batch row and head: 10 pairs, each QK^T (2 x 8) and PV (2 x 8)
    assert ops == 2 * 2 * 10 * (16 + 16)


def test_ssd_call_by_hand():
    # b 1, s 8, h 2, p 2, n 3, chunk 4: two chunks of 10 pairs each
    nbytes, ops = work.ssd_call(1, 8, 2, 2, 3, 4)
    assert nbytes == 4 * (2 * 8 * 2 * 2 + 8 * 2 + 2 + 2 * 8 * 3)
    scores = 2 * 3 * 10                  # C.B^T on the lower triangle
    head = (10                           # gating
            + 2 * 10 * 2                 # intra-chunk product over p
            + 2 * 4 * 3 * 2              # the chunk's state
            + 2 * 2 * 3                  # the state carried on
            + 2 * 4 * 3 * 2              # C times the carried state
            + 4 * 2)                     # its decay
    assert ops == 2 * (scores + 2 * head)
    # a ragged last chunk counts as a whole one
    assert work.ssd_call(1, 7, 2, 2, 3, 4)[1] == ops


def test_bound_takes_the_longer_term():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 495e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 2 * 495e12) == pytest.approx(2.0)


def _mamba(d=8, layers=2):
    return {"reference": "model", "d_model": d, "pattern": ["ssm"],
            "d_ff": 0, "vocab_size": 10,
            "num_heads": 0, "num_kv_heads": 0, "head_dim": 0,
            "sliding_window": 0, "max_seq": 4,
            "ssm": {"expand": 2, "d_state": 4, "head_dim": 8, "d_conv": 4,
                    "chunk": 4},
            "members": [{"num_layers": layers}, {"num_layers": 1}],
            "allocation": [[4, 2]]}


def test_model_flops_by_hand():
    cfg = _mamba()
    s, d, di, n, h = 4, 8, 16, 4, 2
    layer = (2 * s * d * (2 * di + 2 * n + h) + 2 * s * 4 * (di + 2 * n) +
             work.ssd_call(1, s, h, 8, n, 4)[1] + 2 * s * di * d)
    head = 2 * d * 10
    assert work.member_flops_per_row(cfg, 2, s) == 2 * layer + head
    assert work.pair_flops_per_row(cfg) == 3 * layer + 2 * head


def test_rows_from_launches():
    cfg = _mamba()
    # a row costs member 0 (batch 4) 2/4 launches, member 1 (batch 2) 1/2
    assert work.rows_from_launches(cfg, 40, ("ssm",)) == pytest.approx(40.0)
    full = cell.load_spec("mamba2-pair.bulk")["cfg"]
    assert work.rows_from_launches(full, 600, ("ssm", "hybrid")) == \
        pytest.approx(100.0)


def _trace(ops, window=10.0, busy=9.0):
    return {"window_s": window, "busy_s": busy, "ops": ops,
            "idle_gaps": []}


def test_scan_roofline_reader():
    cfg = cell.load_spec("mamba2-pair.bulk")["cfg"]
    di, n, p, h, _ = work.ssm_dims(cfg)
    per = work.bound_s(*work.ssd_call(1, 256, h, p, n, 64))
    # 600 calls cover 100 rows through 72 scan layers
    secs = 72 * 100 * per / 0.25
    ops = {"void (anonymous namespace)::ssd_kernel<8>(float const*)":
           [secs * 0.9, 600],
           "(anonymous namespace)::ssd_scores_kernel(float const*)":
           [secs * 0.1, 600],
           "sm80_xmma_gemm_f32f32": [5.0, 9000]}
    ctx = SimpleNamespace(cfg=cfg, trace=_trace(ops), work=work,
                          devtrace=devtrace,
                          counters={"padding_efficiency": 1.0})
    read = cell.reader("ssd_scan_roofline.bulk")
    assert read(ctx) == pytest.approx(25.0)
    ctx.counters = {"padding_efficiency": 0.9}
    assert read(ctx) is None


def test_flash_roofline_and_per_row_readers():
    cfg = cell.load_config("hymba-pair")
    per = work.bound_s(*work.flash_call(1, 256, 25, 5, 64, 1024))
    # hymba: 32/16 + 16/8 = 4 launches a row
    secs = 48 * 50 * per / 0.5
    ops = {"void (anonymous namespace)::flash_kernel<float, 4>(float)":
           [secs, 200],
           "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n": [4.0, 100],
           "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn>":
           [1.0, 10],
           "void at::native::vectorized_elementwise_kernel<4>": [0.5, 10],
           "Memcpy HtoD (Pinned -> Device)": [0.25, 10]}
    ctx = SimpleNamespace(cfg=cfg, trace=_trace(ops), work=work,
                          devtrace=devtrace, rows_per_s=10.0,
                          counters={"padding_efficiency": 1.0})
    assert cell.reader("flash_attention_roofline.bulk")(ctx) == \
        pytest.approx(50.0)
    # 100 rows in the traced window
    assert cell.reader("matmul_ms_per_row.bulk")(ctx) == pytest.approx(50.0)
    assert cell.reader("glue_ms_per_row.bulk")(ctx) == pytest.approx(5.0)
    assert cell.reader("device_idle_share.bulk")(ctx) == pytest.approx(10.0)
    mfu = cell.reader("mfu.bulk")(ctx)
    assert mfu == pytest.approx(100 * 10.0 * work.pair_flops_per_row(cfg) /
                                work.PEAK_TF32_FLOPS)
    ctx.trace = None
    assert cell.reader("mfu.bulk")(ctx) is None


def test_kernel_classes():
    assert devtrace.is_matmul("void gemv2T_kernel_val<int, int, float>")
    assert devtrace.is_matmul("cublasLt::splitKreduce_kernel<32, 16>")
    assert not devtrace.is_matmul("void (anonymous namespace)::ssd_kernel<8>")
    assert devtrace.is_port_kernel("combine_quant_kernel(float const*)")
    assert devtrace.is_transfer("Memcpy DtoH (Device -> Pinned)")
    assert not devtrace.is_transfer("Memcpy DtoD (Device -> Device)")
