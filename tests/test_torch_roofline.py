"""The bound arithmetic beside every kernel time (``roofline.py``, beside
chip_smoke.py) at the main-path shapes: the least time an H100 SXM could
take for the same work, from NVIDIA's published peaks (989 TFLOP/s bf16 and
495 TF32 on the tensor cores, 67 fp32 on the CUDA cores, 3.35 TB/s HBM3).
fp32-grade products go at the faster of fp32 and 3xTF32 (495 / 3 = 165
TFLOP/s).  Exact arithmetic, so the tolerance is fp64 rounding (rel
1e-12)."""

import pytest

import roofline as R

N, F, K = 100_000, 256, 1024
N1M = 1_000_000


def test_fp32_grade_products_take_the_faster_of_fp32_and_3xtf32():
    assert R.PEAK_OPS_PER_S["fp32 product"] == pytest.approx(165e12,
                                                             rel=1e-12)


def test_assign_bound_at_the_headline_fp32():
    """B2 at 100K x 256 x 1024 fp32: one fp32-grade product (3xTF32)."""
    b = R.assign_bound(N, F, K, "float32")
    assert b["ops"] == {"fp32 product": 2.0 * N * K * F}
    want_bytes = (N * F * 4 + 2 * K * F * 4 + 4 * K + 4 * (K + 1) * F
                  + N + 4 * N + 4 * N + 4 * N + 4)
    assert b["bytes"] == want_bytes
    assert b["by"] == "operations"
    assert b["ms"] == pytest.approx(1e3 * 3 * 2.0 * N * K * F / 495e12,
                                    rel=1e-12)
    assert b["ms"] == pytest.approx(0.317750, rel=1e-5)


def test_assign_bound_at_1m_bf16():
    b = R.assign_bound(N1M, F, K, "bfloat16")
    assert b["ops"] == {"bf16": 2.0 * N1M * K * F}
    assert b["by"] == "operations"
    assert b["ms"] == pytest.approx(0.530119, rel=1e-5)
    # the bytes alone: x once (524 MB) and the rest
    assert b["bytes"] / R.HBM_BYTES_PER_S * 1e3 == pytest.approx(
        0.15719, rel=1e-4)


@pytest.mark.parametrize("n,dtype,want_ms", [
    (N, "float32", 1e3 * (N * F * 4 + 4 * N + 4 * K * F + 4 * K) / 3.35e12),
    (N1M, "bfloat16",
     1e3 * (N1M * F * 2 + 4 * N1M + 4 * K * F + 4 * K) / 3.35e12)])
def test_segment_sum_is_bound_by_bytes(n, dtype, want_ms):
    b = R.segment_sum_bound(n, F, K, dtype)
    assert b["by"] == "bytes"
    assert b["ms"] == pytest.approx(want_ms, rel=1e-12)


def test_fused_bound_adds_the_sum_to_the_assignment():
    a = R.assign_bound(N, F, K, "float32")
    b = R.fused_bound(N, F, K, "float32")
    assert b["bytes"] == a["bytes"] + 4 * K * F + 4 * K
    assert b["ops"] == {"fp32 product": a["ops"]["fp32 product"],
                        "fp32": float(N) * F}
    assert b["ms"] == pytest.approx(
        a["ms"] + 1e3 * N * F / 67e12, rel=1e-12)


def test_walk_bound_counts_examined_pairs_and_visited_rows():
    """32 chunks of 256 queries that examined 1e9 pairs over 400,000
    distinct member rows: an fp32-grade product of 2 f operations per
    pair, at the 3xTF32 rate, as B2's fp32 product."""
    b = R.walk_bound(10**9, 400_000, 32 * 256, F, 16, 32, "float32")
    assert b["ops"] == {"fp32 product": 2.0 * F * 10**9}
    assert b["by"] == "operations"
    assert b["ms"] == pytest.approx(1e3 * 3 * 2.0 * F * 1e9 / 495e12,
                                    rel=1e-12)
    few = R.walk_bound(1000, 400_000, 32 * 256, F, 16, 32, "float32")
    assert few["by"] == "bytes"
    assert few["bytes"] == (32 * 256 + 400_000) * F * 4 + 4 * 32 * 256 * 16 \
        + 12 * 32


def test_walk_bound_counts_bf16_products_at_the_bf16_rate():
    """bf16 storage: the walk's products go at 989 TFLOP/s, as B2's bf16
    product does; the bytes count two per feature."""
    b = R.walk_bound(10**9, 400_000, 32 * 256, F, 16, 32, "bfloat16")
    assert b["ops"] == {"bf16": 2.0 * F * 10**9}
    assert b["by"] == "operations"
    assert b["ms"] == pytest.approx(1e3 * 2.0 * F * 1e9 / 989e12, rel=1e-12)
    assert b["bytes"] == (32 * 256 + 400_000) * F * 2 \
        + 4 * 32 * 256 * 16 + 12 * 32


@pytest.mark.parametrize("n,want_ms", [(8_000_000, 1.2513), (40_000_000,
                                                             6.2567)])
def test_point_min_bound_is_bytes(n, want_ms):
    """The init step at n x 256 bf16 as the loop times it, a later step:
    x read once in bf16, x_sq and the point read, the running minimum read
    and written, valid never read: n (f * 2 + 12) + 4 f bytes at 3.35
    TB/s; its 2 f fp32 operations a row at 67 TFLOP/s are a twentieth of
    that.  The first step reads valid and writes the minimum without
    reading it, 3 bytes a row fewer."""
    b = R.point_min_bound(n, F, "bfloat16", first=False)
    assert b["bytes"] == n * (F * 2 + 12) + 4 * F
    assert b["ops"] == {"fp32": 2.0 * n * F}
    assert b["by"] == "bytes"
    assert b["ms"] == pytest.approx(1e3 * b["bytes"] / 3.35e12, rel=1e-12)
    assert b["ms"] == pytest.approx(want_ms, rel=1e-4)
    first = R.point_min_bound(n, F, "bfloat16", first=True)
    assert first["bytes"] == n * (F * 2 + 4 + 1 + 4) + 4 * F
    assert b["bytes"] - first["bytes"] == 3 * n
    fp32 = R.point_min_bound(n, F, "float32", first=False)
    assert fp32["bytes"] - b["bytes"] == 2 * n * F


@pytest.mark.parametrize("m", [79_484, 204_209, 630_524])
def test_delta_sum_bound_reads_each_moved_row_once(m):
    """The sparse delta at bench.py's 8M config (f=256, k=1024, bf16) with
    the moved-row counts of its last, a middle and its first sparse
    iteration: the listed rows once, the list and both ids (12 bytes a
    row), the (k, f) fp32 delta and the counts; bound by bytes."""
    b = R.delta_sum_bound(m, F, K, "bfloat16")
    want = m * F * 2 + 12 * m + 4 * K * F + 4 * K
    assert b["bytes"] == want
    assert b["ops"] == {"fp32": 2.0 * m * F}
    assert b["by"] == "bytes"
    assert b["ms"] == pytest.approx(1e3 * want / 3.35e12, rel=1e-12)
