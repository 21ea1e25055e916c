"""The yardstick reproduces the kernel table's bounds (PERF.md §6)."""

from perfbench.roofline import ScanWork, bound_s

M = 1 << 20


def test_cosine_q256_1m_rows_and_meta():
    w = ScanWork("cosine", 256, M, M, 128, 100)
    assert M * 128 + 12 * M == 146_800_640
    s, by = bound_s(w)
    assert by == "bytes"
    assert 0.0438e-3 <= s <= 0.0440e-3


def test_hamming_q256_1m_by_operations():
    s, by = bound_s(ScanWork("hamming", 256, M, M, 32, 100))
    assert by == "operations"
    assert round(s * 1e3, 4) == 0.0694


def test_work_counts_real_queries_and_live_rows():
    a = ScanWork("cosine", 100, 100_000, 131_072, 128, 100)
    b = ScanWork("cosine", 256, 100_000, 131_072, 128, 100)
    assert a.ops < b.ops and a.nbytes < b.nbytes
    assert a.ops == 2 * 100 * 100_000 * 128
