"""What the benchmark reads of the program's own spans: the
``engine_append_s`` reader, the scan split of ``program_spans.py`` and
its readers, the blocking calls of a chrome trace, and the idle gaps of a
chrome trace labelled by a program span's range (``spans._host_labels``,
unchanged)."""

import numpy as np
import pytest

from perfbench import harness, program
from perfbench.program_spans import blocking_calls, scan_split
from perfbench.spans import Trace, _host_labels
from pixelbox_tpu_torch.utils import timing
from pixelbox_tpu_torch.utils.timing import span

EMPTY = Trace(1.0, [], [])


def test_engine_append_s_reads_the_append_span(tmp_path):
    read = harness.metric_reader("engine_append_s")
    timing.reset_stats()
    assert read(EMPTY) is None
    eng = program.new_engine({"dim": 32, "precision": "int8", "scan_mode": "auto",
                              "max_search_results": 10, "max_distance_from_query": 1e3},
                             str(tmp_path / "lib.db"), "cpu")
    try:
        rng = np.random.default_rng(1)
        program.append_library(eng, rng.integers(0, 256, (300, 32), dtype=np.uint8),
                               rng.integers(0, 256, (300, 32), dtype=np.uint8))
    finally:
        eng.close()
    got = read(EMPTY)
    assert got == timing.get_stats()["engine.append"]["total_s"] and got > 0


NEW_READERS = ("dedup_pairs_ms_per_batch", "scan_issue_ms.dedup", "scan_wait_ms.dedup",
               "host_syncs_per_scan.dedup", "repaired_queries_per_scan.dedup")


def _stat(count, total_s, wait=False):
    return {"count": count, "total_s": total_s, "wait": wait}


def test_scan_split():
    stats = {
        "dedup.scan": _stat(4, 4e-3), "dedup.pairs": _stat(4, 2e-3),
        "scan.unproven": _stat(4, 0.2e-3, True), "scan.proof": _stat(4, 0.4e-3, True),
        "scan.download": _stat(4, 0.2e-3, True), "scan.theta": _stat(4, 1e-3),
        "serving.fill": _stat(9, 5.0, True),          # not a scan's wait
    }
    got = scan_split(stats, {"host_syncs": 16, "repaired_queries": 2})
    assert got == pytest.approx({
        "dedup_pairs_ms_per_batch": 0.5, "scan_issue_ms.dedup": 0.8,
        "scan_wait_ms.dedup": 0.2, "host_syncs_per_scan.dedup": 4.0,
        "repaired_queries_per_scan.dedup": 0.5,
    })
    assert scan_split({"dedup.pairs": _stat(4, 2e-3)}, {}) is None


@pytest.mark.parametrize("metric", NEW_READERS)
def test_reader_reads_the_program_aggregates(metric):
    read = harness.metric_reader(metric)
    timing.reset_stats()
    assert read(EMPTY) is None                      # no pass has run
    for _ in range(3):
        with span("dedup.scan") as stage:
            with span("scan.prep"):
                pass
            with span("scan.proof", wait=True) as w:
                w.syncs += 1
            stage.then("dedup.pairs")
    want = scan_split(timing.get_stats(), timing.counters())
    assert read(EMPTY) == pytest.approx(want[metric])
    st = timing.get_stats()
    if metric == "scan_wait_ms.dedup":
        assert want[metric] == pytest.approx(st["scan.proof"]["total_s"] / 3 * 1e3)
    if metric == "dedup_pairs_ms_per_batch":
        assert want[metric] == pytest.approx(st["dedup.pairs"]["mean_ms"])


def test_blocking_calls_inside_scan_annotations():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "dedup.scan", "ts": 100, "dur": 50},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 110, "dur": 2},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 113, "dur": 5},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 300, "dur": 5}]
    assert blocking_calls(ev) == {"scans": 1, "synchronize_per_scan": 1.0,
                                  "memcpy_per_scan": 1.0}
    assert blocking_calls(ev[1:]) == {}


def test_idle_gap_inside_a_program_span_takes_its_name():
    host = [
        {"ph": "X", "cat": "cpu_op", "name": "engine.duplicate_scan", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "dedup.scan", "ts": 20, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "pb.scan_call#0", "ts": 30, "dur": 380},
        {"ph": "X", "cat": "cpu_op", "name": "scan.theta", "ts": 40, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 200, "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "dedup.pairs", "ts": 500, "dur": 400},
    ]
    labels = _host_labels(host, [100, 220, 350, 700, 950])
    assert labels == ["scan call: scan.theta", "scan call: aten::copy_",
                      "scan call: dedup.scan", "host outside the scan calls: dedup.pairs",
                      "host outside the scan calls: engine.duplicate_scan"]
