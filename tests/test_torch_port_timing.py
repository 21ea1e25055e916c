"""The port's span recorder and counters (``pixelbox_tpu_torch/utils/timing.py``)
and the spans of the duplicates pass, the scan call and the store append."""

import json
import math
import sys
import threading

import numpy as np
import torch

from pixelbox_tpu_torch.engine import Engine
from pixelbox_tpu_torch.index.store import VectorStore
from pixelbox_tpu_torch.ops.fused_scan import build_row_meta
from pixelbox_tpu_torch.ops.scan import (
    build_scan_sample,
    cosine_scan_topk,
    cosine_scan_topk_auto,
    repair_unproven,
    to_host,
)
from pixelbox_tpu_torch.utils import timing
from pixelbox_tpu_torch.utils.timing import span


def _children(rec, parent):
    return [s for s in rec.spans if s.parent == parent.id]


def test_nesting_gives_parent_ids():
    with timing.recorded() as rec:
        with span("t.outer"):
            with span("t.inner"):
                with span("t.leaf", wait=True):
                    pass
            with span("t.inner"):
                pass
    by = {s.name: [x for x in rec.spans if x.name == s.name] for s in rec.spans}
    (outer,), inners, (leaf,) = by["t.outer"], by["t.inner"], by["t.leaf"]
    assert outer.parent is None and [s.parent for s in inners] == [outer.id, outer.id]
    assert leaf.parent == inners[0].id and leaf.wait and not outer.wait
    assert outer.t0_ns <= inners[0].t0_ns <= leaf.t0_ns <= leaf.t1_ns <= outer.t1_ns
    assert len({s.id for s in rec.spans}) == 4


def test_threads_keep_their_own_stacks():
    barrier = threading.Barrier(4)

    def work(i):
        with span("t.thread_outer"):
            barrier.wait(timeout=10)           # every thread's outer span is open
            with span("t.thread_inner"):
                barrier.wait(timeout=10)

    with timing.recorded() as rec:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    outers = {s.id: s for s in rec.spans if s.name == "t.thread_outer"}
    inners = [s for s in rec.spans if s.name == "t.thread_inner"]
    assert len(outers) == 4 and len(inners) == 4
    for s in inners:
        assert s.parent in outers and outers[s.parent].thread == s.thread
    assert len({s.thread for s in inners}) == 4


def test_threads_lose_no_updates():
    """More threads than cores, a short switch interval, a reader merging
    while the workers add sites: no span and no counter bump is lost."""
    timing.reset_stats()
    n_threads, n = 16, 500
    before = timing.counters()["host_syncs"]
    stop = threading.Event()

    def read():
        while not stop.is_set():
            timing.get_stats()

    def work(i):
        for j in range(n):
            with span("t.stress"):
                with span(f"t.stress.{i}.{j % 5}"):
                    timing.bump("host_syncs")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=read)
        reader.start()
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        reader.join(timeout=10)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not reader.is_alive()
    assert timing.get_stats()["t.stress"]["count"] == n_threads * n
    assert timing.counters()["host_syncs"] - before == n_threads * n


def test_uncapped_count():
    timing.reset_stats()
    for _ in range(2000):
        with span("t.many"):
            pass
    st = timing.get_stats()["t.many"]
    assert st["count"] == 2000
    assert 0 <= st["last_ms"] <= st["max_ms"] and st["mean_ms"] <= st["max_ms"]
    assert math.isclose(st["total_s"], st["mean_ms"] * 2000 / 1e3)


def test_ended_threads_still_count():
    timing.reset_stats()

    def work():
        for _ in range(3):
            with span("t.short_lived"):
                pass

    for _ in range(5):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
    with span("t.short_lived"):       # registers this thread; the ended ones retire
        pass
    assert timing.get_stats()["t.short_lived"]["count"] == 16


def test_recording_off_keeps_only_aggregates_and_counters_count():
    timing.stop_recording()                        # whatever ran before
    before = timing.counters()
    timing.reset_stats()
    with span("t.off"):
        timing.bump("host_syncs", 3)
    rec = timing.stop_recording()
    assert rec.spans == [] and rec.bumps == []
    assert timing.get_stats()["t.off"]["count"] == 1
    assert timing.counters()["host_syncs"] == before["host_syncs"] + 3


def test_recording_on_logs_counter_bumps_with_times():
    with timing.recorded() as rec:
        with span("t.bumps"):
            timing.bump("host_syncs")
            timing.bump("repaired_queries", 5)
    (s,) = rec.spans
    assert [(b.name, b.n) for b in rec.bumps] == [("host_syncs", 1), ("repaired_queries", 5)]
    assert all(s.t0_ns <= b.t_ns <= s.t1_ns for b in rec.bumps)
    assert rec.bumps[0].t_ns <= rec.bumps[1].t_ns


def test_add_span_is_a_child_of_the_open_span():
    t0 = timing._clock()
    with timing.recorded() as rec:
        with span("t.batch"):
            timing.add_span("t.waited", t0, timing._clock(), wait=True)
    batch = next(s for s in rec.spans if s.name == "t.batch")
    waited = next(s for s in rec.spans if s.name == "t.waited")
    assert waited.parent == batch.id and waited.wait and waited.t0_ns == t0


def _profiled_names(tmp_path, body):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        body()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name") for e in events if e.get("cat") in ("cpu_op", "user_annotation")}


def test_spans_annotate_the_profiler_trace(tmp_path):
    assert "dedup.pairs" in timing.ANNOTATED and "t.unmarked" not in timing.ANNOTATED

    def body():
        with span("dedup.pairs"):
            with span("t.unmarked"):
                torch.ones(4).add_(1)

    names = _profiled_names(tmp_path, body)
    assert "dedup.pairs" in names                   # the bare name, no id suffix
    assert "t.unmarked" not in names                # not recording: the marked spans only

    def recorded_body():
        with timing.recorded():
            body()

    assert {"dedup.pairs", "t.unmarked"} <= _profiled_names(tmp_path, recorded_body)


def test_off_path_reuses_one_object_a_name():
    timing.stop_recording()
    first = span("t.reused")
    with first as s:
        assert s is first
    assert span("t.reused") is first                # nothing allocated a call
    with span("t.reused"):
        inner = span("t.reused")                    # nested under its own name
        assert inner is not first
        with inner:
            pass
    assert timing.get_stats()["t.reused"]["count"] == 3


def test_then_chains_siblings_at_one_clock_reading():
    timing.reset_stats()
    for _ in range(3):
        with span("t.first") as s:
            s.then("t.second")
            s.then("t.third")
    st = timing.get_stats()
    assert [st[n]["count"] for n in ("t.first", "t.second", "t.third")] == [3, 3, 3]
    with timing.recorded() as rec:
        with span("t.parent"):
            with span("t.first") as s:
                s.then("t.second")
    parent, first, second = rec.spans
    assert [s.name for s in rec.spans] == ["t.parent", "t.first", "t.second"]
    assert first.parent == second.parent == parent.id
    assert first.t1_ns == second.t0_ns


def test_syncs_count_into_host_syncs():
    before = timing.counters()["host_syncs"]
    with span("t.sync", wait=True) as w:
        w.syncs += 2
    assert timing.counters()["host_syncs"] == before + 2
    with timing.recorded() as rec:
        with span("t.sync", wait=True) as w:
            w.syncs += 1
    assert [(b.name, b.n) for b in rec.bumps] == [("host_syncs", 1)]
    assert timing.counters()["host_syncs"] == before + 3
    assert timing.get_stats()["t.sync"]["wait"]


class _OnCard:
    """A result tensor as a card holds it: ``to_host`` copies it."""

    is_cuda = True

    def __init__(self, t):
        self.t = t

    def cpu(self):
        return self.t


def test_to_host_counts_card_tensors_only():
    before = timing.counters()["host_syncs"]
    d, i = to_host(torch.zeros(3), torch.arange(3))
    assert timing.counters()["host_syncs"] == before
    d, i = to_host(_OnCard(torch.ones(3)), torch.arange(3))
    assert timing.counters()["host_syncs"] == before + 1
    assert isinstance(d, np.ndarray) and d.tolist() == [1.0, 1.0, 1.0]


def _engine(tmp_path, n=600, dim=32, seed=3):
    eng = Engine.new(str(tmp_path / "lib.db"), embedder="none", dim=dim, device="cpu")
    rng = np.random.default_rng(seed)
    sem = rng.integers(0, 256, size=(n, dim), dtype=np.uint8)
    sem[1::50] = sem[0::50]                           # planted duplicates
    ph = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    ph[1::40] = ph[0::40]
    timing.reset_stats()
    with eng.index_rwlock.write_locked():
        eng._append_hashes(list(range(1, n + 1)), sem, ph)
    return eng


def test_store_append_span(tmp_path):
    eng = _engine(tmp_path)
    try:
        st = timing.get_stats()
        assert st["engine.append"]["count"] == 1
        assert st["append.semantic"]["count"] == 1 and st["append.phash"]["count"] == 1
        assert st["append.semantic"]["total_s"] <= st["engine.append"]["total_s"]
    finally:
        eng.close()


def test_duplicates_pass_spans(tmp_path):
    eng = _engine(tmp_path)
    n, batch = 600, 128
    try:
        for by, md in (("semantic", 0.05), ("phash", 0.1)):
            off = eng.find_duplicate_pairs(by=by, max_distance=md, batch=batch)
            syncs = timing.counters()["host_syncs"]
            with timing.recorded() as rec:
                on = eng.find_duplicate_pairs(by=by, max_distance=md, batch=batch)
            assert on == off and off                     # same pairs, recording or not
            (pass_span,) = [s for s in rec.spans if s.name == "engine.duplicate_scan"]
            kids = [s.name for s in _children(rec, pass_span)]
            n_batches = math.ceil(n / batch)
            assert kids == ["dedup.gather"] + ["dedup.scan", "dedup.pairs"] * n_batches
            scans = [s for s in rec.spans if s.name == "dedup.scan"]
            for sc in scans:
                names = [c.name for c in _children(rec, sc)]
                assert names and all(k.startswith("scan.") for k in names), names
                assert "scan.prep" in names and names[-1] == "scan.download"
            # A CPU pass makes no host sync: nothing waits on a card.
            assert not [b for b in rec.bumps if b.name == "host_syncs"]
            assert timing.counters()["host_syncs"] == syncs
    finally:
        eng.close()


def test_threshold_scan_spans():
    rng = np.random.default_rng(5)
    store = VectorStore(dim=32, kind="semantic", device="cpu")
    store.append(rng.integers(0, 256, size=(1024, 32), dtype=np.uint8))
    index = store.device_index
    q = torch.from_numpy(rng.integers(0, 256, size=(16, 32), dtype=np.uint8))
    # block_rows 64: the library is past the exact scan's gate, so the
    # threshold pass runs (θ, collect, select, proof).
    with timing.recorded() as rec:
        with span("t.call"):
            d, i = cosine_scan_topk_auto(q, index, k=10, block_rows=64,
                                         sample=build_scan_sample(index),
                                         row_meta=build_row_meta(index))
    want_d, want_i = cosine_scan_topk(q, index, k=10)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    call = next(s for s in rec.spans if s.name == "t.call")
    kids = [s.name for s in _children(rec, call)]
    assert kids[:1] == ["scan.prep"] and "scan.proof" in kids
    assert [s.name for s in rec.spans if s.name in ("scan.theta", "scan.collect", "scan.select")] \
        == ["scan.theta", "scan.collect", "scan.select"]
    assert next(s for s in rec.spans if s.name == "scan.proof").wait


def test_repair_spans_and_counters():
    q = torch.arange(4 * 8, dtype=torch.uint8).reshape(4, 8)
    best_d = torch.zeros((4, 2))
    best_i = torch.zeros((4, 2), dtype=torch.int32)
    exact = torch.tensor([True, False, True, False])

    def rescan(rq):
        assert rq.shape == (8, 8)
        return torch.ones((8, 2)), torch.full((8, 2), 7, dtype=torch.int32)

    before = timing.counters()
    with timing.recorded() as rec:
        d, i = repair_unproven(q, best_d, best_i, exact, rescan)
    assert d[:, 0].tolist() == [0.0, 1.0, 0.0, 1.0] and i[1, 0] == 7
    names = [s.name for s in rec.spans]
    assert names == ["scan.proof", "scan.repair", "scan.unproven"]
    repair = rec.spans[1]
    assert rec.spans[2].parent == repair.id and rec.spans[2].wait and not repair.wait
    assert timing.counters()["repaired_queries"] == before["repaired_queries"] + 2
    assert timing.counters()["host_syncs"] == before["host_syncs"]      # on the CPU
