"""The threshold pass's graph cache (``ops/scan_graphs.py``) on the CPU.

A fake capture and replay stand in for ``torch.cuda.CUDAGraph``, and CPU
tensors are taken as on a card, so these tests run the cache's real key,
eviction, lock and counter code through the port's threshold scans (their
plain versions).  The fake replay recomputes the captured chain from the
graph's static input into its static outputs, so a result read from the
wrong replay shows.  On the card ``tests/test_torch_port_cuda.py`` holds
the real graphs bit-equal to the eager chain.
"""

import gc
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef

from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import hamming_gemm as thg
from pixelbox_tpu_torch.ops import int4 as T
from pixelbox_tpu_torch.ops import scan as tscan
from pixelbox_tpu_torch.ops.oracle import quantize_embedding_np
from pixelbox_tpu_torch.ops.packed import (
    PackedHammingIndex,
    PackedSemanticIndex,
    semantic_rows_from_u8,
)
from pixelbox_tpu_torch.ops.scan_graphs import MAX_GRAPHS, GraphCache
from pixelbox_tpu_torch.utils import timing

N, D, H = 4096, 32, 32


class FakeGraph:
    """Capturing runs the chain's Python once, as a capture does (its
    kernel wrappers count their launches then); a replay recomputes the
    chain into the same output tensors with the launch counters held, as
    a replay runs no Python.  A replay lets other threads run before and
    after it, as the card runs it while the host goes on."""

    def capture(self, chain):
        self.chain = chain
        self.out = chain()
        return self.out

    def replay(self):
        time.sleep(0)
        held = dict(fs.LAUNCHES)
        for o, n in zip(self.out, self.chain()):
            o.copy_(n)
        fs.LAUNCHES.update(held)
        time.sleep(0)


class FakeCache(GraphCache):
    """The real cache, with CPU tensors taken as on a card, a stream the
    test sets, and the fake graph."""

    stream = 0

    def _on_card(self, t):
        return True

    def _stream(self, device):
        return self.stream

    def _new_graph(self, device):
        return FakeGraph()


@pytest.fixture
def cache(monkeypatch):
    c = FakeCache(fs.LAUNCHES)
    monkeypatch.setattr(fs, "SCAN_GRAPHS", c)
    return c


@pytest.fixture(scope="module")
def libs():
    rng = np.random.default_rng(15)
    c = rng.standard_normal((16, D)).astype(np.float32)
    x = c[rng.integers(0, 16, N)] + 0.35 * rng.standard_normal((N, D)).astype(np.float32)
    db = quantize_embedding_np(np.tanh(x))
    data, rs, rm = semantic_rows_from_u8(db)
    u8 = PackedSemanticIndex(*(torch.from_numpy(v) for v in (data, rs, rm, np.ones(N, bool))))
    i4 = T.build_semantic4_index(db, block_rows=1024, device="cpu")
    base = rng.integers(0, 256, (64, H), dtype=np.uint8)
    flips = rng.integers(0, 256, (N, H), dtype=np.uint8) & rng.integers(0, 256, (N, H), dtype=np.uint8)
    ph_rows = base[rng.integers(0, 64, N)] ^ (flips & rng.integers(0, 256, (N, H), dtype=np.uint8))
    ph = PackedHammingIndex(torch.from_numpy(ph_rows), torch.ones(N, dtype=torch.bool))
    ph_meta = fs.build_hamming_meta(ph)
    return {
        "u8": (u8, fs.build_row_meta(u8), tscan.build_scan_sample(u8, 1024)),
        "int4": (i4, T.build_semantic4_meta(i4), tscan.build_scan_sample(i4, 1024)),
        "phash": (ph, ph_meta, thg.build_hamming_scan_sample(ph, ph_meta, sample_rows=1024)),
        "q": torch.from_numpy(db[rng.integers(0, N, 16)]),
        "q_ph": torch.from_numpy(ph_rows[rng.integers(0, N, 16)]),
    }


def _scan(libs, kind, q, index=None, meta=None, **kw):
    """One threshold pass of ``kind`` through the port's public function."""
    lib, lib_meta, smp = libs[
        "phash" if kind.startswith("hamming") else "int4" if kind.startswith("int4") else "u8"
    ]
    index = lib if index is None else index
    meta = lib_meta if meta is None else meta
    if kind == "cosine":
        return fs.fused_threshold_scan_topk(q, index, meta, smp, **kw)
    if kind.startswith("int4"):
        return fs.fused_threshold4_scan_topk(q, index, meta, smp, query_mode=kind[5:], **kw)
    if kind == "hamming_limit24_wrap":
        kw = dict(byte_limit=24, wrap_u8=True, **kw)
    return fs.fused_hamming_threshold_scan_topk(q, index, meta, smp, **kw)


def _eager(libs, kind, q, **kw):
    """The same pass with the cache out of the way (the eager chain)."""
    saved, fs.SCAN_GRAPHS = fs.SCAN_GRAPHS, GraphCache(fs.LAUNCHES)
    try:
        return _scan(libs, kind, q, **kw)
    finally:
        fs.SCAN_GRAPHS = saved


def _queries(libs, kind):
    return libs["q_ph"] if kind.startswith("hamming") else libs["q"]


def _same(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _graph_counts():
    c = timing.counters()
    return c["scan_graph_captures"], c["scan_graph_replays"]


@pytest.mark.parametrize(
    "kind", ["cosine", "int4_asym", "int4_sym", "hamming", "hamming_limit24_wrap"]
)
def test_second_call_captures_then_replays(libs, cache, kind):
    q = _queries(libs, kind)
    qa, qb = q[:8], q[8:]
    want_a, want_b = _eager(libs, kind, qa, k=8), _eager(libs, kind, qb, k=8)
    c0, r0 = _graph_counts()
    _same(_scan(libs, kind, qa, k=8), want_a)                    # eager
    assert len(cache) == 0 and _graph_counts() == (c0, r0)
    held = _scan(libs, kind, qb, k=8)                            # captures, replays
    _same(held, want_b)
    assert len(cache) == 1 and _graph_counts() == (c0 + 1, r0 + 1)
    kept = tuple(t.clone() for t in held)
    _same(_scan(libs, kind, qa, k=8), want_a)                    # replays
    assert len(cache) == 1 and _graph_counts() == (c0 + 1, r0 + 2)
    _same(held, kept)                                            # a caller's results survive


def _rows_moved(libs):
    lib = libs["u8"][0]
    return {"index": lib._replace(data=lib.data.clone())}


def _meta_rebuilt(libs):
    return {"meta": libs["u8"][1].clone()}


#: A change to one input of a captured pass: (its kind, what the changed
#: call passes; None: the same call on another stream).
NEW_KEYS = {
    "rows_pointer": ("cosine", _rows_moved),
    "meta_pointer": ("cosine", _meta_rebuilt),
    "q_shape": ("cosine", lambda libs: {"q": libs["q"][:5]}),
    "k": ("cosine", lambda libs: {"k": 9}),
    "max_distance": ("cosine", lambda libs: {"max_distance": 0.3}),
    "target_count": ("cosine", lambda libs: {"target_count": 64}),
    "epilogue": ("cosine", lambda libs: {"epilogue": "cos"}),
    "int4_mode": ("int4_asym", lambda libs: {"kind": "int4_sym"}),
    "byte_limit": ("hamming", lambda libs: {"byte_limit": 24}),
    "wrap_u8": ("hamming", lambda libs: {"wrap_u8": True}),
    "stream": ("cosine", None),
}


@pytest.mark.parametrize("change", list(NEW_KEYS))
def test_a_changed_input_is_a_new_key(libs, cache, change):
    kind, changed = NEW_KEYS[change]
    q = _queries(libs, kind)[:8]
    for _ in range(2):
        _same(_scan(libs, kind, q, k=8), _eager(libs, kind, q, k=8))
    assert len(cache) == 1
    args = dict(k=8, q=q, kind=kind)
    if changed is None:
        cache.stream = 1
    else:
        args.update(changed(libs))
    kind2, q2 = args.pop("kind"), args.pop("q")
    want = _eager(libs, kind2, q2, **args)
    c0, r0 = _graph_counts()
    _same(_scan(libs, kind2, q2, **args), want)          # a new key: eager
    assert len(cache) == 1 and _graph_counts() == (c0, r0)
    _same(_scan(libs, kind2, q2, **args), want)          # its second call captures
    assert len(cache) == 2 and _graph_counts() == (c0 + 1, r0 + 1)


def _counted_queries(q):
    """The cosine prep, counted as a hand-kernel launch."""
    fs.count_launch("sample_theta")
    return fs.CosineQueries.from_u8(q)


def _counted_beside_a_thread(q):
    """The cosine prep, counted as a launch while another thread launches
    a kernel of its own."""
    other = threading.Thread(target=fs.count_launch, args=("hamming_chunk_topk",))
    other.start()
    other.join()
    return _counted_queries(q)


def _pass(libs, q, k=8, make=fs.CosineQueries.from_u8):
    lib, meta, smp = libs["u8"]
    return fs.threshold_pass(q, (make,), lib.data, meta, smp, k, 1e3)


def test_least_recently_used_graph_goes_first(libs, cache):
    q = libs["q"][:4]
    for k in range(1, MAX_GRAPHS + 2):
        _pass(libs, q, k)
        _pass(libs, q, k)
    assert len(cache) == MAX_GRAPHS
    c0, r0 = _graph_counts()
    for k in range(2, MAX_GRAPHS + 2):                   # all kept: replays
        _pass(libs, q, k)
    assert _graph_counts() == (c0, r0 + MAX_GRAPHS)
    for _ in range(3):                                   # pushed out: eager from then on
        _same(_pass(libs, q, 1), _eager_pass(libs, q, 1))
    assert _graph_counts() == (c0, r0 + MAX_GRAPHS) and len(cache) == MAX_GRAPHS
    _pass(libs, q, MAX_GRAPHS + 2)                       # a new key still captures
    _pass(libs, q, MAX_GRAPHS + 2)
    assert _graph_counts() == (c0 + 1, r0 + MAX_GRAPHS + 1) and len(cache) == MAX_GRAPHS
    _pass(libs, q, 2)                                    # k = 2 was the oldest: gone
    assert _graph_counts() == (c0 + 1, r0 + MAX_GRAPHS + 1)


def _eager_pass(libs, q, k):
    saved, fs.SCAN_GRAPHS = fs.SCAN_GRAPHS, GraphCache(fs.LAUNCHES)
    try:
        return _pass(libs, q, k)
    finally:
        fs.SCAN_GRAPHS = saved


@pytest.mark.parametrize("extra", [1, 4])
def test_keys_past_the_limit_settle_without_recapturing(libs, cache, extra):
    """Rounds through more keys than fit: the second round captures each
    once, later rounds replay the ones kept and run the rest eager."""
    q = libs["q"][:2]
    keys = range(1, MAX_GRAPHS + extra + 1)
    c0, r0 = _graph_counts()
    for _ in range(2):
        for k in keys:
            _pass(libs, q, k)
    assert _graph_counts() == (c0 + len(keys), r0 + len(keys))
    for rounds in (1, 2):
        for k in keys:
            _pass(libs, q, k)
        assert _graph_counts() == (c0 + len(keys), r0 + len(keys) + rounds * MAX_GRAPHS)
    assert len(cache) == MAX_GRAPHS


class ForgetfulGraph(FakeGraph):
    """A fake graph that keeps nothing of its chain, as a captured graph
    keeps no Python reference to what it reads."""

    def capture(self, chain):
        return chain()

    def replay(self):
        pass


def test_a_graph_does_not_keep_what_it_reads(libs, cache):
    """A rebuilt meta frees the old one with the cache holding its graph;
    the next call that misses drops the graph."""
    cache._new_graph = lambda device: ForgetfulGraph()
    q = libs["q"][:4]
    meta = libs["u8"][1].clone()
    freed = StorageWeakRef(meta.untyped_storage())
    for _ in range(2):
        _scan(libs, "cosine", q, meta=meta, k=8)
    assert len(cache) == 1
    del meta
    gc.collect()
    assert freed.expired() and len(cache) == 1
    _scan(libs, "cosine", q, k=8)                        # another key: a miss
    assert len(cache) == 0


@pytest.mark.parametrize("calls", [1, 2, 5])
def test_replays_add_the_captured_launches(libs, cache, calls):
    q = libs["q"][:4]
    before = dict(fs.LAUNCHES)
    for _ in range(calls):
        _pass(libs, q, make=_counted_queries)
    added = {n: c - before[n] for n, c in fs.LAUNCHES.items() if c != before[n]}
    assert added == {"sample_theta": calls}              # one a call: eager, capture, replays
    assert len(cache) == (calls >= 2)


def test_launches_of_other_threads_stay_out_of_a_capture(libs, cache):
    """Another thread's launch during the capture is counted once, where
    it ran, and never by the graph's replays."""
    q = libs["q"][:4]
    before = dict(fs.LAUNCHES)
    for _ in range(5):
        _pass(libs, q, make=_counted_beside_a_thread)
    added = {n: c - before[n] for n, c in fs.LAUNCHES.items() if c != before[n]}
    # The other thread ran in the eager call and in the capture; a replay
    # runs no Python.
    assert added == {"sample_theta": 5, "hamming_chunk_topk": 2}
    assert len(cache) == 1


def test_cpu_tensors_never_enter_the_cache(libs, monkeypatch):
    real = GraphCache(fs.LAUNCHES)
    monkeypatch.setattr(fs, "SCAN_GRAPHS", real)
    c0 = _graph_counts()
    for kind in ("cosine", "int4_asym", "hamming"):
        q = _queries(libs, kind)[:4]
        for _ in range(3):
            _scan(libs, kind, q, k=8)
    assert len(real) == 0 and _graph_counts() == c0


def test_threads_get_their_own_results(libs, cache):
    """Threads replaying one graph at once: the device lock keeps each
    input copy, replay and clone together."""
    qs = [libs["q"][i : i + 4] for i in range(0, 16, 4)]
    want = [_eager(libs, "cosine", q, k=8) for q in qs]
    for q in qs[:2]:
        _scan(libs, "cosine", q, k=8)
    assert len(cache) == 1
    wrong, done = [], []

    def worker(i):
        for _ in range(10):
            got = _scan(libs, "cosine", qs[i], k=8)
            if not all(torch.equal(x, y) for x, y in zip(got, want[i])):
                wrong.append(i)
        done.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(qs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and sorted(done) == list(range(len(qs)))
    assert not wrong and len(cache) == 1
