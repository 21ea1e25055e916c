"""The threshold pass's device chain replayed as one CUDA graph a shape.

A threshold scan (``fused_scan._threshold_scan`` behind
``fused_scan.threshold_pass``: the kind's query prep, θ from the sample,
the collect, K1c and the proof flags) issues about 30 host dispatches for
three hand-kernel launches and ~0.1 ms of device work, and its callers
(the duplicates pass, the service's buckets, the mesh's shards) repeat one
shape thousands of times over the same tensors.  :class:`GraphCache`
captures that chain once a key in a ``torch.cuda.CUDAGraph`` and replays
it: a later call copies its queries into the graph's input, replays, and
clones the outputs.

The rules follow from what the code observes, with no setting:

- Only queries on a CUDA device take the cache; CPU tensors run the eager
  chain unchanged.
- The key is the caller's (the kind and its fields, the shapes and
  scalars, and the pointer, shape, strides and dtype of every tensor the
  chain reads) with the device and its current stream.  A hit means the
  caller holds tensors of that layout at those addresses, which is all
  the captured kernels read, so the replay is the eager chain's work.  An
  entry holds those tensors weakly: a store append, removal or compaction
  that moves one gives a new key, and the old tensors are freed when the
  store drops them; a graph whose tensors are gone is dropped, with its
  memory pool, at the next call that misses.
- A key's first call runs eager: it loads the kernel libraries and sets
  the kernels' attributes before any capture.  Its second call captures
  and replays, so a shape seen once never pays for a capture.
- At most :data:`MAX_GRAPHS` graphs a device, least recently used out,
  each with its own memory pool.  A key pushed out runs eager from then
  on, so callers rotating through more keys than fit settle with the
  most recent ones graphed and the rest eager, never capturing again.
- One lock a device holds a capture, or an input copy with its replay and
  output clones, so concurrent callers (the service's collector and a
  duplicates pass) never read each other's results: the clones are
  ordered on the stream before the next replay can overwrite the outputs.
- A capture that fails raises, as a kernel wrapper does.
- The kernel wrappers count their launches through :func:`count_launch`.
  On a capturing thread it adds to the capture's own tally, which every
  replay then adds to the launch counters, so they count the kernels that
  ran, whatever other threads launch meanwhile.

Spans and counters (``utils/timing.py``): a replay's host work is the span
``scan.replay``; the counters ``scan_graph_captures`` and
``scan_graph_replays`` count captures and replays (the replay that follows
a capture included).
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from pixelbox_tpu_torch.utils.timing import bump, span

#: Graphs kept a device.  A server's card holds ~16 keys: the service's
#: five buckets for each of its two scans (semantic, phash), the
#: duplicates pass's full and last batch for each, and the single-query
#: ``similar`` and phash search; twice that leaves room for a second
#: ``k`` or threshold.
MAX_GRAPHS = 32
#: Keys remembered as seen once (their next call captures), and as pushed
#: out (they stay eager).
SEEN_KEYS = 256

_capturing = threading.local()


def count_launch(launches: dict, name: str) -> None:
    """One launch of the kernel ``name``: added to ``launches``, or on a
    thread capturing a graph to that capture's tally (see the module)."""
    tally = getattr(_capturing, "tally", None)
    if tally is None:
        launches[name] += 1
    else:
        tally[name] = tally.get(name, 0) + 1


class CardGraph:
    """One chain captured on a card: a ``torch.cuda.CUDAGraph`` with its own
    memory pool, captured on a side stream that waits for the caller's."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, chain):
        """Capture ``chain()``; returns its outputs, the graph's static
        tensors (computed by the first :meth:`replay`)."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # thread_local: other threads' eager work goes on during a capture.
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = chain()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        cur.wait_stream(side)
        return out

    def replay(self) -> None:
        """Launch the graph on the current stream of its device."""
        self.graph.replay()


class _Entry:
    __slots__ = ("graph", "static_in", "out", "launches", "reads")

    def __init__(self, graph, static_in, out, launches, reads):
        self.graph, self.static_in, self.out = graph, static_in, out
        self.launches, self.reads = launches, reads

    def stale(self) -> bool:
        """Whether a tensor the chain reads has been freed."""
        return any(r.expired() for r in self.reads)


def _remember(keys: OrderedDict, key) -> None:
    keys[key] = None
    keys.move_to_end(key)
    while len(keys) > SEEN_KEYS:
        keys.popitem(last=False)


class GraphCache:
    """Graphs of a chain of device work, by key (see the module).
    ``launches`` is the launch counter dict the chain's kernel wrappers
    add to (``fused_scan.LAUNCHES``)."""

    def __init__(self, launches: dict):
        self.launches = launches
        self._graphs: OrderedDict = OrderedDict()
        self._seen: OrderedDict = OrderedDict()
        self._pushed_out: OrderedDict = OrderedDict()
        self._device_locks: dict = {}
        self._lock = threading.Lock()

    # The three card-specific steps, which tests replace.

    def _on_card(self, t: torch.Tensor) -> bool:
        return t.is_cuda

    def _stream(self, device: torch.device) -> int:
        return torch.cuda.current_stream(device).cuda_stream

    def _new_graph(self, device: torch.device):
        return CardGraph(device)

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, key, q: torch.Tensor, chain, reads=()):
        """``chain(q)`` — a tuple of device tensors — for the u8 queries
        ``q``: eager on a key's first call, captured on its second,
        replayed after.  ``key`` must determine everything the chain
        decides on the host; ``reads`` are the tensors it reads besides
        ``q``, their layout in ``key``."""
        if not self._on_card(q):
            return chain(q)
        dev = q.device
        key = (dev, self._stream(dev), key)
        with self._lock:
            entry = self._graphs.get(key)
            if entry is not None:
                self._graphs.move_to_end(key)
            else:
                self._drop_stale()
                eager = key not in self._seen       # first, or pushed out
                if key not in self._pushed_out:
                    _remember(self._seen, key)
            lock = self._device_locks.get(dev)
            if lock is None:
                lock = self._device_locks[dev] = threading.Lock()
        if entry is None and eager:
            return chain(q)
        with lock:
            if entry is None:
                with self._lock:
                    entry = self._graphs.get(key)
                if entry is None:
                    entry = self._capture(key, q, chain, reads)
            return self._replay(entry, q)

    def _drop_stale(self) -> None:
        """Drop the graphs whose tensors are gone (under ``_lock``)."""
        for key in [key for key, e in self._graphs.items() if e.stale()]:
            del self._graphs[key]

    def _capture(self, key, q, chain, reads) -> _Entry:
        """Capture ``chain`` on a static copy of ``q`` (under the device
        lock) and file the graph, pushing out its device's least recently
        used past :data:`MAX_GRAPHS`."""
        graph = self._new_graph(q.device)
        static_in = torch.empty_like(q)
        _capturing.tally = tally = {}
        try:
            out = graph.capture(lambda: chain(static_in))
        finally:
            _capturing.tally = None
        refs = tuple(StorageWeakRef(t.untyped_storage()) for t in reads)
        entry = _Entry(graph, static_in, out, tuple(tally.items()), refs)
        with self._lock:
            self._graphs[key] = entry
            self._seen.pop(key, None)
            mine = [k for k in self._graphs if k[0] == key[0]]
            for old in mine[: max(0, len(mine) - MAX_GRAPHS)]:
                del self._graphs[old]
                _remember(self._pushed_out, old)
        bump("scan_graph_captures")
        return entry

    def _replay(self, entry: _Entry, q):
        with span("scan.replay"):
            entry.static_in.copy_(q)
            entry.graph.replay()
            out = tuple(t.clone() for t in entry.out)
        for name, n in entry.launches:
            self.launches[name] += n
        bump("scan_graph_replays")
        return out
