"""The port's spans and counters: one recorder for the whole process.

``with span(name):`` times a scope.  Every span adds to its name's
aggregate (count, total, max and last duration), kept per thread and
merged when read (:func:`get_stats`), so a span takes no lock.  Off the
recording path a span is its thread's own object for that name, reused:
entering it reads the clock into a slot and leaving it adds to the
aggregate, so nothing is allocated per call.  ``wait=True`` marks a span
in which the host blocks on the card; a name is a wait or not, as its
first use says.

Between :func:`start_recording` and :func:`stop_recording` (or inside
``with recorded() as rec:``) every span is also kept whole, as a
:class:`Span` (name, span id, the id of the innermost span open on the
same thread, thread, start and end on ``time.perf_counter_ns``, the wait
flag), and every counter bump as a :class:`Bump` with its time.  The
records are handed out when recording stops; nothing is written to disk.

While a ``torch.profiler`` is active, the spans of :data:`ANNOTATED`
(every span, while recording) also open a profiler range under their
bare name, so they sit in the profiler's trace on the kernels' clock.

Counters (:data:`COUNTER_NAMES`, :func:`bump`, :func:`counters`) are
ints, always on, bumped where the event happens, kept per thread like
the aggregates and summed when read.  ``host_syncs`` is counted in the
span that makes the sync (``s.syncs += n``), at no call's cost.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_clock = time.perf_counter_ns
_ids = itertools.count(1)
_local = threading.local()
#: Guards the thread registry and the recording switch; no span takes it.
_LOCK = threading.Lock()
_THREADS: List["_ThreadState"] = []
#: Aggregates {name: [count, total_ns, max_ns, last_ns, end_ns]}, span
#: records and counts of threads that have ended.
_RETIRED: Dict[str, list] = {}
_RETIRED_SPANS: list = []
_BUMPS: list = []
_WAITS: set = set()
_recording = False

#: The spans that name a profiled run's idle time without recording: the
#: duplicates pass, its row gathers, each batch's scan and pair loop, and
#: the scan call's host stages.  The waits are left out: the host blocks
#: inside a torch operation there, which names the time itself.
ANNOTATED = frozenset({
    "engine.duplicate_scan", "dedup.gather", "dedup.scan", "dedup.pairs",
    "scan.prep", "scan.theta", "scan.collect", "scan.select",
})

#: Events counted where they happen.  ``host_syncs``: each point where a
#: scan blocks the host on a card (the queries' upload from host memory,
#: the proof's ``exact.all()``, the repair's ``nonzero``, each result
#: tensor copied from the card).  ``repaired_queries``: queries the
#: threshold pass could not prove, re-scanned exactly.
COUNTER_NAMES = ("host_syncs", "repaired_queries")
_RETIRED_COUNTS: Dict[str, int] = dict.fromkeys(COUNTER_NAMES, 0)

# A profiler range from C++, a few times cheaper than ``record_function``.
_Range = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    thread: int
    t0_ns: int
    t1_ns: int
    wait: bool


class Bump(NamedTuple):
    t_ns: int
    name: str
    n: int


@dataclass
class Recording:
    """What one recording kept: spans in start order, and counter bumps."""

    spans: List[Span] = field(default_factory=list)
    bumps: List[Bump] = field(default_factory=list)


class _ThreadState:
    __slots__ = ("thread", "sites", "stack", "spans", "counts")

    def __init__(self):
        self.thread = threading.current_thread()
        self.sites: Dict[str, _Site] = {}
        self.stack: List[int] = []     # ids of this thread's recorded spans still open
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = dict.fromkeys(COUNTER_NAMES, 0)


class _Site:
    """One span name on one thread: its aggregate, the host syncs counted
    in it, and, while a plain span of it is open, that span's start
    (``t0``, 0 when none is) and the site its chain has moved on to
    (``cur``, itself when none)."""

    __slots__ = ("name", "wait", "annotate", "ts", "t0", "cur", "syncs",
                 "count", "total", "max", "last", "end")

    def __init__(self, name: str, wait: bool, ts: _ThreadState):
        self.name, self.wait, self.ts = name, wait, ts
        self.annotate = name in ANNOTATED
        self.cur = self
        self.t0 = self.syncs = self.count = self.total = self.max = self.last = self.end = 0

    def __enter__(self):
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _clock()
        cur = self.cur
        dt = t1 - cur.t0
        cur.t0 = 0
        cur.count += 1
        cur.total += dt
        cur.last = dt
        cur.end = t1
        if dt > cur.max:
            cur.max = dt
        self.cur = self

    def then(self, name: str) -> None:
        """End the span open here and start span ``name`` in its place at
        the same clock reading; the ``with`` block's end ends the last."""
        t = _clock()
        cur = self.cur
        dt = t - cur.t0
        cur.t0 = 0
        cur.count += 1
        cur.total += dt
        cur.last = dt
        cur.end = t
        if dt > cur.max:
            cur.max = dt
        nxt = self.ts.sites.get(name) or _new_site(name, False)
        nxt.t0 = t
        self.cur = nxt

    def add(self, t0: int, t1: int) -> None:
        """Add a span from ``t0`` to ``t1`` to the aggregate (and the
        recording, as a child of the innermost recorded span open)."""
        dt = t1 - t0
        self.count += 1
        self.total += dt
        self.last = dt
        self.end = t1
        if dt > self.max:
            self.max = dt
        if _recording:
            stack = self.ts.stack
            self.ts.spans.append(Span(
                self.name, next(_ids), stack[-1] if stack else None,
                self.ts.thread.ident, t0, t1, self.wait,
            ))


class _Traced:
    """A span that is recorded, or opens a profiler range, or nests in an
    open span of its own name: one object a call."""

    __slots__ = ("site", "t0", "sid", "parent", "range", "syncs")

    def __init__(self, site: _Site):
        self.site = site
        self.syncs = 0

    def __enter__(self):
        self._open(self.site, _clock())
        return self

    def __exit__(self, exc_type, exc, tb):
        self._close(_clock())

    def then(self, name: str) -> None:
        """As :meth:`_Site.then`."""
        t = _clock()
        self._close(t)
        self._open(self.site.ts.sites.get(name) or _new_site(name, False), t)

    def _open(self, site: _Site, t: int) -> None:
        self.site = site
        self.range = None
        if (_recording or site.annotate) and _autograd_profiler._is_profiler_enabled:
            self.range = _Range(site.name)
            self.range.__enter__()
        self.sid = self.parent = None
        if _recording:
            stack = site.ts.stack
            self.sid, self.parent = next(_ids), (stack[-1] if stack else None)
            stack.append(self.sid)
        self.t0 = t

    def _close(self, t1: int) -> None:
        site = self.site
        if self.sid is not None:
            site.ts.stack.pop()
            if _recording:
                site.ts.spans.append(Span(
                    site.name, self.sid, self.parent, site.ts.thread.ident, self.t0, t1, site.wait,
                ))
        if self.range is not None:
            self.range.__exit__(None, None, None)
        if self.syncs:
            site.syncs += self.syncs
            if _recording:
                _BUMPS.append(Bump(t1, "host_syncs", self.syncs))
            self.syncs = 0
        dt = t1 - self.t0
        site.count += 1
        site.total += dt
        site.last = dt
        if t1 > site.end:
            site.end = t1
        if dt > site.max:
            site.max = dt


def span(name: str, wait: bool = False):
    """Context manager timing a scope under ``name`` (see the module).
    ``with span(...) as s:`` gives ``s.then(next_name)``, which chains a
    sibling span at one clock reading, and ``s.syncs``, to which the
    scope adds the host syncs it makes (the counter ``host_syncs``)."""
    try:
        site = _local.sites[name]
    except (AttributeError, KeyError):
        site = _new_site(name, wait)
    if site.t0 or _recording or (site.annotate and _autograd_profiler._is_profiler_enabled):
        return _Traced(site)
    return site


def add_span(name: str, t0_ns: int, t1_ns: int, wait: bool = False) -> None:
    """Record a span that began at ``t0_ns`` (``time.perf_counter_ns``,
    perhaps on another thread) and ends at ``t1_ns``, as a child of the
    innermost span open on this thread."""
    try:
        site = _local.sites[name]
    except (AttributeError, KeyError):
        site = _new_site(name, wait)
    site.add(t0_ns, t1_ns)


def _thread_state() -> _ThreadState:
    ts = getattr(_local, "ts", None)
    if ts is None:
        ts = _local.ts = _ThreadState()
        _local.sites, _local.counts = ts.sites, ts.counts
        with _LOCK:
            _retire_ended_threads()
            _THREADS.append(ts)
    return ts


def _new_site(name: str, wait: bool) -> _Site:
    ts = _thread_state()
    site = ts.sites[name] = _Site(name, wait, ts)
    if wait:
        _WAITS.add(name)
    return site


def _retire_ended_threads() -> None:
    """Fold the states of threads that have ended into ``_RETIRED`` (under
    ``_LOCK``), so a server's short-lived request threads leave one
    aggregate a name behind."""
    for ts in [t for t in _THREADS if not t.thread.is_alive()]:
        for site in tuple(ts.sites.values()):
            _merge(_RETIRED, site.name, (site.count, site.total, site.max, site.last, site.end))
            _RETIRED_COUNTS["host_syncs"] += site.syncs
        _RETIRED_SPANS.extend(ts.spans)
        for name, n in ts.counts.items():
            _RETIRED_COUNTS[name] += n
        _THREADS.remove(ts)


def _merge(out: dict, name: str, agg) -> None:
    count, total, mx, last, end = agg
    if not count:
        return
    cur = out.get(name)
    if cur is None:
        out[name] = [count, total, mx, last, end]
        return
    cur[0] += count
    cur[1] += total
    cur[2] = max(cur[2], mx)
    if end >= cur[4]:
        cur[3], cur[4] = last, end


def bump(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, one of :data:`COUNTER_NAMES` (logged
    with its time while recording)."""
    try:
        counts = _local.counts
    except AttributeError:
        counts = _thread_state().counts
    counts[name] += n
    if _recording:
        _BUMPS.append(Bump(_clock(), name, n))


def counters() -> Dict[str, int]:
    """Every counter's total over all threads."""
    with _LOCK:
        _retire_ended_threads()
        out = dict(_RETIRED_COUNTS)
        states = list(_THREADS)
    for ts in states:
        for name, n in tuple(ts.counts.items()):
            out[name] += n
        for site in tuple(ts.sites.values()):
            out["host_syncs"] += site.syncs
    return out


def get_stats() -> Dict[str, dict]:
    """Every span name's aggregate over all threads: {name: {count,
    total_s, mean_ms, last_ms, max_ms, wait}}."""
    merged: Dict[str, list] = {}
    with _LOCK:
        _retire_ended_threads()
        for name, agg in _RETIRED.items():
            _merge(merged, name, agg)
        sites = [s for ts in _THREADS for s in tuple(ts.sites.values())]
    for s in sites:
        _merge(merged, s.name, (s.count, s.total, s.max, s.last, s.end))
    return {
        name: {
            "count": count,
            "total_s": total * 1e-9,
            "mean_ms": total / count * 1e-6,
            "last_ms": last * 1e-6,
            "max_ms": mx * 1e-6,
            "wait": name in _WAITS,
        }
        for name, (count, total, mx, last, _end) in merged.items()
    }


def reset_stats() -> None:
    """Zero every span aggregate (counters keep counting)."""
    with _LOCK:
        _RETIRED.clear()
        for ts in _THREADS:
            for s in tuple(ts.sites.values()):
                s.count = s.total = s.max = s.last = s.end = 0


def start_recording() -> None:
    """Keep every span and counter bump from now until :func:`stop_recording`."""
    global _recording
    with _LOCK:
        for ts in _THREADS:
            ts.spans = []
        _RETIRED_SPANS.clear()
        _BUMPS.clear()
        _recording = True


def stop_recording() -> Recording:
    """Stop recording and hand out what was kept."""
    global _recording
    with _LOCK:
        _recording = False
        spans = list(_RETIRED_SPANS)
        _RETIRED_SPANS.clear()
        for ts in _THREADS:
            spans += ts.spans
            ts.spans = []
        bumps = list(_BUMPS)
        _BUMPS.clear()
    spans.sort(key=lambda s: (s.t0_ns, s.id))
    return Recording(spans, bumps)


@contextlib.contextmanager
def recorded():
    """``with recorded() as rec:`` records the block; ``rec`` is filled
    (a :class:`Recording`) when the block ends."""
    rec = Recording()
    start_recording()
    try:
        yield rec
    finally:
        done = stop_recording()
        rec.spans, rec.bumps = done.spans, done.bumps
