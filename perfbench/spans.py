"""Spans and counters of the traced run, taken from the benchmark's side.

In a ``--trace 1`` run the :class:`Recorder` wraps the calls into the
scan-orchestration layer (``program.SCAN_CALLS``), by patching module
attributes for that run only.  Each wrapped scan call records its host wall time, including the
copy of its results to the host (so that the call's device work ends
inside it), its hand-kernel launches and its needed work
(``roofline.ScanWork``).  The profiler (``torch.profiler``, CPU and CUDA
activity) runs for a short steady stretch after the measured window, in
the thread that makes the scan calls; :func:`reduce_profile` turns its
trace into device busy time, the device time inside the scan calls, the
device operations that took most time, and the idle gaps by what the
host was doing.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from perfbench import program
from perfbench.roofline import ScanWork, bound_s


@dataclass
class Call:
    t0: float
    t1: float
    work: ScanWork
    launches: int
    profiled: bool = False


@dataclass
class Profile:
    window_s: float
    busy_s: float
    call_kernel_s: float       # Σ kernel time inside the profiled scan calls
    call_bound_s: float        # Σ their roofline time
    device_ops: list
    idle_gaps: list


@dataclass
class Trace:
    """What a per-layer metric's reader reads: the measured window's scan
    calls and passes, and the profiled stretch."""

    window_s: float
    calls: List[Call]
    passes: list                  # (t0, t1, scan calls) of whole passes
    profile: Optional[Profile] = None


class Recorder:
    """Wraps the program's scan calls for one traced run."""

    def __init__(self, live_rows: dict, profile_seconds: float):
        self.live_rows = live_rows          # {"cosine": n, "hamming": n}
        self.calls: List[Call] = []
        self.profile_seconds = profile_seconds
        self.profile_from: Optional[float] = None
        self.profile_done = threading.Event()
        self.trace_events: Optional[list] = None
        self._prof = None
        self._prof_t0 = 0.0
        self._undo: list = []

    # -- patching ----------------------------------------------------------- #

    def install(self) -> None:
        import torch

        # Start the profiler once on the main thread first: its one-time
        # set-up (CUPTI) is then set-up here, not inside the stretch.
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
        for mod_name, attr, kind in program.SCAN_CALLS:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            setattr(mod, attr, self._wrap_scan(orig, kind))
            self._undo.append((mod, attr, orig))

    def uninstall(self) -> None:
        self.stop_profile()
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def _wrap_scan(self, orig, kind):
        import torch

        sig = inspect.signature(orig)
        rec = self

        def scan(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            q, index = bound.arguments["query_u8"], bound.arguments["index"]
            work = ScanWork(kind, int(q.shape[0]), rec.live_rows[kind], int(index.capacity),
                            int(index.dim), int(bound.arguments["k"]))
            t0 = time.perf_counter()
            rec._profile_tick(t0)
            profiled = rec._prof is not None
            label = f"pb.scan_call#{len(rec.calls)}" if profiled else ""
            l0 = program.launch_count()
            ctx = torch.profiler.record_function(label) if profiled else contextlib.nullcontext()
            with ctx:
                dist, idx = orig(*args, **kwargs)
                dist, idx = dist.cpu(), idx.cpu()
            rec.calls.append(Call(t0, time.perf_counter(), work,
                                  program.launch_count() - l0, profiled))
            return dist, idx

        return scan

    # -- the profiled stretch ----------------------------------------------- #

    def start_profile_at(self, t: float) -> None:
        """Profile from the first scan call at or after ``t`` for
        ``profile_seconds``."""
        self.profile_from = t

    def _profile_tick(self, now: float) -> None:
        import torch

        if self.profile_from is None or self.profile_done.is_set():
            return
        if self._prof is None and now >= self.profile_from:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._prof_t0 = time.perf_counter()
        elif self._prof is not None and now - self._prof_t0 >= self.profile_seconds:
            self.stop_profile()

    def stop_profile(self) -> None:
        """Stop the profiler (in the thread that started it) and keep its
        events."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace_events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.profile_done.set()

    def profile(self) -> Optional[Profile]:
        if not self.trace_events:
            return None
        bounds = {i: bound_s(c.work)[0] for i, c in enumerate(self.calls) if c.profiled}
        return reduce_profile(self.trace_events, bounds)


# -------------------------------------------------------------------------- #

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_profile(events: list, call_bounds: dict, top: int = 10) -> Optional[Profile]:
    """Reduce a chrome trace of the profiled stretch.

    ``call_bounds``: {scan call index: its roofline seconds} for the calls
    made while the profiler ran; a kernel belongs to a call when it ran
    inside the call's ``pb.scan_call#<i>`` annotation (the call ends with
    the copy of its results to the host, so its kernels end inside it)."""
    spans = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    device = [e for e in spans if e.get("cat") in _DEVICE_CATS]
    host = [e for e in spans if e.get("cat") in ("cpu_op", "user_annotation")]
    if not device:
        return None
    t_lo = min(e["ts"] for e in spans)
    t_hi = max(e["ts"] + e["dur"] for e in spans)
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in device])
    busy_us = sum(e - s for s, e in busy)

    calls = sorted((e["ts"], e["ts"] + e["dur"], int(e["name"].split("#", 1)[1]))
                   for e in host if e.get("name", "").startswith("pb.scan_call#"))
    calls = [c for c in calls if c[2] in call_bounds]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in device if e.get("cat") == "kernel")
    kern_us, seen, j = 0.0, set(), 0
    for s, t, i in calls:       # calls do not overlap: one thread makes them
        while j < len(kernels) and kernels[j][0] < s:
            j += 1
        while j < len(kernels) and kernels[j][1] <= t + 1.0:
            kern_us += kernels[j][1] - kernels[j][0]
            seen.add(i)
            j += 1
    bound = sum(call_bounds[i] for i in seen)

    by_name: dict = {}
    for e in device:
        name = _short(e.get("name", "?"))
        by_name[name] = by_name.get(name, 0.0) + e["dur"] * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    edges = [t_lo] + [x for se in busy for x in se] + [t_hi]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    by_label: dict = {}
    for (s, e), label in zip(gaps, _host_labels(host, [(s + e) / 2 for s, e in gaps])):
        by_label[label] = by_label.get(label, 0.0) + (e - s) * 1e-6
    idle_gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]

    return Profile((t_hi - t_lo) * 1e-6, busy_us * 1e-6, kern_us * 1e-6, bound,
                   [list(x) for x in device_ops], [list(x) for x in idle_gaps])


def _host_labels(host: list, times: list) -> list:
    """What the host was doing at each of the ascending ``times``: the
    benchmark span and the innermost operation that enclose it (one sweep
    over the host events in start order)."""
    events = sorted(host, key=lambda e: e["ts"])
    active, j, out = [], 0, []
    for t in times:
        while j < len(events) and events[j]["ts"] <= t:
            active.append(events[j])
            j += 1
        active = [e for e in active if e["ts"] + e["dur"] >= t]
        names = {e.get("name", "").split("#")[0] for e in active}
        where = "scan call" if "pb.scan_call" in names else "host outside the scan calls"
        ops = [e for e in active if not e.get("name", "").startswith("pb.")]
        out.append(where if not ops else
                   f"{where}: {_short(min(ops, key=lambda e: e['dur']).get('name', '?'))}")
    return out


def _short(name: str, most: int = 160) -> str:
    """A kernel's name without its parameter list, cut to ``most``."""
    depth = 0
    for i in range(len(name) - 1, -1, -1) if name.endswith(")") else ():
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            if "::" in name[:i]:
                name = name[:i]
            break
    return name[:most]
