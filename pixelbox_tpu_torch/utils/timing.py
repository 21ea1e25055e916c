"""Structured timing + profiling.

Every scope records into a process-wide registry that can be dumped as
JSON, and ``trace`` can wrap a scope in a ``torch.profiler`` annotation
(with an optional full trace written as a Chrome trace file).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Optional

_LOCK = threading.Lock()
_TIMINGS: Dict[str, deque] = defaultdict(lambda: deque(maxlen=1024))


@contextlib.contextmanager
def timed(name: str, echo: bool = False):
    """Record wall-clock seconds for a named scope."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            _TIMINGS[name].append(dt)
        if echo:
            print(f"[pixelbox_tpu_torch] {name}: {dt*1e3:.2f} ms")


@contextlib.contextmanager
def trace(name: str, trace_path: Optional[str] = None):
    """Timed scope that also emits a ``torch.profiler.record_function``
    annotation.  Pass ``trace_path`` to capture a CPU + CUDA profile of
    this scope as a Chrome trace file."""
    import torch

    prof = None
    if trace_path:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        with torch.profiler.record_function(name), timed(name):
            yield
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(trace_path)


def get_stats() -> Dict[str, dict]:
    """Summary stats {name: {count, total_s, mean_ms, last_ms}}."""
    out = {}
    with _LOCK:
        for name, samples in _TIMINGS.items():
            if not samples:
                continue
            total = sum(samples)
            out[name] = {
                "count": len(samples),
                "total_s": total,
                "mean_ms": total / len(samples) * 1e3,
                "last_ms": samples[-1] * 1e3,
            }
    return out


def dump_stats() -> str:
    return json.dumps(get_stats(), indent=2, sort_keys=True)


def reset_stats() -> None:
    with _LOCK:
        _TIMINGS.clear()
