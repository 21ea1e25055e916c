"""What the benchmark takes from the program (``pixelbox_tpu_torch``): the
engine it fills, the entries the windows drive, and the calls the traced
run wraps.  Nothing else in the harness imports the program.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: The calls into the scan-orchestration layer that the traced run wraps,
#: as (module, attribute, kind): the duplicates pass's semantic scan and
#: the Hamming scan (the pass imports it from its module at call time).
SCAN_CALLS = (
    ("pixelbox_tpu_torch.serving.duplicates", "cosine_scan_topk_auto", "cosine"),
    ("pixelbox_tpu_torch.ops.hamming_gemm", "hamming_gemm_scan_topk_auto", "hamming"),
)


def load_kernels() -> None:
    """Build (first run) or load (every later run) the scan kernels'
    libraries in parallel, as set-up."""
    from pixelbox_tpu_torch.ops import fused_scan as fs

    loads = (fs.load_kernels, fs.load_tc_kernels, fs.load_theta_kernels)
    with ThreadPoolExecutor(len(loads)) as pool:
        for f in [pool.submit(load) for load in loads]:
            f.result()


def new_engine(config: dict, db_path: str, device: str, precision: str | None = None,
               int4_rerank: bool = True):
    """An engine over a fresh catalog with the configuration's settings
    (tags-only embedder: the rows arrive as hashes)."""
    from pixelbox_tpu_torch.engine import Engine

    eng = Engine.new(
        db_path, embedder="none", dim=int(config["dim"]), device=device,
        semantic_precision=precision or config["precision"], int4_rerank=int4_rerank,
    )
    eng.scan_mode = config["scan_mode"]
    eng.max_search_results = int(config["max_search_results"])
    eng.max_distance_from_query = float(config["max_distance_from_query"])
    return eng


def append_library(engine, semantic: np.ndarray, phash: np.ndarray) -> None:
    """The engine's own store append, under the index write lock: image id
    ``row + 1`` for every row (a fresh catalog's ids)."""
    ids = list(range(1, semantic.shape[0] + 1))
    with engine.index_rwlock.write_locked():
        engine._append_hashes(ids, semantic, phash)


def launch_count() -> int:
    """Launches of the program's hand kernels so far (all counters)."""
    from pixelbox_tpu_torch.ops import fused_scan as fs

    return sum(fs.LAUNCHES.values())


def duplicate_scan(engine, by: str, k: int, max_distance: float):
    """The duplicates pass's own scan callable and its live rows (for the
    set-up's warm-up of the pass's shapes)."""
    store, _ids, groups = engine._duplicate_scans(by, k, max_distance)
    rows, scan = groups[0]
    return store, rows, scan
