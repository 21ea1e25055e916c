"""Guaranteed-exact Hamming scan over the packed u8 phash rows — the
counterpart of ``pixelbox_tpu/ops/hamming_gemm.py``.

The JAX package unpacks every hash bit to a ±1 int8 (``unpack_pm1``) so
that the TPU's matrix unit can compute Hamming distance as a dot product
(differing bits = (B − dot) / 2).  That layout is not ported: on the H100
the packed 32-byte row of a 16×16 phash is 8× fewer bytes than its
256-lane ±1 row, and xor + ``__popc`` over the packed words gives the
same integer.  The "GEMM index" of this module is therefore the packed
store index itself, and the kernels are K2a/K2b in ``ops/fused_scan.py``.
The public names stay, so a reader finds the JAX functions' counterparts.

The JAX ``mode="fast"`` rested on the TPU-only ``approx_min_k``; the port
has no such mode and serves those callers with the exact scan, as it does
for cosine.
"""

from __future__ import annotations

from typing import Optional

import torch

from pixelbox_tpu_torch.ops.fused_scan import (
    _as_queries,
    build_hamming_meta,
    fused_hamming_scan_topk,
    fused_hamming_threshold_scan_topk,
)
from pixelbox_tpu_torch.ops.packed import PackedHammingIndex
from pixelbox_tpu_torch.ops.scan import DEFAULT_BLOCK_ROWS, ScanSample, repair_unproven


def build_hamming_scan_sample(
    index: PackedHammingIndex,
    meta: Optional[torch.Tensor] = None,
    sample_rows: int = 65536,
) -> ScanSample:
    """Strided subsample for θ estimation: contiguous rows and the strided
    row mask (``meta`` from ``build_hamming_meta`` — pass the group-masked
    one, so the sample sees only the group's rows)."""
    if meta is None:
        meta = build_hamming_meta(index)
    cap = index.capacity
    stride = 1
    while stride * 2 <= max(1, cap // sample_rows) and cap % (stride * 2) == 0:
        stride *= 2
    return ScanSample(index.data[::stride].contiguous(), meta[::stride].contiguous())


def hamming_gemm_scan_topk(
    query_u8,
    index: PackedHammingIndex,
    k: int = 100,
    max_distance: float = 1e3,
    wrap_u8: bool = False,
    meta: Optional[torch.Tensor] = None,
    byte_limit: Optional[int] = None,
):
    """Exact top-k smallest normalized Hamming distances: K2b + K1c on a
    CUDA index, their plain versions on a CPU index.  Same result
    semantics as ``ops.scan.hamming_scan_topk`` (strict
    ``dist < max_distance``, idx -1 fill, ascending-id ties)."""
    if meta is None:
        meta = build_hamming_meta(index)
    return fused_hamming_scan_topk(
        query_u8, index, meta, k=k, max_distance=max_distance, wrap_u8=wrap_u8,
        byte_limit=byte_limit,
    )


def hamming_gemm_scan_topk_auto(
    query_u8,
    index: PackedHammingIndex,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    wrap_u8: bool = False,
    sample: Optional[ScanSample] = None,
    meta: Optional[torch.Tensor] = None,
    byte_limit: Optional[int] = None,
):
    """Guaranteed-exact Hamming scan at threshold-selection speed; results
    always equal :func:`hamming_gemm_scan_topk`.

    The Hamming twin of ``ops.scan.cosine_scan_topk_auto``: small indexes
    (capacity <= 4·block_rows, the JAX package's gate) scan exactly;
    otherwise the threshold scan (K2a + K1c) runs at every batch size —
    the JAX package's carry kernel (Q <= 512) and buffer kernel (Q > 512)
    are one design here — and unproven queries are re-scanned exactly
    (K2b + K1c) and spliced back.  ``meta`` (validity AND an optional
    group mask) and its ``sample`` are cached by the engine per store
    version.
    """
    q, squeeze = _as_queries(query_u8, index.device)
    if meta is None:
        meta = build_hamming_meta(index)

    def exact_scan(rq):
        return hamming_gemm_scan_topk(
            rq, index, k=k, max_distance=max_distance, wrap_u8=wrap_u8, meta=meta,
            byte_limit=byte_limit,
        )

    if index.capacity <= 4 * block_rows:
        best_d, best_i = exact_scan(q)
    else:
        if sample is None:
            sample = build_hamming_scan_sample(index, meta)
        best_d, best_i, exact = fused_hamming_threshold_scan_topk(
            q, index, meta, sample, k=k, max_distance=max_distance,
            wrap_u8=wrap_u8, byte_limit=byte_limit,
        )
        best_d, best_i = repair_unproven(q, best_d, best_i, exact, exact_scan)
    if squeeze:
        return best_d[0], best_i[0]
    return best_d, best_i
