"""IVF (inverted-file) clustered index — opt-in ANN over the u8 store
(torch port of ``ops/ivf.py``).

The exact scans keep the reference's semantics (every row per query,
src/engine.rs:375-383).  This module adds the standard next rung for
libraries of 10M rows and more: spherical k-means clusters the index,
queries probe only the ``nprobe`` nearest clusters, and candidate
distances are computed with the SAME exact integer spec as the flat scan,
so returned distances are true u8 reciprocal-cosine values (or the
asymmetric int4 metric for int4 buckets) — only the candidate
*selection* is approximate.

- k-means (:func:`spherical_kmeans`, :func:`assign_rows_u8`) is stock
  torch, as the JAX package left it to XLA: an f32 ``torch.matmul`` of
  unit rows against the centroids (TF32 off, ``utils/device.
  hold_exact_numerics``), ``argmax``, and the segment sum as a second
  GEMM (one-hot^T @ unit rows).  The initial pick is the JAX package's
  ``np.random.default_rng(seed).choice``, so both start from the same
  rows.
- Buckets are FIXED-CAPACITY.  Rows beyond a cluster's capacity spill
  into a dense side index that every query scans exactly, so
  ``nprobe == n_clusters`` equals the exact flat scan, ties included.
- The probe (:func:`ivf_scan_topk`): the centroid scores are an f32
  ``torch.matmul``, the top ``nprobe`` a stable descending sort (ties to
  the lower cluster id, as ``lax.top_k``).  The hand-written kernel K5
  (:func:`ivf_probe_topk`, ``csrc/ivf_probe.cu``: a probed bucket read
  once a batch, in place, as int8 ``wgmma``'s operand for the queries
  that probe it) gives each (query, bucket)'s top k' = min(k, cap) — the
  JAX package's per-bucket top-k — and K1c (``fused_scan.lex_topk``)
  takes the top k of those by (dist, row id), equal to the JAX tree merge
  since a row sits in one bucket.  The spill is scanned
  by the port's exact scan (K1b/K4b + K1c) and K1c merges the two.  On a
  CPU index every kernel is its plain version.

Multi-device: ``parallel/sharded_ivf`` rides this index shape over the
port's mesh (per-shard buckets with global row ids, the same probe per
shard, a K1c merge).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import topk as topk_ops
from pixelbox_tpu_torch.ops.distances import _f32, rsqrt_spec
from pixelbox_tpu_torch.ops.int4 import PackedSemantic4Index, semantic4_rows_from_u8
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8
from pixelbox_tpu_torch.utils.device import resolve_device


class IVFIndex(NamedTuple):
    """Device tensors of a clustered index (the JAX ``IVFIndex``'s fields).

    ``bucket_rows`` maps bucket slots back to store row ids (-1 = pad).
    ``spill``/``spill_rows`` hold overflow rows scanned exactly by every
    query (an empty spill has capacity 0); ``spill_meta`` is the spill's
    kernel meta (``fused_scan.build_row_meta``), built once with the spill
    — the one field the JAX ``IVFIndex`` does not have.

    Two packings share this shape: "u8" (``bucket_data`` int8 [C, cap,
    D], centered codes u8 − 128, the exact u8 reciprocal-cosine spec) and
    "int4" (uint8 [C, cap, D/2] packed nibbles, the asymmetric int4 spec
    ``cosine4a``; callers rerank with the exact u8 metric).  The packing
    is recovered from the dtype.
    """

    centroids: torch.Tensor     # f32 [C, D] unit vectors
    bucket_data: torch.Tensor   # int8 [C, cap, D] | uint8 [C, cap, D/2]
    bucket_sum: torch.Tensor    # int32 [C, cap]
    bucket_mag2: torch.Tensor   # int32 [C, cap]
    bucket_rows: torch.Tensor   # int32 [C, cap]
    bucket_valid: torch.Tensor  # bool [C, cap]
    spill: object               # PackedSemanticIndex | PackedSemantic4Index
    spill_rows: torch.Tensor    # int32 [S_pad]
    spill_meta: torch.Tensor    # int32 [4, S_pad]

    @property
    def n_clusters(self) -> int:
        return self.bucket_data.shape[0]

    @property
    def bucket_cap(self) -> int:
        return self.bucket_data.shape[1]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def kind(self) -> str:
        """Distance kind implied by the bucket packing."""
        return "cosine4a" if self.bucket_data.dtype == torch.uint8 else "cosine"

    @property
    def spill_count(self) -> int:
        return int(self.spill.capacity)

    @property
    def device(self) -> torch.device:
        return self.bucket_data.device


def _unit_rows_f32(rows_u8: np.ndarray) -> np.ndarray:
    """Centered (2q-255) rows, unit-normalized, f32 (host)."""
    x = (2.0 * rows_u8.astype(np.float32)) - 255.0
    norm = np.sqrt(np.sum(x * x, axis=-1, keepdims=True))
    return x / np.maximum(norm, 1e-6)


def _centered_f32(blk_u8: torch.Tensor) -> torch.Tensor:
    return 2.0 * blk_u8.to(torch.float32) - 255.0


@torch.no_grad()
def _kmeans_step(centroids, rows_u8, valid, block_rows: int):
    """One Lloyd iteration (the JAX ``_kmeans_step``) over device rows
    ``rows_u8`` uint8 [N, D] and ``valid`` [N]: returns (new unit
    centroids [C, D] f32, objective)."""
    c, d = centroids.shape
    dev = centroids.device
    sums = torch.zeros((c, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((c,), dtype=torch.float32, device=dev)
    obj = torch.zeros((), dtype=torch.float32, device=dev)
    ids = torch.arange(c, device=dev)
    for s in range(0, rows_u8.shape[0], block_rows):
        xb = _centered_f32(rows_u8[s : s + block_rows])
        blk_valid = valid[s : s + block_rows]
        inv = torch.rsqrt(torch.clamp(torch.sum(xb * xb, dim=-1, keepdim=True), min=1e-12))
        xu = xb * inv
        scores = torch.matmul(xu, centroids.T)
        best, a = torch.max(scores, dim=-1)
        onehot = ((a[:, None] == ids[None, :]) & blk_valid[:, None]).to(torch.float32)
        # The segment sum as a GEMM: [C, B] x [B, D].
        sums += torch.matmul(onehot.T, xu)
        counts += onehot.sum(dim=0)
        obj += torch.where(blk_valid, best, torch.zeros_like(best)).sum()
    mean = sums / torch.clamp(counts, min=1.0)[:, None]
    norm = torch.sqrt(torch.sum(mean * mean, dim=-1, keepdim=True))
    ok = (counts[:, None] > 0) & (norm > 1e-6)
    return torch.where(ok, mean / torch.clamp(norm, min=1e-6), centroids), obj


@torch.no_grad()
def _assign_rows(centroids, rows_u8, block_rows: int) -> torch.Tensor:
    """Nearest-centroid id per row (by cosine), [N] int32 on the rows'
    device; argmax over unit centroids is row-norm invariant (no rsqrt)."""
    out = []
    for s in range(0, rows_u8.shape[0], block_rows):
        scores = torch.matmul(_centered_f32(rows_u8[s : s + block_rows]), centroids.T)
        out.append(torch.argmax(scores, dim=-1).to(torch.int32))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.int32, device=rows_u8.device)


def spherical_kmeans(
    rows_u8: np.ndarray,
    valid: np.ndarray,
    n_clusters: int,
    iters: int = 15,
    seed: int = 0,
    block_rows: int = 65536,
    device="cuda",
) -> np.ndarray:
    """Train unit centroids over the valid u8 rows on ``device``.
    Returns f32 [C, D] (host)."""
    rows_u8 = np.asarray(rows_u8, dtype=np.uint8)
    valid = np.asarray(valid, dtype=bool)
    live = np.flatnonzero(valid)
    n_clusters = int(max(1, min(n_clusters, live.size)))
    rng = np.random.default_rng(seed)
    pick = rng.choice(live, size=n_clusters, replace=False)
    dev = resolve_device(device)
    centroids = torch.from_numpy(_unit_rows_f32(rows_u8[pick])).to(dev)
    block_rows = int(min(block_rows, max(8, rows_u8.shape[0])))
    rows_dev = torch.from_numpy(rows_u8).to(dev)
    valid_dev = torch.from_numpy(valid).to(dev)
    for _ in range(int(iters)):
        centroids, _ = _kmeans_step(centroids, rows_dev, valid_dev, block_rows)
    return centroids.cpu().numpy()


def assign_rows_u8(
    rows_u8: np.ndarray, centroids: np.ndarray, block_rows: int = 65536, device="cuda"
) -> np.ndarray:
    """Nearest-centroid assignment for u8 rows, [n] int32 (host)."""
    rows_u8 = np.asarray(rows_u8, dtype=np.uint8)
    if rows_u8.shape[0] == 0:
        return np.zeros((0,), dtype=np.int32)
    dev = resolve_device(device)
    block_rows = int(min(block_rows, max(8, rows_u8.shape[0])))
    cents = torch.from_numpy(np.array(centroids, dtype=np.float32)).to(dev)
    return _assign_rows(cents, torch.from_numpy(rows_u8).to(dev), block_rows).cpu().numpy()


def default_n_clusters(n_live: int) -> int:
    """~4·sqrt(N) clusters: 1M rows → 4,096 clusters → mean 256 rows a
    bucket; the default nprobe (:func:`default_nprobe`) then probes ~4%
    of the rows."""
    n_live = int(max(1, n_live))
    return max(1, min(n_live, int(round(4.0 * n_live ** 0.5))))


def default_nprobe(n_clusters: int) -> int:
    """The recall-governed default probe count: 2% of the clusters, floor
    8 (the JAX package's policy; the bucket cap is 2× the mean cluster,
    so 2% of the clusters is ~4% of the rows).  ``--nprobe`` overrides."""
    n_clusters = int(max(1, n_clusters))
    return max(1, min(n_clusters, max(8, -(-2 * n_clusters // 100))))


def default_bucket_cap(n_live: int, n_clusters: int) -> int:
    """2x the mean cluster size, rounded up to a multiple of 8."""
    mean = max(1, -(-n_live // max(1, n_clusters)))
    return -(-2 * mean // 8) * 8


def _spill_rows_fn(precision: str):
    """(row-moments fn, index type) of a spill packing."""
    if precision == "int4":
        return semantic4_rows_from_u8, PackedSemantic4Index
    return semantic_rows_from_u8, PackedSemanticIndex


def spill_pad(n: int) -> int:
    """Spill capacity for ``n`` live rows: 8·next_pow2(ceil(n/8)) (the
    JAX package's: pow2 capacities keep the spill's shapes few across
    incremental appends)."""
    if n == 0:
        return 0
    units = -(-n // 8)
    p = 1
    while p < units:
        p *= 2
    return 8 * p


def _to_dev(arrays, dev):
    return tuple(torch.from_numpy(np.array(a, order="C")).to(dev) for a in arrays)


def _pack_spill(rows_u8: np.ndarray, row_ids: np.ndarray, d: int, precision: str = "u8",
                device="cuda"):
    """Pack spill rows (host, ascending row id) into a pow2-padded packed
    index (u8 or int4 layout) on ``device``: (index, row-id map, meta)."""
    rows_fn, index_cls = _spill_rows_fn(precision)
    dev = resolve_device(device)
    n = len(rows_u8)
    if n == 0:
        spill = _empty_spill(d, precision, dev)
        return spill, torch.zeros((0,), dtype=torch.int32, device=dev), fs.build_row_meta(spill)
    s_pad = spill_pad(n)
    s_mat = np.zeros((s_pad, d), dtype=np.uint8)
    s_mat[:n] = rows_u8
    s_valid = np.zeros(s_pad, dtype=bool)
    s_valid[:n] = True
    s_ids = np.full(s_pad, -1, dtype=np.int32)
    s_ids[:n] = row_ids
    sd, ss, sm = rows_fn(s_mat)
    spill = index_cls(*_to_dev((sd, ss, sm, s_valid), dev))
    return spill, torch.from_numpy(s_ids).to(dev), fs.build_row_meta(spill)


def live_spill_ids(ivf: IVFIndex) -> np.ndarray:
    """Store row ids currently held in the spill (host, ascending)."""
    ids = ivf.spill_rows.cpu().numpy()
    return ids[ids >= 0]


def rebuild_spill(ivf: IVFIndex, rows_u8: np.ndarray, spill_ids: np.ndarray) -> IVFIndex:
    """A new index sharing ``ivf``'s buckets and centroids, its spill
    rebuilt from ``rows_u8[spill_ids]`` — the incremental-append path
    (O(spill + delta) host work and transfer).  ``spill_ids`` must ascend
    (the scan's row-id tie contract)."""
    spill_ids = np.asarray(spill_ids, dtype=np.int64)
    precision = "int4" if ivf.kind == "cosine4a" else "u8"
    spill, spill_rows, spill_meta = _pack_spill(
        rows_u8[spill_ids], spill_ids.astype(np.int32), ivf.dim, precision=precision,
        device=ivf.device,
    )
    return ivf._replace(spill=spill, spill_rows=spill_rows, spill_meta=spill_meta)


def _empty_spill(d: int, precision: str, dev):
    rows_fn, index_cls = _spill_rows_fn(precision)
    data, s, m = rows_fn(np.zeros((0, d), dtype=np.uint8))
    return index_cls(*_to_dev((data, s, m, np.zeros((0,), dtype=bool)), dev))


def _device_pack_min() -> int:
    return int(os.environ.get("PIXELBOX_IVF_DEVICE_PACK_MIN", str(128 * 1024)))


def _device_pack(n: int) -> bool:
    """The JAX package's routing: builds of at least
    ``PIXELBOX_IVF_DEVICE_PACK_MIN`` rows pack on the device (the host
    packer's numpy moments are the wall there) unless
    ``PIXELBOX_IVF_HOST_PACK=1``; both packers give the same arrays."""
    return n >= _device_pack_min() and os.environ.get("PIXELBOX_IVF_HOST_PACK") != "1"


def pack_buckets(rows_u8, valid, centroids, bucket_cap: int, row_ids, precision: str = "u8",
                 device="cuda"):
    """Size-dispatched bucket pack (the :func:`pack_buckets_host`
    contract): large shards pack on the device."""
    if _device_pack(len(rows_u8)):
        from pixelbox_tpu_torch.ops.ivf_build import pack_buckets_device_np

        return pack_buckets_device_np(
            rows_u8, valid, centroids, bucket_cap, row_ids, precision=precision, device=device
        )
    return pack_buckets_host(
        rows_u8, valid, centroids, bucket_cap, row_ids, precision=precision, device=device
    )


def pack_buckets_host(rows_u8, valid, centroids, bucket_cap: int, row_ids,
                      precision: str = "u8", device="cuda"):
    """Host-side bucket packing shared by the single-device and sharded
    builders (the assignment GEMM runs on ``device``).  Returns numpy
    (bucket_data [C,cap,D] int8 | [C,cap,D/2] uint8 for int4, bucket_sum,
    bucket_mag2, bucket_rows, bucket_valid, spill_pos) — ``spill_pos``
    are ascending positions into ``rows_u8``.  Assignment runs on the
    full-u8 rows; only the stored codes quantize."""
    rows_u8 = np.asarray(rows_u8, dtype=np.uint8)
    valid = np.asarray(valid, dtype=bool)
    row_ids = np.asarray(row_ids)
    n, d = rows_u8.shape
    live = np.flatnonzero(valid)
    c = centroids.shape[0]
    assign = np.full(n, -1, dtype=np.int32)
    if live.size:
        assign[live] = assign_rows_u8(rows_u8[live], centroids, device=device)

    bdata = np.zeros((c, bucket_cap, d), dtype=np.uint8)
    brows = np.full((c, bucket_cap), -1, dtype=np.int32)
    bvalid = np.zeros((c, bucket_cap), dtype=bool)
    # Stable sort by cluster; rank within the cluster = position minus
    # the cluster's start; rank >= cap spills.
    live_assign = assign[live]
    order = np.argsort(live_assign, kind="stable")
    sl = live[order]
    sa = live_assign[order]
    counts = np.bincount(sa, minlength=c)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(sl), dtype=np.int64) - starts[sa]
    in_bucket = rank < bucket_cap
    bp, bc, br = sl[in_bucket], sa[in_bucket], rank[in_bucket]
    bdata[bc, br] = rows_u8[bp]
    brows[bc, br] = row_ids[bp]
    bvalid[bc, br] = True
    # Ascending row order keeps the spill scan's tie-break on the (dist,
    # row id) contract.
    spill_pos = np.sort(sl[~in_bucket])

    flat = bdata.reshape(c * bucket_cap, d)
    rows_fn, _ = _spill_rows_fn(precision)
    data, bsum, bmag2 = rows_fn(flat)
    return (
        data.reshape(c, bucket_cap, -1),
        bsum.reshape(c, bucket_cap),
        bmag2.reshape(c, bucket_cap),
        brows,
        bvalid & (brows >= 0),
        spill_pos,
    )


def build_ivf(
    rows_u8: np.ndarray,
    valid: np.ndarray,
    centroids: np.ndarray,
    bucket_cap: Optional[int] = None,
    row_ids: Optional[np.ndarray] = None,
    precision: str = "u8",
    device="cuda",
) -> IVFIndex:
    """Pack valid rows into fixed-capacity buckets on ``device``.

    ``row_ids`` default to positions in ``rows_u8`` (the store's row ids).
    Overflow past ``bucket_cap`` goes to the exact-scanned spill.
    ``precision="int4"`` packs nibble buckets at half the memory.  Builds
    of ``PIXELBOX_IVF_DEVICE_PACK_MIN`` rows and more pack on the device
    (``ops/ivf_build.build_ivf_device``), with the same arrays.
    """
    rows_u8 = np.asarray(rows_u8, dtype=np.uint8)
    valid = np.asarray(valid, dtype=bool)
    n, d = rows_u8.shape
    if row_ids is None:
        row_ids = np.arange(n, dtype=np.int32)
    if _device_pack(n):
        from pixelbox_tpu_torch.ops.ivf_build import build_ivf_device

        return build_ivf_device(
            rows_u8, valid, centroids, bucket_cap=bucket_cap, row_ids=row_ids,
            precision=precision, device=device,
        )
    if bucket_cap is None:
        bucket_cap = default_bucket_cap(int(valid.sum()), centroids.shape[0])
    bucket_cap = int(max(8, bucket_cap))
    bdata, bsum, bmag2, brows, bvalid, spill_pos = pack_buckets_host(
        rows_u8, valid, centroids, bucket_cap, row_ids, precision=precision, device=device
    )
    spill = _pack_spill(
        rows_u8[spill_pos], np.asarray(row_ids)[spill_pos], d, precision=precision, device=device
    )
    dev = resolve_device(device)
    return IVFIndex(
        torch.from_numpy(np.array(centroids, dtype=np.float32)).to(dev),
        *_to_dev((bdata, bsum, bmag2, brows, bvalid), dev),
        *spill,
    )


def ivf_from_jax(arrays, device="cuda") -> IVFIndex:
    """The port's :class:`IVFIndex` on ``device`` from a JAX ``IVFIndex``'s
    fields as numpy arrays (e.g. the JAX index mapped through
    ``np.asarray``), in the JAX field order — so that one packed index
    runs through both packages."""
    dev = resolve_device(device)
    (cents, bdata, bsum, bmag2, brows, bvalid, spill, spill_rows) = arrays
    kind_cls = PackedSemantic4Index if np.asarray(bdata).dtype == np.uint8 else PackedSemanticIndex
    spill = kind_cls(*_to_dev((np.asarray(spill[0]), np.asarray(spill[1], np.int32),
                               np.asarray(spill[2], np.int32), np.asarray(spill[3], bool)), dev))
    return IVFIndex(
        *_to_dev((np.asarray(cents, np.float32), np.asarray(bdata), np.asarray(bsum, np.int32),
                  np.asarray(bmag2, np.int32), np.asarray(brows, np.int32),
                  np.asarray(bvalid, bool)), dev),
        spill,
        torch.from_numpy(np.array(spill_rows, np.int32)).to(dev),
        fs.build_row_meta(spill),
    )


# --------------------------------------------------------------------- #
# K5: the probed buckets' top-k (csrc/ivf_probe.cu)

_IVF_KERNELS = None
_IVF_KERNELS_LOCK = threading.Lock()
_IVF_SOURCES = ("ivf_probe.cu",)
#: Bytes of the [Q, nprobe · k'] (dist, id) partials one block of queries
#: fills (the probe cuts a batch into query blocks under it).
IVF_PROBE_BYTES = 256 << 20
_NO_ROW = 2 ** 31 - 1
#: Element budget of the plain K5's gathered [Q, probes, cap, D] block.
_PLAIN_PROBE_ELEMS = 1 << 24
#: Queries one launch of the first port's K5 takes (its grid's y dimension).
_MAX_GRID_Y = 65535
#: (query, probe) pairs of a work item of the tensor-core K5 (its wgmma N;
#: ``kProbeNQ`` in ``csrc/ivf_probe.cu``).
IVF_PROBE_NQ = 8
#: The largest bucket cap the tensor-core K5 selects in (its [NQ, cap] keys
#: in shared memory; ``kSelectMaxCap``): past it every slot is written.
IVF_SELECT_MAX_CAP = 2048
#: The largest bucket cap the tensor-core K5 takes (a bucket's slot meta in
#: shared memory; ``kTcMaxCap``); larger caps take the first port's kernel.
IVF_TC_MAX_CAP = 8192
#: Buckets whose counters the inversion kernel keeps in shared memory
#: (``kInvertSmemBuckets``); more take a scratch buffer.
_INVERT_SMEM_BUCKETS = 16384


def load_ivf_kernels():
    """Compile ``csrc/ivf_probe.cu`` (K5, its work list, the first port's
    K5 and the gathered mode) for sm_90a into its own library, beside the
    scan kernels', so that the builds run in parallel.  Raises on any
    failure — there is no fallback."""
    global _IVF_KERNELS
    with _IVF_KERNELS_LOCK:
        if _IVF_KERNELS is None:
            kern = fs.build_library(_IVF_SOURCES, "libpixelbox_ivf_probe")
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            kern.lib.px_ivf_invert.restype = ci
            kern.lib.px_ivf_invert.argtypes = [vp, ci, ci, vp, vp, vp]
            kern.lib.px_ivf_probe_topk.restype = ci
            kern.lib.px_ivf_probe_topk.argtypes = [vp] * 4 + [cf] + [vp] * 7 + [ci] * 7 + [vp] * 3
            kern.lib.px_ivf_probe_collect_dp4a.restype = ci
            kern.lib.px_ivf_probe_collect_dp4a.argtypes = [vp] * 4 + [cf] + [vp] * 6 + [ci] * 6 + [vp] * 3
            kern.lib.px_ivf_gathered_collect.restype = ci
            kern.lib.px_ivf_gathered_collect.argtypes = [vp] * 4 + [cf] + [vp] * 2 + [ci] * 4 + [vp] * 3
            _IVF_KERNELS = kern
        return _IVF_KERNELS


def _check_probe_args(q_codes, q_sum, q_mag2, qr, bids, bucket_data, bucket_sum, bucket_mag2,
                      bucket_rows, bucket_valid):
    dev = bucket_data.device
    qn, d = q_codes.shape
    c, cap = bucket_data.shape[:2]
    req = fs._require
    req(q_codes, "q_codes", torch.int8, (qn, d), dev)
    req(q_sum, "q_sum", torch.int32, (qn,), dev)
    req(q_mag2, "q_mag2", torch.int32, (qn,), dev)
    req(qr, "qr", torch.float32, (qn,), dev)
    req(bids, "bids", torch.int32, (qn, bids.shape[1]), dev)
    if bucket_data.dtype == torch.uint8:
        if d % 2:
            raise ValueError(f"int4 buckets pack two dims a byte; query width {d} is odd")
        req(bucket_data, "bucket_data", torch.uint8, (c, cap, d // 2), dev)
    else:
        req(bucket_data, "bucket_data", torch.int8, (c, cap, d), dev)
    for t, name in ((bucket_sum, "bucket_sum"), (bucket_mag2, "bucket_mag2"),
                    (bucket_rows, "bucket_rows")):
        req(t, name, torch.int32, (c, cap), dev)
    req(bucket_valid, "bucket_valid", torch.bool, (c, cap), dev)
    if bucket_data.data_ptr() % 16:
        raise ValueError("bucket_data must be 16-byte aligned")
    return dev, qn, d, c, cap


def tc_probe_width(d: int, int4: bool, cap: int) -> bool:
    """Whether the tensor-core K5 takes queries of width d over u8 (or,
    ``int4``, packed int4) buckets of ``cap`` slots: K1a's and K4a's
    widths, and caps that are multiples of 4 (the kernel copies a bucket's
    slot meta 16 bytes at a time; the packs' default caps are multiples of
    8) up to :data:`IVF_TC_MAX_CAP` (the meta in shared memory)."""
    return ((d in fs.TC_COSINE4_DIMS if int4 else d in fs.TC_COSINE_DIMS) and cap % 4 == 0
            and cap <= IVF_TC_MAX_CAP)


def shares_buckets(qn: int, nprobe: int, n_clusters: int) -> bool:
    """Whether the tensor-core K5 inverts the probe list first: where the
    batch's probes outnumber the buckets (some bucket is likely probed by
    several queries: each is then read once for them all).  Else every
    (query, probe) is its own work item — always at Q = 1."""
    return qn * nprobe > n_clusters


def probe_width(k: int, cap: int, d: int, int4: bool) -> int:
    """Entries per (query, probe) that :func:`ivf_probe_topk` returns: k'
    = min(k, cap) where the tensor-core K5 selects (its widths, caps up
    to :data:`IVF_SELECT_MAX_CAP`), else the cap (every slot)."""
    if tc_probe_width(d, int4, cap) and cap <= IVF_SELECT_MAX_CAP:
        return max(1, min(int(k), cap))
    return cap


def ivf_probe_topk(q_codes, q_sum, q_mag2, qr, max_distance, bids, bucket_data, bucket_sum,
                   bucket_mag2, bucket_rows, bucket_valid, k: int):
    """K5: per (query, probed bucket) the k' smallest (dist, row id) of the
    bucket's slots, k' = :func:`probe_width`.

    ``q_codes`` int8 [Q, D] (u8 − 128) with the u8 moments (``fused_scan.
    _prep``); ``bids`` int32 [Q, P] the probed bucket ids; the buckets as
    :class:`IVFIndex` holds them (int8 [C, cap, D]: kind "cosine"; packed
    uint8 [C, cap, D/2]: kind "cosine4a").  A slot's entry is its spec
    distance and row id where the slot is valid and ``dist <
    max_distance``.  Returns (dist [Q, P, k'] f32, idx [Q, P, k'] int32):
    where k' < cap, each (q, p)'s k' smallest by (dist, row id) in slot
    order, then (+inf, 2^31 − 1); where k' = cap, every slot in place,
    (+inf, 2^31 − 1) where filtered.  K1c then takes the top k.

    Replaces the JAX ``_ivf_probe_topk`` up to its tree merge
    (``pixelbox_tpu/ops/ivf.py:498``, XLA, no ``pallas_call``: a gather,
    an einsum, ``block_topk``).  On the card where :func:`tc_probe_width`
    the tensor-core kernel (``csrc/ivf_probe.cu`` ``ivf_probe_tc_kernel``:
    a work item a (bucket, ≤ :data:`IVF_PROBE_NQ` queries probing it), the
    bucket read once in place by TMA as int8 ``wgmma``'s A, the select in
    shared memory), after :func:`ivf_probe_invert` where
    :func:`shares_buckets`; at other
    widths the first port's kernel (:func:`ivf_probe_collect_dp4a`,
    every slot).  On the CPU :func:`ivf_probe_topk_plain`."""
    dev, qn, d, c, cap = _check_probe_args(
        q_codes, q_sum, q_mag2, qr, bids, bucket_data, bucket_sum, bucket_mag2, bucket_rows,
        bucket_valid,
    )
    md = float(np.float32(max_distance))
    args = (q_codes, q_sum, q_mag2, qr, md, bids, bucket_data, bucket_sum, bucket_mag2,
            bucket_rows, bucket_valid)
    if dev.type != "cuda":
        return ivf_probe_topk_plain(*args, k)
    p = bids.shape[1]
    int4 = bucket_data.dtype == torch.uint8
    if not tc_probe_width(d, int4, cap):
        out_d, out_i = ivf_probe_collect_dp4a(*args)
        return out_d.reshape(qn, p, cap), out_i.reshape(qn, p, cap)
    kp = probe_width(k, cap, d, int4)
    # The kernel reads query rows and copies slot meta 16 bytes at a time.
    q_codes, bucket_sum, bucket_mag2, bucket_rows, bucket_valid = (
        t.clone() if t.data_ptr() % 16 else t
        for t in (q_codes, bucket_sum, bucket_mag2, bucket_rows, bucket_valid))
    work = ivf_probe_invert(bids, c) if shares_buckets(qn, p, c) else None
    kern = load_ivf_kernels()
    out_d = torch.empty((qn, p, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, p, kp), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_ivf_probe_topk(
            fs._ptr(q_codes), fs._ptr(q_sum), fs._ptr(q_mag2), fs._ptr(qr), md, fs._ptr(bids),
            ctypes.c_void_p(None if work is None else work.data_ptr()),
            fs._ptr(bucket_data), fs._ptr(bucket_sum), fs._ptr(bucket_mag2),
            fs._ptr(bucket_rows), fs._ptr(bucket_valid), qn, p, c, cap, d,
            fs._KIND_CODES["cosine4a" if int4 else "cosine"], kp,
            fs._ptr(out_d), fs._ptr(out_i), fs._stream(dev),
        )
    fs._check(rc, "ivf_probe_topk")
    fs.count_launch("ivf_probe_topk")
    return out_d, out_i


def ivf_probe_topk_plain(q_codes, q_sum, q_mag2, qr, max_distance, bids, bucket_data, bucket_sum,
                         bucket_mag2, bucket_rows, bucket_valid, k: int):
    """Plain PyTorch version of :func:`ivf_probe_topk`: the slots'
    entries of :func:`ivf_probe_collect_plain`; where k' < cap, each (q,
    p)'s k'-th smallest (dist, row id) key by a sort, the keys at or below
    it kept in slot order."""
    qn, d = q_codes.shape
    p = bids.shape[1]
    cap = bucket_data.shape[1]
    dist, idx = ivf_probe_collect_plain(q_codes, q_sum, q_mag2, qr, max_distance, bids, bucket_data,
                                        bucket_sum, bucket_mag2, bucket_rows, bucket_valid)
    dist, idx = dist.reshape(qn, p, cap), idx.reshape(qn, p, cap)
    kp = probe_width(k, cap, d, bucket_data.dtype == torch.uint8)
    if kp == cap:
        return dist, idx
    live = idx != _NO_ROW
    key = (dist.view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)
    key = torch.where(live, key, torch.full_like(key, torch.iinfo(torch.int64).max))
    kth = torch.sort(key, dim=-1).values[..., kp - 1 : kp]
    take = live & (key <= kth)
    # The taken slots first, in slot order (a stable sort of "not taken").
    order = torch.sort((~take).to(torch.uint8), dim=-1, stable=True).indices[..., :kp]
    took = torch.gather(take, -1, order)
    return (
        torch.where(took, torch.gather(dist, -1, order), torch.full_like(dist[..., :kp], float("inf"))),
        torch.where(took, torch.gather(idx, -1, order), torch.full_like(idx[..., :kp], _NO_ROW)),
    )


def ivf_probe_invert(bids, n_clusters: int):
    """K5's work list: the probe list ``bids`` int32 [Q, P] (pair j = q·P
    + p) inverted, bucket-major.  Returns int32 [1 + Q·P·(1 +
    :data:`IVF_PROBE_NQ`)]: entry 0 the number of work items, then per item
    its bucket (-1 for ids outside [0, n_clusters)) and up to
    :data:`IVF_PROBE_NQ` pair ids (-1 past them); items in bucket order,
    each bucket's pairs over ceil(count / NQ) items, all full but its last.

    On the card one block (``csrc/ivf_probe.cu`` ``ivf_invert_kernel``: a
    counting sort by bucket in shared memory), whose pairs within a bucket
    follow its atomics' order; on the CPU :func:`ivf_probe_invert_plain`
    (ascending pair ids).  :func:`probe_work_pairs` compares the two."""
    dev = bids.device
    m = bids.numel()
    fs._require(bids, "bids", torch.int32, tuple(bids.shape), dev)
    if dev.type != "cuda":
        return ivf_probe_invert_plain(bids, n_clusters)
    kern = load_ivf_kernels()
    work = torch.empty((1 + m * (1 + IVF_PROBE_NQ),), dtype=torch.int32, device=dev)
    scratch = None
    if n_clusters + 1 > _INVERT_SMEM_BUCKETS:
        scratch = torch.empty((2 * (n_clusters + 1),), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_ivf_invert(
            fs._ptr(bids), m, int(n_clusters),
            ctypes.c_void_p(None if scratch is None else scratch.data_ptr()), fs._ptr(work),
            fs._stream(dev),
        )
    fs._check(rc, "ivf_probe_invert")
    fs.count_launch("ivf_probe_invert")
    return work


def ivf_probe_invert_plain(bids, n_clusters: int):
    """Plain PyTorch version of :func:`ivf_probe_invert`: a stable sort of
    the pairs by bucket; a bucket's pairs ascend."""
    nq = IVF_PROBE_NQ
    flat = bids.reshape(-1).long()
    m = flat.numel()
    slot = torch.where((flat >= 0) & (flat < n_clusters), flat, torch.full_like(flat, n_clusters))
    order = torch.sort(slot, stable=True).indices
    sb = slot[order]
    counts = torch.bincount(slot, minlength=n_clusters + 1)
    items = (counts + nq - 1) // nq
    first_item = torch.cumsum(items, 0) - items
    rank = torch.arange(m, device=bids.device) - (torch.cumsum(counts, 0) - counts)[sb]
    item = first_item[sb] + torch.div(rank, nq, rounding_mode="floor")
    work = torch.full((1 + m * (1 + nq),), -1, dtype=torch.int32, device=bids.device)
    work[0] = int(items.sum())
    recs = work[1:].view(m, 1 + nq)
    recs[item, 0] = torch.where(sb < n_clusters, sb, torch.full_like(sb, -1)).to(torch.int32)
    recs[item, 1 + rank % nq] = order.to(torch.int32)
    return work


def probe_work_pairs(work):
    """A work list in canonical form: (the items' buckets [n], their pair
    counts [n], (bucket, pair id) of every pair sorted [Q·P, 2]) — equal
    for two lists that differ only in the order of a bucket's pairs."""
    n = int(work[0])
    recs = work[1:].reshape(-1, 1 + IVF_PROBE_NQ)[:n].long()
    pairs = recs[:, 1:]
    live = pairs >= 0
    b = recs[:, :1].expand_as(pairs)[live]
    p = pairs[live]
    order = torch.argsort(b * (p.max() + 1 if p.numel() else 1) + p)
    return recs[:, 0], live.sum(1), torch.stack([b[order], p[order]], 1)


def ivf_probe_collect_dp4a(q_codes, q_sum, q_mag2, qr, max_distance, bids, bucket_data,
                           bucket_sum, bucket_mag2, bucket_rows, bucket_valid):
    """The first port's K5, for CUDA tensors only: the exact distance of
    every slot of each query's probed buckets, (dist [Q, P·cap] f32, idx
    [Q, P·cap] int32), the slot's row id where the slot is valid and
    ``dist < max_distance``, (+inf, 2^31 − 1) elsewhere, in (probe, slot)
    order.  ``csrc/ivf_probe.cu`` ``ivf_probe_dp4a_kernel`` (one block a
    (bucket, query), the bucket read in place, ``__dp4a``): the path of
    :func:`ivf_probe_topk` at the widths the tensor-core kernel does not
    take, and its timing reference.  Its plain version is
    :func:`ivf_probe_collect_plain`."""
    dev, qn, d, c, cap = _check_probe_args(
        q_codes, q_sum, q_mag2, qr, bids, bucket_data, bucket_sum, bucket_mag2, bucket_rows,
        bucket_valid,
    )
    if dev.type != "cuda":
        raise ValueError("ivf_probe_collect_dp4a runs on the card; its plain version is "
                         "ivf_probe_collect_plain")
    md = float(np.float32(max_distance))
    p = bids.shape[1]
    kern = load_ivf_kernels()
    out_d = torch.empty((qn, p * cap), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, p * cap), dtype=torch.int32, device=dev)
    kind = fs._KIND_CODES["cosine4a" if bucket_data.dtype == torch.uint8 else "cosine"]
    with torch.cuda.device(dev):
        rc = kern.lib.px_ivf_probe_collect_dp4a(
            fs._ptr(q_codes), fs._ptr(q_sum), fs._ptr(q_mag2), fs._ptr(qr), md, fs._ptr(bids),
            fs._ptr(bucket_data), fs._ptr(bucket_sum), fs._ptr(bucket_mag2),
            fs._ptr(bucket_rows), fs._ptr(bucket_valid), qn, p, c, cap, d, kind,
            fs._ptr(out_d), fs._ptr(out_i), fs._stream(dev),
        )
    fs._check(rc, "ivf_probe_collect_dp4a")
    fs.count_launch("ivf_probe_collect_dp4a")
    return out_d, out_i


def ivf_probe_collect_plain(q_codes, q_sum, q_mag2, qr, max_distance, bids, bucket_data,
                            bucket_sum, bucket_mag2, bucket_rows, bucket_valid):
    """Plain PyTorch version of the first port's K5: the probed buckets
    gathered in blocks of probes, an exact float64 code dot, the kind's
    affine fix and the spec epilogue (``fused_scan._spec_epilogue``, op for
    op the kernels')."""
    qn, d = q_codes.shape
    p = bids.shape[1]
    cap = bucket_data.shape[1]
    int4 = bucket_data.dtype == torch.uint8
    kind = "cosine4a" if int4 else "cosine"
    md = _f32(max_distance, qr)
    bl = bids.long()
    out_d = torch.empty((qn, p, cap), dtype=torch.float32, device=qr.device)
    out_i = torch.empty((qn, p, cap), dtype=torch.int32, device=qr.device)
    qv = q_codes.to(torch.float64)
    step = max(1, _PLAIN_PROBE_ELEMS // max(1, qn * cap * d))
    for p0 in range(0, p, step):
        b = bl[:, p0 : p0 + step]
        g = bucket_data[b]
        g = fs.unpack_u4(g) if int4 else g
        pc = b.shape[1]
        dot8 = torch.matmul(g.reshape(qn, pc * cap, d).to(torch.float64), qv[:, :, None])
        dot8 = dot8.reshape(qn, pc, cap).to(torch.int32)
        dot_c = fs._centered(kind, dot8, q_sum[:, None, None], bucket_sum[b], d)
        m2 = bucket_mag2[b]
        dist = fs._spec_epilogue(dot_c, qr[:, None, None], rsqrt_spec(m2.to(torch.float32)),
                                 q_mag2[:, None, None], m2)
        keep = bucket_valid[b] & (dist < md)
        out_d[:, p0 : p0 + pc] = torch.where(keep, dist, torch.full_like(dist, float("inf")))
        out_i[:, p0 : p0 + pc] = torch.where(keep, bucket_rows[b], torch.full_like(m2, _NO_ROW))
    return out_d.reshape(qn, p * cap), out_i.reshape(qn, p * cap)


def ivf_gathered_collect(q_codes, q_sum, q_mag2, qr, max_distance, cand, rows_u8):
    """K5's gathered mode: the exact u8 distance of per-query candidate
    rows.  ``cand`` int32 [Q, M] row ids into ``rows_u8`` uint8 [N, D]
    (ids outside [0, N) are empty); queries as :func:`ivf_probe_topk`
    (u8 codes and moments).  Returns (dist [Q, M] f32, idx [Q, M] int32):
    the spec distance and the id where ``dist < max_distance``, (+inf,
    2^31 − 1) elsewhere; the row moments are computed from the bytes.

    Replaces the distance half of the JAX ``_rerank_device``
    (``pixelbox_tpu/ops/ivf_build.py:645``, XLA, no ``pallas_call``); K1c
    then takes the top k.  On the card ``ivf_gathered_kernel`` (a thread a
    candidate, ``__dp4a``); on the CPU :func:`ivf_gathered_collect_plain`."""
    dev = rows_u8.device
    qn, d = q_codes.shape
    n = rows_u8.shape[0]
    req = fs._require
    req(q_codes, "q_codes", torch.int8, (qn, d), dev)
    req(q_sum, "q_sum", torch.int32, (qn,), dev)
    req(q_mag2, "q_mag2", torch.int32, (qn,), dev)
    req(qr, "qr", torch.float32, (qn,), dev)
    req(cand, "cand", torch.int32, (qn, cand.shape[1]), dev)
    req(rows_u8, "rows_u8", torch.uint8, (n, d), dev)
    md = float(np.float32(max_distance))
    if dev.type != "cuda":
        return ivf_gathered_collect_plain(q_codes, q_sum, q_mag2, qr, md, cand, rows_u8)
    m = cand.shape[1]
    kern = load_ivf_kernels()
    out_d = torch.empty((qn, m), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, m), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_ivf_gathered_collect(
            fs._ptr(q_codes), fs._ptr(q_sum), fs._ptr(q_mag2), fs._ptr(qr), md, fs._ptr(cand),
            fs._ptr(rows_u8), qn, n, m, d, fs._ptr(out_d), fs._ptr(out_i), fs._stream(dev),
        )
    fs._check(rc, "ivf_gathered_collect")
    fs.count_launch("ivf_gathered_collect")
    return out_d, out_i


def ivf_gathered_collect_plain(q_codes, q_sum, q_mag2, qr, max_distance, cand, rows_u8):
    """Plain PyTorch version of K5's gathered mode: the candidate rows
    gathered, their u8 moments, an exact code dot, the u8 fix and the spec
    epilogue."""
    qn, d = q_codes.shape
    n = rows_u8.shape[0]
    ok = (cand >= 0) & (cand < n)
    safe = torch.where(ok, cand, torch.zeros_like(cand)).long()
    g = rows_u8[safe].to(torch.int32) - 128              # [Q, M, D]
    dot8 = (g * q_codes[:, None, :].to(torch.int32)).sum(-1, dtype=torch.int32)
    r_sum = g.sum(-1, dtype=torch.int32)
    r_mag2 = ((2 * g + 1) * (2 * g + 1)).sum(-1, dtype=torch.int32)
    dot_c = fs._centered("cosine", dot8, q_sum[:, None], r_sum, d)
    dist = fs._spec_epilogue(dot_c, qr[:, None], rsqrt_spec(r_mag2.to(torch.float32)),
                             q_mag2[:, None], r_mag2)
    keep = ok & (dist < _f32(max_distance, qr))
    return (
        torch.where(keep, dist, torch.full_like(dist, float("inf"))),
        torch.where(keep, cand, torch.full_like(cand, _NO_ROW)),
    )


# --------------------------------------------------------------------- #
# The probe


def probe_order(query_u8: torch.Tensor, centroids: torch.Tensor, nprobe: int) -> torch.Tensor:
    """[Q, nprobe] int32 bucket ids by centroid score, descending (the
    reciprocal distance falls as the cosine rises): an f32 ``torch.matmul``
    of the centered queries against the unit centroids, then a stable
    descending sort — ties to the lower cluster id, as ``lax.top_k``."""
    xq = _centered_f32(query_u8)
    scores = torch.matmul(xq, centroids.T)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[:, :nprobe].to(torch.int32).contiguous()


def _ivf_probe_topk(query_u8, prep, ivf: IVFIndex, k: int, nprobe: int, max_distance):
    """Probe ``nprobe`` buckets a query; each (query, bucket)'s k' smallest
    (K5), then the top k of their [Q, nprobe · k'] by (dist, row id) (K1c),
    in query blocks whose partials stay under :data:`IVF_PROBE_BYTES`.
    ``prep`` is ``fused_scan._prep`` of the queries.  [Q, k] sorted, +inf
    / -1 empty."""
    qn = query_u8.shape[0]
    q_codes, q_sum, q_mag2, qr = prep
    bids = probe_order(query_u8, ivf.centroids, nprobe)
    kp = probe_width(k, ivf.bucket_cap, q_codes.shape[1], ivf.kind == "cosine4a")
    step = max(1, min(_MAX_GRID_Y, IVF_PROBE_BYTES // (8 * nprobe * kp)))
    outs = []
    for s in range(0, qn, step):
        e = min(qn, s + step)
        dist, idx = ivf_probe_topk(
            q_codes[s:e], q_sum[s:e], q_mag2[s:e], qr[s:e], max_distance, bids[s:e],
            ivf.bucket_data, ivf.bucket_sum, ivf.bucket_mag2, ivf.bucket_rows, ivf.bucket_valid, k,
        )
        outs.append(fs.lex_topk(dist.reshape(e - s, -1), idx.reshape(e - s, -1), k))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def ivf_local_topk(query_u8, ivf: IVFIndex, k: int, nprobe: int, max_distance):
    """Probe + exact spill scan + merge: [Q, k] sorted ascending by (dist,
    row id), +inf / -1 empty (no finalize — the sharded scan merges the
    shards first).  ``query_u8`` uint8 [Q, D] on the index's device.

    The spill takes the port's exact scan (K1b/K4b + K1c, the path of
    ``fused_cosine_scan_topk`` / ``fused_cosine4_scan_topk``) on the same
    prepared queries (u8 moments for both packings: the int4 buckets'
    metric is the asymmetric one), and K1c merges the two [Q, k] lists —
    one launch where the JAX package's bitonic ``merge_sorted_topk`` is
    some hundred small ops on the card."""
    prep = fs._prep(query_u8)
    best_d, best_i = _ivf_probe_topk(query_u8, prep, ivf, k, nprobe, max_distance)
    if ivf.spill_count:
        qk = fs.Int4Queries(*prep, "asym") if ivf.kind == "cosine4a" else fs.CosineQueries(*prep)
        sd, si = fs._exact_scan(qk, query_u8.shape[0], ivf.spill.data, ivf.spill_meta, k, max_distance)
        si = torch.where(si >= 0, ivf.spill_rows[torch.clamp(si, min=0).long()], si)
        best_d, best_i = fs.lex_topk(torch.cat([best_d, sd], 1), torch.cat([best_i, si], 1), k)
    return best_d, best_i


@torch.no_grad()
def ivf_scan_topk(query_u8, ivf: IVFIndex, k: int = 100, nprobe: Optional[int] = None,
                  max_distance: float = 1e3):
    """Top-k by the index's exact distance spec over the probed candidate
    set (u8 reciprocal-cosine, or asymmetric cosine4a for int4 buckets —
    callers rerank those with the exact u8 metric).  ``nprobe=None`` =
    :func:`default_nprobe`.

    Same return contract as ``cosine_scan_topk``: (dist [Q, k] f32,
    row_ids [Q, k] int32, -1 where excluded), squeezed for a 1-D query.
    With ``nprobe == n_clusters`` every bucket is probed and, with the
    exact spill scan, the result equals the flat exact scan."""
    q, squeeze = fs._as_queries(query_u8, ivf.device)
    if nprobe is None:
        nprobe = default_nprobe(ivf.n_clusters)
    nprobe = int(max(1, min(nprobe, ivf.n_clusters)))
    best_d, best_i = ivf_local_topk(q, ivf, int(k), nprobe, max_distance)
    best_d, best_i = topk_ops.finalize_topk(best_d, best_i)
    if squeeze:
        return best_d[0], best_i[0]
    return best_d, best_i
