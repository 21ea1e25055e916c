"""Device-side IVF build (torch port of ``ops/ivf_build.py``): assignment,
bucket packing, k-means and the ground-truth utilities, without a host
copy of the index.

- assignment is the same blocked argmax GEMM as ``ops/ivf`` (stock torch);
- packing is a stable ``torch.argsort`` by cluster id + a rank-within-
  cluster scatter; its arrays equal the host packer's
  (``ops.ivf.pack_buckets_host``) for the same assignments, so the two are
  interchangeable and ``ops.ivf.build_ivf`` routes large builds here;
- per-row codes and moments (u8-centered or int4-packed nibbles) are
  computed in row blocks so the int32 temporaries stay bounded.

The device rerank (:func:`rerank_candidates_u8_device`) runs K5's
gathered mode (``ops.ivf.ivf_gathered_collect``) and K1c on the card.
The JAX module's ``device_clustered_corpus`` (``jax.random``, used by its
bench only) waits for the port's bench (ROADMAP.md).

Reference anchor: src/engine.rs:375-383 (the exact-scan semantics IVF
relaxes); distances stay the exact integer spec (ops/distances.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import ivf as ivf_ops
from pixelbox_tpu_torch.ops import topk as topk_ops
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex
from pixelbox_tpu_torch.utils.device import resolve_device

# --------------------------------------------------------------------------
# Per-row codes + moments (bit-identical to the host precomputes
# ops/packed.semantic_rows_from_u8 and ops/int4.semantic4_rows_from_u8)


def _moments_u8(rows_u8: torch.Tensor):
    q = rows_u8.to(torch.int32)
    data = (q - 128).to(torch.int8)
    row_sum = torch.sum(q - 128, dim=-1, dtype=torch.int32)
    cen = 2 * q - 255
    row_mag2 = torch.sum(cen * cen, dim=-1, dtype=torch.int32)
    return data, row_sum, row_mag2


def _moments_int4(rows_u8: torch.Tensor):
    v4 = (rows_u8.to(torch.int32) * 15 + 127) // 255  # round-half-up rescale
    half = rows_u8.shape[-1] // 2
    packed = (v4[..., :half] | (v4[..., half:] << 4)).to(torch.uint8)
    row_sum = torch.sum(v4, dim=-1, dtype=torch.int32)
    c = 34 * v4 - 255
    row_mag2 = torch.sum(c * c, dim=-1, dtype=torch.int32)
    return packed, row_sum, row_mag2


def _moments_fn(precision: str):
    return _moments_int4 if precision == "int4" else _moments_u8


def _blocked_moments(rows_u8: torch.Tensor, precision: str, block: int):
    """codes/moments over [N, D] rows in row blocks (bounds the int32
    temporaries to ``block`` rows at a time)."""
    fn = _moments_fn(precision)
    if rows_u8.shape[0] <= block:
        return fn(rows_u8)
    parts = [fn(rows_u8[s : s + block]) for s in range(0, rows_u8.shape[0], block)]
    return tuple(torch.cat([p[j] for p in parts]) for j in range(3))


# --------------------------------------------------------------------------
# Assignment (blocked argmax GEMM) + cluster counts


def _assign_block_rows(n_clusters: int, budget_bytes: int = 1 << 27) -> int:
    """Row block of the assignment / k-means GEMMs: the [B, C] f32 score
    tile stays under ``budget_bytes``."""
    b = budget_bytes // max(1, 4 * n_clusters)
    p = 1024
    while p * 2 <= min(b, 65536):
        p *= 2
    return p


@torch.no_grad()
def _assign_and_count(centroids, rows_u8, valid, block_rows: int, n_clusters: int):
    """(cluster key per row [N] int32 — invalid rows get key C, so a stable
    sort puts them last; counts [C+1] int64)."""
    keys = ivf_ops._assign_rows(centroids, rows_u8, block_rows)
    keys = torch.where(valid, keys, torch.full_like(keys, n_clusters))
    counts = torch.bincount(keys.long(), minlength=n_clusters + 1)
    return keys, counts


# --------------------------------------------------------------------------
# The pack: stable sort by cluster + rank scatter, on the device


@torch.no_grad()
def _pack_device(rows_u8, akey, row_ids, counts, n_clusters: int, bucket_cap: int, s_pad: int,
                 precision: str, mblock: int):
    """Scatter rows into fixed-capacity buckets + the exact-scanned spill,
    the host packer's layout exactly: within a cluster rows keep
    ascending position order (stable sort), overflow past ``bucket_cap``
    spills in ascending row order, and empty bucket slots carry the
    moments of the all-zero row (the host packs moments over a
    zero-filled staging array)."""
    n, d = rows_u8.shape
    dev = rows_u8.device
    c, cap = n_clusters, bucket_cap
    flat = c * cap

    order = torch.argsort(akey, stable=True)
    sa = akey[order].long()
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(n, device=dev) - starts[sa]
    in_bucket = (sa < c) & (rank < cap)
    slot = torch.where(in_bucket, sa * cap + rank, torch.full_like(rank, flat))
    # Each row's bucket slot (flat = dropped), scattered back through the
    # sort once.
    slot_by_row = torch.full((n,), flat, dtype=torch.long, device=dev)
    slot_by_row[order] = slot

    codes_r, sums_r, mags_r = _blocked_moments(rows_u8, precision, mblock)
    z_codes, z_sum, z_mag = _moments_fn(precision)(torch.zeros((1, d), dtype=torch.uint8, device=dev))

    def scatter(fill, values):
        out = fill.expand((flat + 1,) + tuple(fill.shape[1:])).clone()
        out[slot_by_row] = values
        return out[:flat]

    bdata = scatter(z_codes, codes_r)
    bsum = scatter(z_sum, sums_r)
    bmag = scatter(z_mag, mags_r)
    brows = scatter(torch.full((1,), -1, dtype=torch.int32, device=dev), row_ids)
    bvalid = scatter(torch.zeros((1,), dtype=torch.bool, device=dev), slot_by_row < flat)
    buckets = (
        bdata.reshape(c, cap, -1), bsum.reshape(c, cap), bmag.reshape(c, cap),
        brows.reshape(c, cap), (bvalid & (brows >= 0)).reshape(c, cap),
    )
    if s_pad == 0:
        s_codes, s_sum, s_mag = _moments_fn(precision)(torch.zeros((0, d), dtype=torch.uint8, device=dev))
        return buckets + (s_codes, s_sum, s_mag, torch.zeros((0,), dtype=torch.bool, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev))

    # Spill rows in ascending POSITION order (the host packer's np.sort).
    is_spill = torch.zeros((n,), dtype=torch.bool, device=dev)
    is_spill[order] = (sa < c) & (rank >= cap)
    srank = torch.cumsum(is_spill.to(torch.long), 0) - 1
    sslot = torch.where(is_spill, srank, torch.full_like(srank, s_pad))
    spill_u8 = torch.zeros((s_pad + 1, d), dtype=torch.uint8, device=dev)
    spill_u8[sslot] = rows_u8
    s_ids = torch.full((s_pad + 1,), -1, dtype=torch.int32, device=dev)
    s_ids[sslot] = row_ids
    s_valid = torch.zeros((s_pad + 1,), dtype=torch.bool, device=dev)
    s_valid[sslot] = is_spill
    s_codes, s_sum, s_mag = _moments_fn(precision)(spill_u8[:s_pad])
    return buckets + (s_codes, s_sum, s_mag, s_valid[:s_pad], s_ids[:s_pad])


@torch.no_grad()
def build_ivf_device(
    rows_u8,
    valid=None,
    centroids=None,
    bucket_cap: Optional[int] = None,
    row_ids=None,
    precision: str = "u8",
    device=None,
) -> ivf_ops.IVFIndex:
    """``ops.ivf.build_ivf`` semantics, computed on the device.

    ``rows_u8`` may be a numpy array (one bulk transfer to ``device``,
    "cuda" by default) or a tensor already on its device (``device=None``
    keeps it there).  ``row_ids`` must ascend with position (the store's
    layout), as for the host builder."""
    assert centroids is not None
    if torch.is_tensor(rows_u8):
        dev = rows_u8.device if device is None else resolve_device(device)
        rows = rows_u8.to(dev, dtype=torch.uint8)
    else:
        dev = resolve_device("cuda" if device is None else device)
        rows = torch.from_numpy(np.ascontiguousarray(rows_u8, dtype=np.uint8)).to(dev)
    n, d = rows.shape
    cents = (centroids if torch.is_tensor(centroids)
             else torch.from_numpy(np.array(centroids, dtype=np.float32))).to(dev, torch.float32)
    c = int(cents.shape[0])
    if valid is None:
        valid_dev = torch.ones((n,), dtype=torch.bool, device=dev)
    else:
        valid_dev = (valid if torch.is_tensor(valid)
                     else torch.from_numpy(np.array(valid, dtype=bool))).to(dev, torch.bool)
    if row_ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        ids = (row_ids if torch.is_tensor(row_ids)
               else torch.from_numpy(np.array(row_ids, dtype=np.int32))).to(dev, torch.int32)

    block = _assign_block_rows(c)
    akey, counts = _assign_and_count(cents, rows, valid_dev, block, c)
    counts_np = counts.cpu().numpy()
    n_live = int(counts_np[:c].sum())
    if bucket_cap is None:
        bucket_cap = ivf_ops.default_bucket_cap(n_live, c)
    bucket_cap = int(max(8, bucket_cap))
    spill_count = int(np.maximum(counts_np[:c] - bucket_cap, 0).sum())
    s_pad = ivf_ops.spill_pad(spill_count)

    (bdata, bsum, bmag, brows, bvalid, s_codes, s_sum, s_mag, s_valid, s_ids) = _pack_device(
        rows, akey, ids, counts, c, bucket_cap, s_pad, precision, block
    )
    _, index_cls = ivf_ops._spill_rows_fn(precision)
    spill = index_cls(s_codes, s_sum, s_mag, s_valid)
    return ivf_ops.IVFIndex(
        cents, bdata.contiguous(), bsum, bmag, brows, bvalid, spill, s_ids, fs.build_row_meta(spill),
    )


def pack_buckets_device_np(rows_u8, valid, centroids, bucket_cap: int, row_ids,
                           precision: str = "u8", device="cuda"):
    """``ops.ivf.pack_buckets_host``'s exact contract computed on the
    device and pulled back to numpy (the sharded builder's per-shard pack).
    Returns (bucket_data, bucket_sum, bucket_mag2, bucket_rows,
    bucket_valid, spill_pos), ``spill_pos`` ascending positions into
    ``rows_u8``."""
    row_ids = np.asarray(row_ids, dtype=np.int32)
    ivf = build_ivf_device(rows_u8, valid, centroids, bucket_cap=bucket_cap, row_ids=row_ids,
                           precision=precision, device=device)
    gids = ivf_ops.live_spill_ids(ivf)
    spill_pos = np.searchsorted(row_ids, gids)
    return tuple(t.cpu().numpy() for t in (
        ivf.bucket_data, ivf.bucket_sum, ivf.bucket_mag2, ivf.bucket_rows, ivf.bucket_valid,
    )) + (spill_pos,)


# --------------------------------------------------------------------------
# Device-native spherical k-means (sampled training at capacity scale)


@torch.no_grad()
def kmeans_device(rows_dev, n_clusters: int, iters: int = 6, seed: int = 0,
                  train_sample: Optional[int] = None) -> torch.Tensor:
    """Unit f32 centroids [C, D] trained on device-resident u8 rows (all
    valid).  ``train_sample`` caps the training set (a uniform row sample
    gathered on the device; the same numpy draws as the JAX package)."""
    rows = torch.as_tensor(rows_dev).to(dtype=torch.uint8)
    n, d = rows.shape
    n_clusters = int(max(1, min(n_clusters, n)))
    rng = np.random.default_rng(seed)
    if train_sample is not None and train_sample < n:
        pick = np.sort(rng.choice(n, size=int(train_sample), replace=False))
        rows = rows[torch.from_numpy(pick).to(rows.device)]
        n = rows.shape[0]
    init_pick = rng.choice(n, size=n_clusters, replace=False)
    x = ivf_ops._centered_f32(rows[torch.from_numpy(init_pick).to(rows.device)])
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    centroids = x / torch.clamp(norm, min=1e-6)
    block = int(min(_assign_block_rows(n_clusters, budget_bytes=1 << 26), max(8, n)))
    valid = torch.ones((n,), dtype=torch.bool, device=rows.device)
    for _ in range(int(iters)):
        centroids, _ = ivf_ops._kmeans_step(centroids, rows, valid, block)
    return centroids


# --------------------------------------------------------------------------
# Flat exact index from device rows (ground truth at capacity scale)


@torch.no_grad()
def flat_semantic_index_device(rows_dev, n_valid: Optional[int] = None,
                               block_rows: int = 2 ** 17) -> PackedSemanticIndex:
    """PackedSemanticIndex from device-resident u8 rows (moments in row
    blocks on the device), padded to a multiple of ``block_rows`` with the
    zero row's moments (the host builder's padding)."""
    rows = torch.as_tensor(rows_dev).to(dtype=torch.uint8)
    n, d = rows.shape
    if n_valid is None:
        n_valid = n
    block_rows = int(min(block_rows, max(8, n)))
    pad = -(-n // block_rows) * block_rows - n
    data, sums, mags = _blocked_moments(rows, "u8", block_rows)
    if pad:
        zd, zs, zm = _moments_u8(torch.zeros((1, d), dtype=torch.uint8, device=rows.device))
        data = torch.cat([data, zd.expand(pad, d)])
        sums = torch.cat([sums, zs.expand(pad)])
        mags = torch.cat([mags, zm.expand(pad)])
    valid = torch.arange(data.shape[0], device=rows.device) < int(n_valid)
    return PackedSemanticIndex(data.contiguous(), sums, mags, valid)


# --------------------------------------------------------------------------
# Recall-targeted nprobe tuning (opt-in; engine.ivf_target_recall)


def tune_nprobe(index, rows, target_recall: float = 0.99, k: int = 10, q: int = 64, seed: int = 0,
                q_noise: int = 12, max_rows_frac: float = 0.25, valid=None, scan_fn=None):
    """Smallest doubling-sequence nprobe whose measured recall@k meets
    ``target_recall`` on held-out noisy copies of live store rows (the
    JAX package's tuner, its draws and its sequence 8, 16, 32, ... capped
    at ``max_rows_frac`` of the index).  Ground truth is the exact flat
    scan (K1b + K1c on a card) over the LIVE rows; an int4 index is
    measured on the engine's path: top-C asymmetric candidates + the
    exact-u8 device rerank (:func:`scan_with_u8_rerank_device`).

    ``scan_fn(queries_u8, nprobe) -> (dist, store_row_ids)`` overrides the
    probe under test (the sharded path passes its own).  Returns
    ``(nprobe, measured_recall)``."""
    dev = index.device
    rows_dev = (rows if torch.is_tensor(rows)
                else torch.from_numpy(np.array(rows, dtype=np.uint8))).to(dev, torch.uint8)
    n, d = rows_dev.shape
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(np.asarray(valid, dtype=bool)) if valid is not None else np.arange(n)
    q = int(min(q, live.size))
    pick = rng.choice(live, size=q, replace=False)
    base = rows_dev[torch.from_numpy(pick).to(dev)].cpu().numpy()
    noise = rng.integers(-q_noise, q_noise + 1, size=(q, d))
    queries = np.clip(base.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    if live.size == n:
        live_rows, to_store = rows_dev, None
    else:
        live_rows, to_store = rows_dev[torch.from_numpy(live).to(dev)], live
    flat = flat_semantic_index_device(live_rows, block_rows=2 ** 15)
    _, exp_i = fs.fused_cosine_scan_topk(torch.from_numpy(queries).to(dev), flat,
                                        fs.build_row_meta(flat), k=k)
    exp_np = exp_i.cpu().numpy()
    del flat
    exp_sets = [
        {int(x if to_store is None else to_store[x]) for x in row if x >= 0} for row in exp_np
    ]

    c = index.n_clusters
    max_probe = min(c, max(8, int(max_rows_frac * n / max(1, index.bucket_cap))))
    is_int4 = getattr(index, "kind", None) == "cosine4a"

    def _default_scan(qs, nprobe):
        qt = torch.from_numpy(qs).to(dev)
        if is_int4:
            return scan_with_u8_rerank_device(
                lambda cc, md: ivf_ops.ivf_scan_topk(qt, index, k=cc, nprobe=nprobe, max_distance=md),
                qt, rows_dev, k=k, max_distance=1e3,
            )
        return ivf_ops.ivf_scan_topk(qt, index, k=k, nprobe=nprobe)

    scan = scan_fn or _default_scan

    def _recall(nprobe: int) -> float:
        _, got = scan(queries, nprobe)
        got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
        hits = [
            len({int(x) for x in got[i] if x >= 0} & exp_sets[i]) / max(1, len(exp_sets[i]))
            for i in range(q)
        ]
        return float(np.mean(hits))

    nprobe = 8
    best = (min(nprobe, c), _recall(min(nprobe, c)))
    while best[1] < target_recall and nprobe < max_probe:
        nprobe = min(2 * nprobe, max_probe)
        best = (nprobe, _recall(nprobe))
    return best


# --------------------------------------------------------------------------
# Device-side exact-u8 rerank (the candidates' rescore)


@torch.no_grad()
def rerank_candidates_u8_device(query_u8, cand_idx, rows_dev, k: int = 100,
                                max_distance: float = 1e3):
    """``ops.int4.rerank_candidates_u8`` semantics against a DEVICE u8 row
    mirror: exact u8 rescore of per-query candidates (K5's gathered mode,
    ``ops.ivf.ivf_gathered_collect``), (dist, row id) order by K1c,
    ``WHERE dist < max LIMIT k``.  Returns (dist [Q, k], idx [Q, k]
    int32) tensors on the rows' device, squeezed for 1-D inputs."""
    rows = torch.as_tensor(rows_dev).to(dtype=torch.uint8)
    dev = rows.device
    ci = torch.as_tensor(cand_idx).to(dev, torch.int32)
    q = torch.as_tensor(query_u8).to(dev, torch.uint8)
    squeeze = ci.ndim == 1
    if squeeze:
        q, ci = q[None], ci[None]
    q_codes, q_sum, q_mag2, qr = fs._prep(q)
    dist, idx = ivf_ops.ivf_gathered_collect(q_codes, q_sum, q_mag2, qr, max_distance,
                                             ci.contiguous(), rows.contiguous())
    bd, bi = topk_ops.finalize_topk(*fs.lex_topk(dist, idx, k))
    if squeeze:
        return bd[0], bi[0]
    return bd, bi


def scan_with_u8_rerank_device(scan_fn, query_u8, rows_dev, k: int = 100,
                               max_distance: float = 1e3):
    """Candidates-then-rerank (``ops.int4.scan_with_u8_rerank``'s contract)
    with the rescore on the device against a device row mirror."""
    from pixelbox_tpu_torch.ops.int4 import UNBOUNDED_DISTANCE, default_rerank_candidates

    _dist, idx = scan_fn(default_rerank_candidates(k), UNBOUNDED_DISTANCE)
    return rerank_candidates_u8_device(query_u8, idx, rows_dev, k=k, max_distance=max_distance)
