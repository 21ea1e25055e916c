"""Fused threshold scans with guaranteed-exact top-k — the counterpart of
``pixelbox_tpu/ops/pallas_scan.py``.

Ten hand-written Hopper kernels (``csrc/fused_scan.cu``) replace the
JAX package's one Pallas TPU kernel family
(``pallas_scan.py:_threshold_kernel``; kinds "cosine", "cosine4a",
"cosine4" and "hamming", selects "carry" and "buffer"):

- **K1a** :func:`cosine_threshold_collect` — exact int8 dot + spec-v2
  epilogue + strict ``dist < θ_q`` filter; passing rows are appended to a
  per-query ``[Q, cap]`` buffer with an exact atomic count.
- **K1b** :func:`cosine_chunk_topk` — the same dot and epilogue with
  θ = max_distance; each block sorts its row chunk by (dist, id) in shared
  memory and keeps the chunk's first k.
- **K1c** :func:`lex_topk_segments` — per (query, segment) bitonic sort on
  (dist, id), keeping k; re-launched until one segment per query remains.
  It finishes K1a's buffer and K1b's partials, and sorting on the id as
  the second key makes both independent of atomic order.
- **K2a** :func:`hamming_threshold_collect` and **K2b**
  :func:`hamming_chunk_topk` — K1a and K1b for the Hamming kind: xor +
  popcount over the first ``byte_limit`` bytes of the packed u8 phash
  rows, the optional u8 wrap of the reference (engine.rs:603), one f32
  multiply by ``f32(1 / (8 * byte_limit))``.  K1c finishes both.
- **K4a** :func:`cosine4_threshold_collect` and **K4b**
  :func:`cosine4_chunk_topk` — K1a and K1b over the packed int4 rows
  (``ops/int4.py``: two 4-bit codes a byte, column-blocked), unpacked in
  registers (mask, shift + mask) into two ``__dp4a`` operands per word;
  the affine fix of the asymmetric (u8 query, kind "cosine4a") or the
  symmetric (4-bit query, kind "cosine4") metric, then K1a's epilogue.
  K1c finishes both.
- **K1d** :func:`cosine_coskey_collect` and **K4d**
  :func:`cosine4_coskey_collect` — K1a and K4a selecting on the key
  ``-cos`` (the JAX ``epilogue="cos"``, ``_kind_dist_tile`` and
  ``_cos_key_threshold``): no divide, clamp or identical-vector pin on
  the hot (query, row) loop; they store the keys.
- **K1e** :func:`coskey_rescore` — the exact finish of K1d/K4d (the JAX
  ``_exact_dist_gathered`` + ``_coskey_candidate_postpass``): per
  collected slot, gather the row, K1a's dot and ``spec_dist``, keep the
  distance under the strict θ, +inf otherwise.  K1c then sorts.

Uses, exactly where the JAX package launched its kernel.  One code path
serves every kind; a kind object (:class:`CosineQueries`,
:class:`Int4Queries`, :class:`HammingQueries`) picks the distance and the
collect and chunk kernels:

- θ estimate (:func:`sample_theta`, was ``_pallas_sample_theta``): stage 1
  plain torch over a 1/16 mini-sample, stage 2 K1a/K4a/K2a + K1c over the
  sample;
- main pass (:func:`fused_threshold_scan_topk`, was
  ``pallas_threshold_scan_topk(_v2)``; :func:`fused_threshold4_scan_topk`,
  was ``int4.py:pallas_threshold4_scan_topk``;
  :func:`fused_hamming_threshold_scan_topk`, was
  ``pallas_hamming_threshold_scan_topk(_v2)``): K1a/K4a/K2a + K1c at
  every batch size, or with ``epilogue="cos"`` (cosine kinds only) K1d/K4d
  + K1e + K1c; proof ``count <= cap ∧ (k-th distance finite ∨ θ unbound)``
  (the JAX buffer contract);
- exact scan (:func:`fused_cosine_scan_topk`, was
  ``pallas_cosine_scan_topk``; :func:`fused_cosine4_scan_topk`, where the
  JAX package ran its XLA ``cosine4(a)_scan_topk``;
  :func:`fused_hamming_scan_topk`): K1b/K4b/K2b + K1c, unconditionally
  exact — the auto paths' repair, ``--scan-mode pallas``, and the
  mixed-width phash and duplicate scans.

Dispatch is by device and nothing else: a CUDA tensor goes to the kernel
(or the wrapper raises), a CPU tensor goes to the kernel's plain PyTorch
version in this module.  The plain versions compute the dot exactly (a
float64 matmul of int8 codes is exact for any realistic D) and select
with a (dist, id) sort; the CPU tests hold them bit-identical to the JAX
package, and ``chip_smoke.py`` holds the kernels bit-identical to them.

What bounds the kernels on the card: K1a/K1b read the int8 index once
per query tile (32 / 4 queries) and spend ~D/4 ``__dp4a`` per (query,
row) plus one correctly-rounded divide — integer-ALU and divide bound at
Q >= 32, HBM-read bound below; K4a/K4b read half the bytes and spend
the same ``__dp4a`` plus one mask and one shift + mask per packed word;
K1d/K4d are K1a/K4a without the divide, clamp and pin; K1e is bound by
its gathered rows.  K2a/K2b spend byte_limit/4 ``__popc``
per (query, row) — popcount-throughput bound at Q >= 32.  The design
keeps distances out of device memory (only θ-passing rows or each
chunk's top-k are written); tensor-core versions (an int8 ``wgmma`` dot,
a ``.b1`` MMA or ±1 int8 product for Hamming) and fusing K1a with K1c
are later work (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pixelbox_tpu_torch.ops import topk as topk_ops
from pixelbox_tpu_torch.ops.distances import _f32, rsqrt_spec
from pixelbox_tpu_torch.ops.packed import (
    PackedHammingIndex,
    PackedSemanticIndex,
    query4_moments_from_u8,
    query_moments_from_u8,
)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("fused_scan.cu",)
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-gencode", "arch=compute_90a,code=sm_90a", "-fmad=false",
    "-Xptxas", "-v",
)

#: Queries staged per K1a block; K1a stages ``_COLLECT_Q * D`` bytes of
#: shared memory (must stay under the 48 KB static-launch limit).
_COLLECT_Q = 32
#: Rows per K1b chunk (power of two); the chunk keeps its first k.
CHUNK_ROWS = 1024
#: Candidates per K1c segment (power of two, >= 2k so each pass shrinks).
SEGMENT = 2048
#: Largest k the kernels take (K1b keeps k of CHUNK_ROWS, K1c k of SEGMENT/2).
MAX_K = 1024
#: Row block of the plain versions (bounds their [Q, block] temporaries).
_PLAIN_BLOCK = 65536
#: Element budget of the plain Hamming versions' [Q, rows, bytes] xor.
_PLAIN_XOR_ELEMS = 1 << 26
#: Element budget of the plain K1e's [B, cap, D] row gather.
_PLAIN_GATHER_ELEMS = 1 << 24
#: The main pass's selection epilogues (the JAX ``epilogue`` argument).
EPILOGUES = ("dist", "cos")


# --------------------------------------------------------------------- #
# Build + bind (nvcc into the package's git-ignored build directory,
# plain C interface, ctypes)


class _Kernels(NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_seconds: float
    ptxas: str


_KERNELS: Optional[_Kernels] = None
_KERNELS_LOCK = threading.Lock()


def _build_dir() -> Path:
    d = os.environ.get("PIXELBOX_TPU_TORCH_BUILD_DIR")
    return Path(d) if d else _CSRC.parent / "_build"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load_kernels() -> _Kernels:
    """Compile ``csrc/fused_scan.cu`` for sm_90a (once per source/flag
    content) and load the library.  Raises on any failure — there is no
    fallback."""
    global _KERNELS
    with _KERNELS_LOCK:
        if _KERNELS is None:
            _KERNELS = _build_and_load()
        return _KERNELS


def build_library(sources, stem: str) -> _Kernels:
    """Compile ``csrc`` sources into one shared library for sm_90a and
    load it (no symbols bound).  The file name carries a hash of the
    flags, the sources and every ``csrc`` header, so an edit rebuilds and
    an unchanged tree reuses the build.  Raises on any failure."""
    srcs = [_CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(s.read_bytes())
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"{stem}-{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    ptxas = ""
    if not so.exists():
        tmp = out_dir / f".{so.name}.{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        ptxas = res.stderr
        os.replace(tmp, so)
    return _Kernels(ctypes.CDLL(str(so)), str(so), time.perf_counter() - t0, ptxas)


def _build_and_load() -> _Kernels:
    kern = build_library(_SOURCES, "libpixelbox_fused_scan")
    lib = kern.lib
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.px_threshold_collect.restype = ci
    lib.px_threshold_collect.argtypes = [vp] * 7 + [ci] * 4 + [vp] * 4
    lib.px_chunk_topk.restype = ci
    lib.px_chunk_topk.argtypes = [vp] * 4 + [cf, vp, vp] + [ci] * 6 + [vp] * 3
    lib.px_lex_topk_segments.restype = ci
    lib.px_lex_topk_segments.argtypes = [vp] * 3 + [ci] * 5 + [vp] * 3
    lib.px_hamming_collect.restype = ci
    lib.px_hamming_collect.argtypes = [vp] * 4 + [ci] * 5 + [cf, ci] + [vp] * 4
    lib.px_hamming_chunk_topk.restype = ci
    lib.px_hamming_chunk_topk.argtypes = [vp, cf, vp, vp] + [ci] * 5 + [cf] + [ci] * 3 + [vp] * 3
    lib.px_cosine4_collect.restype = ci
    lib.px_cosine4_collect.argtypes = [vp] * 7 + [ci] * 5 + [vp] * 4
    lib.px_cosine4_chunk_topk.restype = ci
    lib.px_cosine4_chunk_topk.argtypes = [vp] * 4 + [cf, vp, vp] + [ci] * 7 + [vp] * 3
    lib.px_coskey_collect.restype = ci
    lib.px_coskey_collect.argtypes = [vp] * 7 + [ci] * 4 + [vp] * 4
    lib.px_cosine4_coskey_collect.restype = ci
    lib.px_cosine4_coskey_collect.argtypes = [vp] * 7 + [ci] * 5 + [vp] * 4
    lib.px_coskey_rescore.restype = ci
    lib.px_coskey_rescore.argtypes = [vp] * 7 + [ci] * 5 + [vp] * 4
    return kern


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta, packed=False):
    """Checks the cosine kernels' inputs; ``packed``: int4 rows, uint8
    [N, D/2], against int8 queries [Q, D]."""
    dev = data.device
    qn, d = q_codes.shape
    n = data.shape[0]
    _require(q_codes, "q_codes", torch.int8, (qn, d), dev)
    _require(q_sum, "q_sum", torch.int32, (qn,), dev)
    _require(q_mag2, "q_mag2", torch.int32, (qn,), dev)
    _require(qr, "qr", torch.float32, (qn,), dev)
    if packed:
        if d % 2:
            raise ValueError(f"int4 rows pack two dims a byte; query width {d} is odd")
        _require(data, "data", torch.uint8, (n, d // 2), dev)
    else:
        _require(data, "data", torch.int8, (n, d), dev)
    _require(meta, "meta", torch.int32, (4, n), dev)
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    return dev, qn, n, d


#: Plain-integer launch counts, one per kernel wrapper; each wrapper adds
#: one where it launches its kernel and nowhere else (CPU tensors, which
#: take the plain version, do not count).
LAUNCHES = {
    "cosine_threshold_collect": 0,
    "cosine_chunk_topk": 0,
    "lex_topk_segments": 0,
    "hamming_threshold_collect": 0,
    "hamming_chunk_topk": 0,
    "cosine4_threshold_collect": 0,
    "cosine4_chunk_topk": 0,
    "cosine_coskey_collect": 0,
    "cosine4_coskey_collect": 0,
    "coskey_rescore": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


# --------------------------------------------------------------------- #
# Row meta: [4, N] int32 = [row_sum, mag2 (0 = invalid), bitcast f32
# rsqrt_spec(mag2), pad] — the JAX package's layout (pallas_scan.py:94),
# for the u8 and the int4 index alike (build_semantic4_meta).


def build_row_meta(index) -> torch.Tensor:
    """[4, N] int32 kernel meta of a PackedSemanticIndex or a
    PackedSemantic4Index: row 0 = row sums (centered u8 codes, or the
    4-bit codes); row 1 = row mag2 with 0 marking invalid rows (real rows
    always have mag2 >= D > 0); row 2 = per-row ``rsqrt_spec(mag2)`` f32
    bits; row 3 = padding."""
    mag2 = torch.where(index.valid, index.row_mag2, torch.zeros_like(index.row_mag2))
    rr = rsqrt_spec(mag2.to(torch.float32)).view(torch.int32)
    return torch.stack(
        [index.row_sum, mag2, rr, torch.zeros_like(mag2)], dim=0
    ).to(torch.int32).contiguous()


def _dot8(q_codes, rows_i8):
    """Exact [Q, B] int32 code dot: a float64 matmul of int8 codes is exact
    (|dot| < 2^53 for any realistic D)."""
    return torch.matmul(q_codes.to(torch.float64), rows_i8.to(torch.float64).T).to(torch.int32)


def unpack_u4(packed: torch.Tensor) -> torch.Tensor:
    """Packed int4 rows [..., D/2] uint8 → 4-bit codes [..., D] int8 (low
    nibbles are dims 0..D/2-1, high nibbles D/2..D-1: ``ops/int4.py``'s
    column-blocked layout)."""
    return torch.cat([packed & 0xF, packed >> 4], dim=-1).to(torch.int8)


#: The cosine kinds (the JAX package's names) and their codes in the
#: kernels' C interface (``kU8``, ``kInt4Asym``, ``kInt4Sym``).
_KIND_CODES = {"cosine": 0, "cosine4a": 1, "cosine4": 2}


def _centered(kind: str, dot8, qs, rs, d: int):
    """Exact int32 centered dot Σ(a_c · b_c) of a kind from the code dot
    and the sums (``_kind_dist_tile``; the kernels' ``centered_dot``):
    u8 (2u − 255 both sides) ``4·dot8 + 2·(q_sum + row_sum) + D``; int4
    asymmetric (u8 query, codes u − 128, rows 34·v4 − 255) ``68·dot8 +
    34·row_sum − 510·q_sum − 255·D``; symmetric (34·v4 − 255 both sides)
    ``1156·dot8 − 8670·(q_sum + row_sum) + 65025·D``.  ``qs`` and ``rs``
    broadcast against ``dot8``."""
    if kind == "cosine":
        return 4 * dot8 + 2 * (qs + rs) + d
    if kind == "cosine4a":
        return 68 * dot8 + 34 * rs - 510 * qs - 255 * d
    return 1156 * dot8 - 8670 * (qs + rs) + 65025 * d


def affine4(dot8, q_sum, row_sum, d: int, sym: bool):
    """Exact int32 centered dot of the int4 metrics (:func:`_centered`):
    [Q, B] from dot8 [Q, B], q_sum [Q], row_sum [B]."""
    return _centered("cosine4" if sym else "cosine4a", dot8, q_sum[:, None], row_sum[None, :], d)


def _tile_dist(q_codes, q_sum, q_mag2, qr, data, meta):
    """Plain [Q, B] spec-v2 distances + [1, B] validity of a row block —
    op for op the kernels' ``spec_dist`` (and ``_kind_dist_tile``)."""
    dot8 = _dot8(q_codes, data)
    dot_c = _centered("cosine", dot8, q_sum[:, None], meta[0][None, :], data.shape[1])
    return _spec_dist(dot_c, q_mag2, qr, meta)


def _tile_dist4(q_codes, q_sum, q_mag2, qr, data, meta, sym: bool):
    """:func:`_tile_dist` over packed int4 rows [B, D/2] (kinds cosine4 /
    cosine4a): unpack, exact code dot, the int4 affine fix, the same
    epilogue."""
    dot8 = _dot8(q_codes, unpack_u4(data))
    return _spec_dist(affine4(dot8, q_sum, meta[0], 2 * data.shape[1], sym), q_mag2, qr, meta)


def _tile_key(kind: str, q_codes, q_sum, qr, data, meta):
    """Plain [Q, B] cos keys ``-fl(dot_c · fl(qr · rr))`` + [1, B] validity
    of a row block of a cosine kind — op for op K1d/K4d's key."""
    dot8 = _dot8(q_codes, data if kind == "cosine" else unpack_u4(data))
    dot_c = _centered(kind, dot8, q_sum[:, None], meta[0][None, :], q_codes.shape[1])
    rr = meta[2].contiguous().view(torch.float32)
    return -(dot_c.to(torch.float32) * (qr[:, None] * rr[None, :])), (meta[1] > 0)[None, :]


def _spec_epilogue(dot_c, qr, rr, q_mag2, row_mag2):
    """The spec-v2 distance of exact centered dots, op for op the
    kernels' ``spec_dist``; the query columns ``qr``/``q_mag2`` broadcast
    against the row tensors ``rr``/``row_mag2``."""
    dot_f = dot_c.to(torch.float32)
    cos = dot_f * (qr * rr)
    g = torch.maximum(cos, _f32(1e-6, cos))
    dist = torch.ones_like(g) / g - _f32(1.0, g)
    dist = torch.maximum(dist, _f32(0.0, dist))
    q_mag2_f = q_mag2.to(torch.float32)
    row_mag2_f = row_mag2.to(torch.float32)
    ident = (dot_f == q_mag2_f) & (q_mag2_f == row_mag2_f)
    return torch.where(ident, _f32(0.0, dist), dist)


def _spec_dist(dot_c, q_mag2, qr, meta):
    """The spec-v2 epilogue of [Q, B] exact centered dots: distances and
    the [1, B] validity (row mag2 > 0)."""
    row_mag2 = meta[1]
    rr = meta[2].contiguous().view(torch.float32)
    dist = _spec_epilogue(dot_c, qr[:, None], rr[None, :], q_mag2[:, None], row_mag2[None, :])
    return dist, (row_mag2 > 0)[None, :]


# --------------------------------------------------------------------- #
# K1a: θ-filtered collect


def cosine_threshold_collect(q_codes, q_sum, q_mag2, qr, theta, data, meta, cap: int):
    """Append every valid row with ``dist < theta[q]`` to query q's buffer.

    Returns (count [Q] i32 — the EXACT number of passing rows, cand_d
    [Q, cap] f32, cand_i [Q, cap] i32).  Only the first ``min(count, cap)``
    slots of a row are meaningful; their order is unspecified on the card
    (atomic appends) and ascending row id in the plain version — consumers
    sort by (dist, id).

    Replaces ``pallas_scan.py:_threshold_kernel`` (select="buffer"
    semantics) for the θ stage and the main pass.  On the card it is bound
    by the int8 dot (D/4 ``__dp4a`` per query and row) and the divide;
    it writes only the θ-passing rows (~320 per query at the default
    target), so distances never reach device memory.
    """
    dev, qn, _, _ = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta)
    _require(theta, "theta", torch.float32, (qn,), dev)
    if dev.type != "cuda":
        return cosine_threshold_collect_plain(
            q_codes, q_sum, q_mag2, qr, theta, data, meta, cap
        )
    return _collect_on_card(
        "cosine_threshold_collect", "px_threshold_collect",
        q_codes, q_sum, q_mag2, qr, theta, data, meta, cap,
    )


def _collect_on_card(name, entry, q_codes, q_sum, q_mag2, qr, theta, data, meta, cap, *mode):
    """Launch one of the cosine collect kernels (K1a/K4a/K1d/K4d) through
    its C entry point; ``mode`` holds the int4 kernels' ``sym`` flag.
    Returns (count, cand [Q, cap] f32, cand_i [Q, cap] i32)."""
    dev = data.device
    qn, d = q_codes.shape
    if _COLLECT_Q * d > 48 * 1024:
        raise ValueError(f"dim {d} too wide for {name}")
    kern = load_kernels()
    count = torch.zeros(qn, dtype=torch.int32, device=dev)
    cand_d = torch.empty((qn, cap), dtype=torch.float32, device=dev)
    cand_i = torch.empty((qn, cap), dtype=torch.int32, device=dev)
    q_mag2f = q_mag2.to(torch.float32)
    with torch.cuda.device(dev):
        rc = getattr(kern.lib, entry)(
            _ptr(q_codes), _ptr(q_sum), _ptr(q_mag2f), _ptr(qr), _ptr(theta),
            _ptr(data), _ptr(meta), qn, data.shape[0], d, *mode, cap,
            _ptr(count), _ptr(cand_d), _ptr(cand_i), _stream(dev),
        )
    _check(rc, name)
    LAUNCHES[name] += 1
    return count, cand_d, cand_i


def cosine_threshold_collect_plain(q_codes, q_sum, q_mag2, qr, theta, data, meta, cap):
    """Plain PyTorch version of K1a (collects in ascending row order)."""
    return _collect_plain(
        lambda lo, hi: _tile_dist(q_codes, q_sum, q_mag2, qr, data[lo:hi], meta[:, lo:hi]),
        q_codes.shape[0], data.shape[0], theta, cap, _PLAIN_BLOCK,
    )


def _collect_plain(tile, qn, n, theta, cap, block):
    """The collect shared by the plain K1a and K2a: ``tile(lo, hi)`` gives
    a row block's [Q, B] distances and [1, B] validity."""
    dev = theta.device
    count = torch.zeros(qn, dtype=torch.int64, device=dev)
    cand_d = torch.full((qn, cap), float("inf"), dtype=torch.float32, device=dev)
    cand_i = torch.full((qn, cap), -1, dtype=torch.int32, device=dev)
    for start in range(0, n, block):
        end = min(n, start + block)
        dist, valid = tile(start, end)
        mask = valid & (dist < theta[:, None])
        pos = torch.cumsum(mask, dim=1) - 1 + count[:, None]
        qi, ri = mask.nonzero(as_tuple=True)
        slot = pos[qi, ri]
        keep = slot < cap
        qi, ri, slot = qi[keep], ri[keep], slot[keep]
        cand_d[qi, slot] = dist[qi, ri]
        cand_i[qi, slot] = (ri + start).to(torch.int32)
        count += mask.sum(dim=1)
    return count.to(torch.int32), cand_d, cand_i


# --------------------------------------------------------------------- #
# K1b: per-chunk exact top-k (θ = max_distance)


def cosine_chunk_topk(q_codes, q_sum, q_mag2, qr, max_distance, data, meta, k: int):
    """Per row chunk of :data:`CHUNK_ROWS`, the exact top-k by (dist, id) of
    {valid rows with dist < max_distance}: ([Q, n_chunks, k] f32,
    [Q, n_chunks, k] i32), missing entries +inf / -1.

    Replaces ``pallas_scan.py:_threshold_kernel`` as launched by
    ``pallas_cosine_scan_topk`` (θ = max_distance).  Bound on the card by
    the dot and by the shared-memory bitonic sort of each 1024-row chunk
    (4 queries a block); the index is read once per 4 queries.
    """
    dev, qn, n, d = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta)
    md = float(np.float32(max_distance))
    if dev.type != "cuda":
        return cosine_chunk_topk_plain(q_codes, q_sum, q_mag2, qr, md, data, meta, k)
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the scan kernels' limit of {MAX_K}")
    kern = load_kernels()
    n_chunks = -(-n // CHUNK_ROWS)
    out_d = torch.empty((qn, n_chunks, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_chunks, k), dtype=torch.int32, device=dev)
    q_mag2f = q_mag2.to(torch.float32)
    with torch.cuda.device(dev):
        rc = kern.lib.px_chunk_topk(
            _ptr(q_codes), _ptr(q_sum), _ptr(q_mag2f), _ptr(qr), md,
            _ptr(data), _ptr(meta), qn, n, d, CHUNK_ROWS, k, n_chunks,
            _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "cosine_chunk_topk")
    LAUNCHES["cosine_chunk_topk"] += 1
    return out_d, out_i


def cosine_chunk_topk_plain(q_codes, q_sum, q_mag2, qr, max_distance, data, meta, k):
    """Plain PyTorch version of K1b."""
    return _chunk_topk_plain(
        lambda lo, hi: _tile_dist(q_codes, q_sum, q_mag2, qr, data[lo:hi], meta[:, lo:hi]),
        q_codes.shape[0], data.shape[0], max_distance, k, data.device,
    )


def _chunk_topk_plain(tile, qn, n, max_distance, k, dev):
    """The per-chunk top-k shared by the plain K1b and K4b: ``tile(lo, hi)``
    gives a row block's [Q, B] distances and [1, B] validity."""
    n_chunks = -(-n // CHUNK_ROWS)
    kk = min(k, CHUNK_ROWS)
    out_d = torch.full((qn, n_chunks, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((qn, n_chunks, k), -1, dtype=torch.int32, device=dev)
    md = _f32(max_distance, out_d)
    block = _PLAIN_BLOCK // CHUNK_ROWS * CHUNK_ROWS
    for start in range(0, n, block):
        end = min(n, start + block)
        dist, valid = tile(start, end)
        dist = torch.where(valid & (dist < md), dist, torch.full_like(dist, float("inf")))
        nc = -(-(end - start) // CHUNK_ROWS)
        pad = nc * CHUNK_ROWS - (end - start)
        if pad:
            dist = torch.cat([dist, dist.new_full((qn, pad), float("inf"))], 1)
        # Positions ascend with row id inside a chunk: a stable sort by
        # dist is the (dist, id) order.
        d_s, order = torch.sort(dist.reshape(qn, nc, CHUNK_ROWS), dim=-1, stable=True)
        d_s, order = d_s[..., :kk], order[..., :kk]
        rows = order + (start + torch.arange(nc, device=dev) * CHUNK_ROWS)[None, :, None]
        c0 = start // CHUNK_ROWS
        out_d[:, c0 : c0 + nc, :kk] = d_s
        out_i[:, c0 : c0 + nc, :kk] = torch.where(
            torch.isfinite(d_s), rows, torch.full_like(rows, -1)
        ).to(torch.int32)
    return out_d, out_i


# --------------------------------------------------------------------- #
# K4a / K4b: K1a / K1b over packed int4 rows


def cosine4_threshold_collect(q_codes, q_sum, q_mag2, qr, theta, data, meta, sym: bool, cap: int):
    """K4a: :func:`cosine_threshold_collect` over packed int4 rows
    ``data`` [N, D/2] uint8 against int8 queries [Q, D] — u8 − 128 codes
    with u8 moments (``sym=False``, kind "cosine4a") or 4-bit codes with
    int4 moments (``sym=True``, kind "cosine4").  Same outputs and
    contract: exact count; slot order unspecified on the card, ascending
    row id in the plain version.

    Replaces ``pallas_scan.py:_threshold_kernel`` for the int4 kinds, as
    ``int4.py:pallas_threshold4_scan_topk`` launched it (θ stage and main
    pass).  On the card: K1a's dot over half the row bytes, each packed
    word unpacked in registers into two ``__dp4a`` operands — the same
    integer-ALU bound as K1a at Q >= 32, half its HBM reads below.
    """
    dev, qn, _, _ = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta, packed=True)
    _require(theta, "theta", torch.float32, (qn,), dev)
    if dev.type != "cuda":
        return cosine4_threshold_collect_plain(
            q_codes, q_sum, q_mag2, qr, theta, data, meta, sym, cap
        )
    return _collect_on_card(
        "cosine4_threshold_collect", "px_cosine4_collect",
        q_codes, q_sum, q_mag2, qr, theta, data, meta, cap, int(sym),
    )


def cosine4_threshold_collect_plain(q_codes, q_sum, q_mag2, qr, theta, data, meta, sym, cap):
    """Plain PyTorch version of K4a (collects in ascending row order)."""
    return _collect_plain(
        lambda lo, hi: _tile_dist4(q_codes, q_sum, q_mag2, qr, data[lo:hi], meta[:, lo:hi], sym),
        q_codes.shape[0], data.shape[0], theta, cap, _PLAIN_BLOCK,
    )


def cosine4_chunk_topk(q_codes, q_sum, q_mag2, qr, max_distance, data, meta, sym: bool, k: int):
    """K4b: :func:`cosine_chunk_topk` over packed int4 rows (arguments as
    :func:`cosine4_threshold_collect`): per row chunk of
    :data:`CHUNK_ROWS`, the exact top-k by (dist, id) of {valid rows with
    dist < max_distance}; ([Q, n_chunks, k] f32, [Q, n_chunks, k] i32),
    missing entries +inf / -1.

    The exact int4 scan behind the repair, the small-index gate and the
    duplicate scans, where the JAX package ran its XLA
    ``cosine4(a)_scan_topk``.  Bound on the card like K1b: the dot, and
    the shared-memory bitonic sort of each 1024-row chunk (4 queries a
    block).
    """
    dev, qn, n, d = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta, packed=True)
    md = float(np.float32(max_distance))
    if dev.type != "cuda":
        return cosine4_chunk_topk_plain(q_codes, q_sum, q_mag2, qr, md, data, meta, sym, k)
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the scan kernels' limit of {MAX_K}")
    kern = load_kernels()
    n_chunks = -(-n // CHUNK_ROWS)
    out_d = torch.empty((qn, n_chunks, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_chunks, k), dtype=torch.int32, device=dev)
    q_mag2f = q_mag2.to(torch.float32)
    with torch.cuda.device(dev):
        rc = kern.lib.px_cosine4_chunk_topk(
            _ptr(q_codes), _ptr(q_sum), _ptr(q_mag2f), _ptr(qr), md,
            _ptr(data), _ptr(meta), qn, n, d, int(sym), CHUNK_ROWS, k, n_chunks,
            _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "cosine4_chunk_topk")
    LAUNCHES["cosine4_chunk_topk"] += 1
    return out_d, out_i


def cosine4_chunk_topk_plain(q_codes, q_sum, q_mag2, qr, max_distance, data, meta, sym, k):
    """Plain PyTorch version of K4b."""
    return _chunk_topk_plain(
        lambda lo, hi: _tile_dist4(q_codes, q_sum, q_mag2, qr, data[lo:hi], meta[:, lo:hi], sym),
        q_codes.shape[0], data.shape[0], max_distance, k, data.device,
    )


# --------------------------------------------------------------------- #
# K1d / K4d: collect on the cos key; K1e: their exact finish
#
# The JAX package's epilogue="cos" (pallas_scan.py:_kind_dist_tile with
# the key -cos, _cos_key_threshold, _coskey_candidate_postpass).  dist is
# monotone non-increasing in cos, and ``dist < θ`` ⟺ ``cos > 1/(1 + θ)``
# up to a few ulps of spec rounding; the key threshold's 1e-5 relative
# margin (:func:`cos_key_threshold`) makes the key filter admit a STRICT
# SUPERSET of the ``dist < θ`` rows — false positives only, which K1e
# removes by applying the true, strict θ to the exact distance.  The
# port's collect keeps every key-passing row under an exact count (not
# the top G by key, as the TPU carry did), so the TPU's plateau check has
# no counterpart: the proof is ``count <= cap`` (every key-passing row,
# hence every θ-passing row, collected) and then the k-th rescored
# distance finite or θ unbound.

#: The distance every cos ≤ 1e-6 saturates to (spec v2,
#: ``pallas_scan.py:_DIST_SATURATION``): a θ at or above it admits every
#: valid row, so its key threshold is +inf.
DIST_SATURATION = float(np.float32(1.0) / np.float32(1e-6) - np.float32(1.0))


def cos_key_threshold(theta: torch.Tensor) -> torch.Tensor:
    """[Q] f32 key threshold of the strict distance thresholds ``theta``
    [Q] f32, op for op ``pallas_scan.py:_cos_key_threshold``: ``c =
    fl(fl(1 / fl(1 + θ)) · f32(1 − 1e-5))``, key θ = −c, +inf where θ ≥
    :data:`DIST_SATURATION`.  Computed with f32 tensor ops (IEEE divide)
    on the thresholds' own device, for the kernels and their plain
    versions alike."""
    one = _f32(1.0, theta)
    c = (one / (one + theta)) * _f32(1 - 1e-5, theta)
    return torch.where(
        theta >= _f32(DIST_SATURATION, theta), torch.full_like(theta, float("inf")), -c
    ).contiguous()


def cosine_coskey_collect(q_codes, q_sum, q_mag2, qr, key_theta, data, meta, cap: int):
    """K1d: append every valid row with ``-cos < key_theta[q]`` to query
    q's buffer.  Returns (count [Q] i32 — the EXACT number of passing
    rows, cand_key [Q, cap] f32 — the keys −cos, cand_i [Q, cap] i32);
    slot order as :func:`cosine_threshold_collect`.

    Replaces ``pallas_scan.py:_threshold_kernel`` with ``epilogue="cos"``
    (``_kind_dist_tile`` :171-174).  On the card: K1a's dot with no
    divide, clamp or pin — still bound by the D/4 ``__dp4a`` per query
    and row at Q >= 32."""
    dev, qn, _, _ = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta)
    _require(key_theta, "key_theta", torch.float32, (qn,), dev)
    if dev.type != "cuda":
        return cosine_coskey_collect_plain(q_codes, q_sum, q_mag2, qr, key_theta, data, meta, cap)
    return _collect_on_card(
        "cosine_coskey_collect", "px_coskey_collect",
        q_codes, q_sum, q_mag2, qr, key_theta, data, meta, cap,
    )


def cosine_coskey_collect_plain(q_codes, q_sum, q_mag2, qr, key_theta, data, meta, cap):
    """Plain PyTorch version of K1d (keys, ascending row order)."""
    return _collect_plain(
        lambda lo, hi: _tile_key("cosine", q_codes, q_sum, qr, data[lo:hi], meta[:, lo:hi]),
        q_codes.shape[0], data.shape[0], key_theta, cap, _PLAIN_BLOCK,
    )


def cosine4_coskey_collect(q_codes, q_sum, q_mag2, qr, key_theta, data, meta, sym: bool, cap: int):
    """K4d: :func:`cosine_coskey_collect` over packed int4 rows (arguments
    as :func:`cosine4_threshold_collect`) — the int4 kinds' cos key."""
    dev, qn, _, _ = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta, packed=True)
    _require(key_theta, "key_theta", torch.float32, (qn,), dev)
    if dev.type != "cuda":
        return cosine4_coskey_collect_plain(
            q_codes, q_sum, q_mag2, qr, key_theta, data, meta, sym, cap
        )
    return _collect_on_card(
        "cosine4_coskey_collect", "px_cosine4_coskey_collect",
        q_codes, q_sum, q_mag2, qr, key_theta, data, meta, cap, int(sym),
    )


def cosine4_coskey_collect_plain(q_codes, q_sum, q_mag2, qr, key_theta, data, meta, sym, cap):
    """Plain PyTorch version of K4d (keys, ascending row order)."""
    kind = "cosine4" if sym else "cosine4a"
    return _collect_plain(
        lambda lo, hi: _tile_key(kind, q_codes, q_sum, qr, data[lo:hi], meta[:, lo:hi]),
        q_codes.shape[0], data.shape[0], key_theta, cap, _PLAIN_BLOCK,
    )


def coskey_rescore(q_codes, q_sum, q_mag2, qr, theta, data, meta, kind: str, lens, cand_i):
    """K1e: the exact spec distance of every collected candidate, kept
    where it is ``< theta[q]`` (the strict distance threshold) and +inf
    otherwise; slots at or past ``lens[q]`` read +inf.  ``kind`` is
    "cosine" (u8 rows [N, D]) or "cosine4a" / "cosine4" (packed int4 rows
    [N, D/2], queries as :func:`cosine4_threshold_collect`); ``cand_i``
    [Q, cap] i32 from K1d/K4d.  Returns a new [Q, cap] f32 tensor.

    Replaces ``pallas_scan.py:_exact_dist_gathered`` and
    ``_coskey_candidate_postpass`` (:747, the gather and the strict θ;
    K1c does the sort).  The row dot, ``centered_dot`` and ``spec_dist``
    are K1a's device functions, so the distances are bit-identical to
    K1a's.  On the card: one thread per slot, bound by the gathered rows
    (min(count, cap) per query) and the [Q, cap] output."""
    if kind not in _KIND_CODES:
        raise ValueError(f"no cos key for kind {kind!r} (cosine kinds: {sorted(_KIND_CODES)})")
    dev, qn, n, d = _check_query_args(
        q_codes, q_sum, q_mag2, qr, data, meta, packed=kind != "cosine"
    )
    _require(theta, "theta", torch.float32, (qn,), dev)
    _require(lens, "lens", torch.int32, (qn,), dev)
    _require(cand_i, "cand_i", torch.int32, (qn, cand_i.shape[-1]), dev)
    cap = cand_i.shape[1]
    if dev.type != "cuda":
        return coskey_rescore_plain(q_codes, q_sum, q_mag2, qr, theta, data, meta, kind, lens, cand_i)
    if d > 48 * 1024:
        raise ValueError(f"dim {d} too wide for coskey_rescore")
    kern = load_kernels()
    out = torch.empty((qn, cap), dtype=torch.float32, device=dev)
    q_mag2f = q_mag2.to(torch.float32)
    with torch.cuda.device(dev):
        rc = kern.lib.px_coskey_rescore(
            _ptr(q_codes), _ptr(q_sum), _ptr(q_mag2f), _ptr(qr), _ptr(theta),
            _ptr(data), _ptr(meta), qn, n, d, _KIND_CODES[kind], cap,
            _ptr(lens), _ptr(cand_i), _ptr(out), _stream(dev),
        )
    _check(rc, "coskey_rescore")
    LAUNCHES["coskey_rescore"] += 1
    return out


def coskey_rescore_plain(q_codes, q_sum, q_mag2, qr, theta, data, meta, kind, lens, cand_i):
    """Plain PyTorch version of K1e: gathered rows, an exact int32 code
    dot, :func:`_centered` and :func:`_spec_epilogue` — in query blocks
    that bound the [B, cap, D] gather."""
    qn, cap = cand_i.shape
    d = q_codes.shape[1]
    live = torch.arange(cap, device=cand_i.device)[None, :] < lens[:, None]
    rows = torch.where(live, cand_i, torch.zeros_like(cand_i)).long()
    out = torch.full((qn, cap), float("inf"), dtype=torch.float32, device=cand_i.device)
    step = max(1, _PLAIN_GATHER_ELEMS // max(1, cap * d))
    for s in range(0, qn, step):
        e = min(qn, s + step)
        r = rows[s:e]
        g = data[r] if kind == "cosine" else unpack_u4(data[r])
        dot8 = (g.to(torch.int32) * q_codes[s:e, None, :].to(torch.int32)).sum(-1, dtype=torch.int32)
        m = meta[:, r]
        dot_c = _centered(kind, dot8, q_sum[s:e, None], m[0], d)
        dist = _spec_epilogue(
            dot_c, qr[s:e, None], m[2].contiguous().view(torch.float32), q_mag2[s:e, None], m[1]
        )
        keep = live[s:e] & (dist < theta[s:e, None])
        out[s:e] = torch.where(keep, dist, torch.full_like(dist, float("inf")))
    return out


# --------------------------------------------------------------------- #
# K1c: segmented lexicographic top-k


def _keys(dist, idx, lens):
    """(dist, id) → int64 keys (dist >= 0: its f32 bits order like the
    value); empty entries (non-finite, id < 0, or at/after lens) → max."""
    valid = torch.isfinite(dist) & (idx >= 0)
    if lens is not None:
        pos = torch.arange(dist.shape[1], device=dist.device)
        valid &= pos[None, :] < lens[:, None]
    bits = dist.contiguous().view(torch.int32).to(torch.int64)
    key = (bits << 32) | idx.to(torch.int64)
    return torch.where(valid, key, torch.full_like(key, torch.iinfo(torch.int64).max))


def lex_topk_segments(dist, idx, k: int, lens=None, segment: int = SEGMENT):
    """Per (query, segment of ``segment`` candidates), the segment's first k
    by (dist, id): ([Q, n_seg, k] f32, [Q, n_seg, k] i32), empty entries
    +inf / -1.  ``lens[q]`` (optional) marks how many leading entries of
    query q's row are meaningful.

    Replaces the selection half of ``pallas_scan.py:_threshold_kernel``
    (its sorted carry insertion and the buffer wrapper's final top-k).
    Bound on the card by the shared-memory bitonic sort (S·log²S/4 compare-
    exchanges per segment); one block per (query, segment).
    """
    dev = dist.device
    qn, m = dist.shape
    _require(dist, "dist", torch.float32, (qn, m), dev)
    _require(idx, "idx", torch.int32, (qn, m), dev)
    if lens is not None:
        _require(lens, "lens", torch.int32, (qn,), dev)
    if k > segment // 2:  # each pass must shrink the pool (lex_topk's loop)
        raise ValueError(f"k={k} exceeds half the segment ({segment})")
    if dev.type != "cuda":
        return lex_topk_segments_plain(dist, idx, k, lens, segment)
    kern = load_kernels()
    n_seg = -(-m // segment)
    out_d = torch.empty((qn, n_seg, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_seg, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_lex_topk_segments(
            _ptr(dist), _ptr(idx),
            ctypes.c_void_p(None if lens is None else lens.data_ptr()),
            qn, m, segment, k, n_seg, _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "lex_topk_segments")
    LAUNCHES["lex_topk_segments"] += 1
    return out_d, out_i


def lex_topk_segments_plain(dist, idx, k, lens=None, segment: int = SEGMENT):
    """Plain PyTorch version of K1c."""
    qn, m = dist.shape
    n_seg = -(-m // segment)
    key = _keys(dist, idx, lens)
    big = torch.iinfo(torch.int64).max
    pad = n_seg * segment - m
    if pad:
        key = torch.cat([key, key.new_full((qn, pad), big)], 1)
    key = torch.sort(key.reshape(qn, n_seg, segment), dim=-1).values[..., :k]
    empty = key == big
    d = (key >> 32).to(torch.int32).contiguous().view(torch.float32)
    i = (key & 0xFFFFFFFF).to(torch.int32)
    return (
        torch.where(empty, torch.full_like(d, float("inf")), d),
        torch.where(empty, torch.full_like(i, -1), i),
    )


def lex_topk(dist, idx, k: int, lens=None):
    """Exact top-k by (dist, id) of each query's candidates: K1c re-launched
    over its own output until one segment remains.  ([Q, k], [Q, k])."""
    qn = dist.shape[0]
    d, i = lex_topk_segments(dist, idx, k, lens)
    while d.shape[1] > 1:
        d, i = lex_topk_segments(d.reshape(qn, -1), i.reshape(qn, -1), k)
    return d[:, 0], i[:, 0]


# --------------------------------------------------------------------- #
# Hamming: K2a (θ-filtered collect) and K2b (per-chunk exact top-k) over
# packed u8 phash rows.  Row "meta" is one uint8 [N] row mask: validity
# AND the optional width-group mask (build_hamming_meta).

#: Popcount of every byte value — the plain versions' exact bit count.
_POPCOUNT = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.uint8)


def hamming_scale(byte_limit: int) -> float:
    """The distance scale ``f32(1 / (8 * byte_limit))`` (JAX spec:
    ``ops/scan.py:hamming_scan_topk``, ``pallas_scan.py:_kind_dist_tile``)."""
    return float(np.float32(1.0 / (8.0 * byte_limit)))


def build_hamming_meta(index: PackedHammingIndex, group=None) -> torch.Tensor:
    """uint8 [N] row mask of the Hamming kernels: 1 where the row is valid
    and (when ``group`` — a bool [N] width-group mask, numpy or torch —
    is given) in the group.  The counterpart of the JAX package's
    ``build_hamming_meta`` (its row 0 is the validity)."""
    ok = index.valid
    if group is not None:
        ok = ok & torch.as_tensor(group, dtype=torch.bool).to(index.device)
    return ok.to(torch.uint8).contiguous()


def hamming_bits(q: torch.Tensor, rows: torch.Tensor, byte_limit: int) -> torch.Tensor:
    """[Q, B] int32 differing bits of u8 queries [Q, H] and rows [B, H]
    over the first ``byte_limit`` bytes: ``torch.bitwise_xor`` plus a
    byte popcount table, in row blocks that bound the [Q, rows, bytes]
    temporaries."""
    qn, b = q.shape[0], rows.shape[0]
    qs = q[:, None, :byte_limit]
    lut = _POPCOUNT.to(q.device)
    step = max(1, _PLAIN_XOR_ELEMS // max(1, qn * byte_limit))
    out = torch.empty((qn, b), dtype=torch.int32, device=q.device)
    for s in range(0, b, step):
        x = torch.bitwise_xor(qs, rows[None, s : s + step, :byte_limit])
        cnt = torch.index_select(lut, 0, x.reshape(-1).to(torch.int32))
        out[:, s : s + step] = cnt.reshape(x.shape).sum(dim=-1, dtype=torch.int32)
    return out


def _hamming_tile_dist(q, data, meta, byte_limit: int, wrap_u8: bool):
    """Plain [Q, B] distances + [1, B] row mask of a row block — op for op
    the kernels' ``hamming_dist``."""
    bits = hamming_bits(q, data, byte_limit)
    if wrap_u8:
        bits = bits & 255
    dist = bits.to(torch.float32)
    dist = dist * _f32(hamming_scale(byte_limit), dist)
    return dist, (meta != 0)[None, :]


def _check_hamming_args(q, data, meta, byte_limit):
    dev = data.device
    qn, h = q.shape
    n = data.shape[0]
    _require(q, "q", torch.uint8, (qn, h), dev)
    _require(data, "data", torch.uint8, (n, h), dev)
    _require(meta, "meta", torch.uint8, (n,), dev)
    if not 0 < byte_limit <= h:
        raise ValueError(f"byte_limit {byte_limit} outside 1..{h}")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    return dev, qn, n, h


def hamming_threshold_collect(q, theta, data, meta, byte_limit: int, wrap_u8: bool, cap: int):
    """K2a: append every row with ``meta != 0`` and ``dist < theta[q]`` to
    query q's buffer.  Same outputs and contract as
    :func:`cosine_threshold_collect` (exact count; slot order unspecified
    on the card, ascending row id in the plain version).

    Replaces ``pallas_scan.py:_threshold_kernel`` for kind="hamming" (the
    θ stage and the main pass of ``pallas_hamming_threshold_scan_topk``
    and ``_v2``).  Bound on the card by ``__popc`` throughput
    (byte_limit/4 per query and row); the packed rows are read once per
    32 queries and only θ-passing rows are written.
    """
    dev, qn, n, h = _check_hamming_args(q, data, meta, byte_limit)
    _require(theta, "theta", torch.float32, (qn,), dev)
    if dev.type != "cuda":
        return hamming_threshold_collect_plain(q, theta, data, meta, byte_limit, wrap_u8, cap)
    if _COLLECT_Q * h > 48 * 1024:
        raise ValueError(f"hash width {h} too wide for hamming_threshold_collect")
    kern = load_kernels()
    count = torch.zeros(qn, dtype=torch.int32, device=dev)
    cand_d = torch.empty((qn, cap), dtype=torch.float32, device=dev)
    cand_i = torch.empty((qn, cap), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_hamming_collect(
            _ptr(q), _ptr(theta), _ptr(data), _ptr(meta), qn, n, h, byte_limit,
            int(wrap_u8), hamming_scale(byte_limit), cap,
            _ptr(count), _ptr(cand_d), _ptr(cand_i), _stream(dev),
        )
    _check(rc, "hamming_threshold_collect")
    LAUNCHES["hamming_threshold_collect"] += 1
    return count, cand_d, cand_i


def hamming_threshold_collect_plain(q, theta, data, meta, byte_limit, wrap_u8, cap):
    """Plain PyTorch version of K2a (collects in ascending row order)."""
    return _collect_plain(
        lambda lo, hi: _hamming_tile_dist(q, data[lo:hi], meta[lo:hi], byte_limit, wrap_u8),
        q.shape[0], data.shape[0], theta, cap, _PLAIN_BLOCK,
    )


def hamming_chunk_topk(q, max_distance, data, meta, byte_limit: int, wrap_u8: bool, k: int):
    """K2b: per row chunk of :data:`CHUNK_ROWS`, the exact top-k by
    (dist, id) of {rows with ``meta != 0`` and dist < max_distance}:
    ([Q, n_chunks, k] f32, [Q, n_chunks, k] i32), missing entries +inf / -1.

    The Hamming counterpart of :func:`cosine_chunk_topk` — the exact scan
    behind the Hamming repair, the mixed-width phash search and the
    duplicate scans.  Bound on the card by ``__popc`` and by the shared-
    memory bitonic sort of each 1024-row chunk (4 queries a block).
    """
    dev, qn, n, h = _check_hamming_args(q, data, meta, byte_limit)
    md = float(np.float32(max_distance))
    if dev.type != "cuda":
        return hamming_chunk_topk_plain(q, md, data, meta, byte_limit, wrap_u8, k)
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the scan kernels' limit of {MAX_K}")
    if 4 * CHUNK_ROWS * 8 + 4 * h > 48 * 1024:
        raise ValueError(f"hash width {h} too wide for hamming_chunk_topk")
    kern = load_kernels()
    n_chunks = -(-n // CHUNK_ROWS)
    out_d = torch.empty((qn, n_chunks, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_chunks, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_hamming_chunk_topk(
            _ptr(q), md, _ptr(data), _ptr(meta), qn, n, h, byte_limit,
            int(wrap_u8), hamming_scale(byte_limit), CHUNK_ROWS, k, n_chunks,
            _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "hamming_chunk_topk")
    LAUNCHES["hamming_chunk_topk"] += 1
    return out_d, out_i


def hamming_chunk_topk_plain(q, max_distance, data, meta, byte_limit, wrap_u8, k):
    """Plain PyTorch version of K2b: (dist, id) int64 keys per chunk, the
    k smallest by ``torch.topk`` (keys are unique, so the order is)."""
    dev = data.device
    qn, n = q.shape[0], data.shape[0]
    n_chunks = -(-n // CHUNK_ROWS)
    kk = min(k, CHUNK_ROWS)
    out_d = torch.full((qn, n_chunks, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((qn, n_chunks, k), -1, dtype=torch.int32, device=dev)
    md = _f32(max_distance, out_d)
    big = torch.iinfo(torch.int64).max
    per = _PLAIN_BLOCK // CHUNK_ROWS
    for c0 in range(0, n_chunks, per):
        start, end = c0 * CHUNK_ROWS, min(n, (c0 + per) * CHUNK_ROWS)
        dist, ok = _hamming_tile_dist(q, data[start:end], meta[start:end], byte_limit, wrap_u8)
        rows = torch.arange(start, end, dtype=torch.int64, device=dev)
        key = (dist.contiguous().view(torch.int32).to(torch.int64) << 32) | rows[None, :]
        key = torch.where(ok & (dist < md), key, torch.full_like(key, big))
        nc = -(-(end - start) // CHUNK_ROWS)
        pad = nc * CHUNK_ROWS - (end - start)
        if pad:
            key = torch.cat([key, key.new_full((qn, pad), big)], 1)
        top = torch.topk(
            key.reshape(qn, nc, CHUNK_ROWS), kk, dim=-1, largest=False, sorted=True
        ).values
        empty = top == big
        d = (top >> 32).to(torch.int32).contiguous().view(torch.float32)
        out_d[:, c0 : c0 + nc, :kk] = torch.where(empty, torch.full_like(d, float("inf")), d)
        out_i[:, c0 : c0 + nc, :kk] = torch.where(
            empty, torch.full_like(top, -1), top & 0xFFFFFFFF
        ).to(torch.int32)
    return out_d, out_i


# --------------------------------------------------------------------- #
# The kinds: what the shared θ estimate, main pass and exact scan need
# from each (a distance tile for the mini-sample, the collect and chunk
# kernels, the θ widening).


def _prep(query_u8: torch.Tensor, moments=query_moments_from_u8):
    q_codes, q_sum, q_mag2 = moments(query_u8)
    qr = rsqrt_spec(q_mag2.to(torch.float32))
    return q_codes.contiguous(), q_sum.contiguous(), q_mag2.contiguous(), qr


class CosineQueries(NamedTuple):
    """u8 queries prepared for the cosine kernels (spec-v2 moments)."""

    q_codes: torch.Tensor
    q_sum: torch.Tensor
    q_mag2: torch.Tensor
    qr: torch.Tensor

    @classmethod
    def from_u8(cls, query_u8: torch.Tensor) -> "CosineQueries":
        return cls(*_prep(query_u8))

    def dist(self, data, meta):
        return _tile_dist(self.q_codes, self.q_sum, self.q_mag2, self.qr, data, meta)

    def collect(self, theta, data, meta, cap):
        return cosine_threshold_collect(
            self.q_codes, self.q_sum, self.q_mag2, self.qr, theta, data, meta, cap
        )

    def chunk_topk(self, max_distance, data, meta, k):
        return cosine_chunk_topk(
            self.q_codes, self.q_sum, self.q_mag2, self.qr, max_distance, data, meta, k
        )

    def coskey_collect(self, key_theta, data, meta, cap):
        return cosine_coskey_collect(
            self.q_codes, self.q_sum, self.q_mag2, self.qr, key_theta, data, meta, cap
        )

    def rescore(self, theta, data, meta, lens, cand_i):
        return coskey_rescore(
            self.q_codes, self.q_sum, self.q_mag2, self.qr, theta, data, meta,
            "cosine", lens, cand_i,
        )

    def widen(self, theta):
        return theta


class Int4Queries(NamedTuple):
    """u8 queries prepared for the int4 kernels K4a/K4b (the JAX
    ``_prep_cosine`` / ``_prep_cosine4``): ``mode="asym"`` keeps the u8
    codes and moments against the 4-bit rows (kind "cosine4a"),
    ``mode="sym"`` quantizes the queries to 4 bits too (kind "cosine4")."""

    q_codes: torch.Tensor
    q_sum: torch.Tensor
    q_mag2: torch.Tensor
    qr: torch.Tensor
    mode: str

    @classmethod
    def from_u8(cls, query_u8: torch.Tensor, mode: str = "asym") -> "Int4Queries":
        if mode not in ("asym", "sym"):
            raise ValueError(f"int4 query_mode must be 'asym' or 'sym', got {mode!r}")
        moments = query4_moments_from_u8 if mode == "sym" else query_moments_from_u8
        return cls(*_prep(query_u8, moments), mode)

    @property
    def sym(self) -> bool:
        return self.mode == "sym"

    def dist(self, data, meta):
        return _tile_dist4(self.q_codes, self.q_sum, self.q_mag2, self.qr, data, meta, self.sym)

    def collect(self, theta, data, meta, cap):
        return cosine4_threshold_collect(
            self.q_codes, self.q_sum, self.q_mag2, self.qr, theta, data, meta, self.sym, cap
        )

    def chunk_topk(self, max_distance, data, meta, k):
        return cosine4_chunk_topk(
            self.q_codes, self.q_sum, self.q_mag2, self.qr, max_distance, data, meta, self.sym, k
        )

    def coskey_collect(self, key_theta, data, meta, cap):
        return cosine4_coskey_collect(
            self.q_codes, self.q_sum, self.q_mag2, self.qr, key_theta, data, meta, self.sym, cap
        )

    def rescore(self, theta, data, meta, lens, cand_i):
        return coskey_rescore(
            self.q_codes, self.q_sum, self.q_mag2, self.qr, theta, data, meta,
            "cosine4" if self.sym else "cosine4a", lens, cand_i,
        )

    def widen(self, theta):
        """One ulp up: ``dist < θ'`` ⟺ ``dist <= θ``.  The 4-bit grid makes
        tie plateaus likely (both sides 4-bit under "sym"); a strict θ on
        the sample's j-th value would leave that whole plateau out and the
        proof fail.  Sound for any θ' ≥ θ: the proof reads the exact count
        of rows under the θ actually used."""
        return torch.nextafter(theta, torch.full_like(theta, float("inf")))


class HammingQueries(NamedTuple):
    """u8 queries [Q, H] (zero-padded to the store width) for the Hamming
    kernels, with the zip-truncate ``byte_limit`` and the u8 wrap."""

    q: torch.Tensor
    byte_limit: int
    wrap_u8: bool

    def dist(self, data, meta):
        return _hamming_tile_dist(self.q, data, meta, self.byte_limit, self.wrap_u8)

    def collect(self, theta, data, meta, cap):
        return hamming_threshold_collect(
            self.q, theta, data, meta, self.byte_limit, self.wrap_u8, cap
        )

    def chunk_topk(self, max_distance, data, meta, k):
        return hamming_chunk_topk(
            self.q, max_distance, data, meta, self.byte_limit, self.wrap_u8, k
        )

    def widen(self, theta):
        """The next distance value above θ: Hamming distances take only
        8·byte_limit + 1 values, so a strict θ sitting on the sample's
        j-th value leaves that whole tie plateau out and the proof fails.
        ``fl((b + 1) · scale)`` for θ = ``fl(b · scale)`` collects it.
        Sound for any θ' ≥ θ: the proof reads the exact count of rows
        under the θ actually used."""
        scale = hamming_scale(self.byte_limit)
        b = torch.round(theta.to(torch.float64) * (8 * self.byte_limit))
        up = (b + 1).to(torch.float32)
        up = up * _f32(scale, up)
        return torch.where(torch.isfinite(theta), up, theta)


# --------------------------------------------------------------------- #
# θ estimate, the main pass and the exact scan (one code path, every kind)


def sample_theta(qk, smp, max_distance, j: int):
    """Per-query j-th smallest sample distance — the θ estimate for the
    threshold scan — in the JAX package's two stages
    (``pallas_scan.py:_pallas_sample_theta``):

    1. θ0 from a 1/16 mini-subsample in plain torch (~4j mini rows' worth,
       floor 8);
    2. K1a/K4a/K2a + K1c over the FULL sample: the exact top-j of {dist < θ0}.

    ``qk`` is a :class:`CosineQueries`, :class:`Int4Queries` or
    :class:`HammingQueries`;
    ``smp`` an ``ops.scan.ScanSample`` (contiguous ``data`` and its
    kernel ``meta``, the index's layouts).

    If θ0 comes up short (fewer than j rows under it) or the collect
    buffer overflowed, the value falls back to θ0 itself, exactly as the
    JAX package does; θ accuracy only shapes work, never the proof.
    Returns [Q] f32; value == max_distance ⟺ θ is unbound.
    """
    s = smp.data.shape[0]
    dev = smp.data.device
    md = _f32(max_distance, smp.data)
    stride = 16
    while stride > 1 and (s // stride < 1024 or s % stride != 0):
        stride //= 2
    mini = smp.data[::stride].contiguous()
    mmeta = smp.meta[..., ::stride].contiguous()
    s0 = mini.shape[0]
    j0 = min(s0, max(8, -(-4 * j * s0 // s)))
    dist0, valid0 = qk.dist(mini, mmeta)
    dist0 = torch.where(valid0 & (dist0 < md), dist0, torch.full_like(dist0, float("inf")))
    t0, _ = topk_ops.block_topk(dist0, torch.zeros_like(dist0, dtype=torch.int32), j0)
    theta0 = torch.minimum(t0[:, j0 - 1], md).contiguous()

    cap = max(2048, topk_ops._next_pow2(16 * j))
    count, cand_d, cand_i = qk.collect(theta0, smp.data, smp.meta, cap)
    best_d, _ = lex_topk(cand_d, cand_i, j, lens=torch.clamp(count, max=cap))
    jth = best_d[:, j - 1]
    ok = torch.isfinite(jth) & (count <= cap)
    return torch.where(ok, jth, theta0).to(dev)


def _as_queries(query_u8, device) -> Tuple[torch.Tensor, bool]:
    """u8 queries [Q, D] (or [D], promoted) on ``device``; the flag says
    whether the caller should squeeze its results back to one query."""
    q = query_u8 if torch.is_tensor(query_u8) else torch.as_tensor(np.asarray(query_u8))
    q = q.to(device=device, dtype=torch.uint8)
    squeeze = q.ndim == 1
    return (q[None, :] if squeeze else q), squeeze


def _threshold_scan(qk, data, meta, smp, k, max_distance, target_count, cap, epilogue="dist"):
    """The main pass shared by every kind: θ from the sample (widened by
    the kind; the sample stage always selects on the distance, as
    ``_pallas_sample_theta`` does), the collect over every row, K1c over
    the buffer, and the proof.  ``epilogue="dist"``: K1a/K4a/K2a collect
    the distances under θ.  ``epilogue="cos"`` (cosine kinds): K1d/K4d
    collect the rows under the key threshold, K1e rescores them under the
    strict θ.  Returns (dist [Q,k], idx [Q,k], exact [Q])."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if epilogue == "cos" and isinstance(qk, HammingQueries):
        raise ValueError("Hamming distances have no cos key: epilogue='cos' is for the cosine kinds")
    n_pad = data.shape[0]
    md = _f32(max_distance, data)
    s = smp.data.shape[0]
    if target_count is None:
        target_count = max(16 * k // 5, 256)
    j = min(s, max(1, -(-target_count * s // n_pad)))
    theta_j = qk.widen(sample_theta(qk, smp, max_distance, j))
    theta = torch.minimum(theta_j, md).contiguous()
    unbound = ~(theta_j < md)
    if cap is None:
        cap = max(4096, topk_ops._next_pow2(8 * target_count))
    if epilogue == "cos":
        count, _, cand_i = qk.coskey_collect(cos_key_threshold(theta), data, meta, cap)
        lens = torch.clamp(count, max=cap)
        cand_d = qk.rescore(theta, data, meta, lens, cand_i)
    else:
        count, cand_d, cand_i = qk.collect(theta, data, meta, cap)
        lens = torch.clamp(count, max=cap)
    best_d, best_i = lex_topk(cand_d, cand_i, k, lens=lens)
    # count <= cap: every row passing the filter (dist: exactly the θ rows;
    # cos: a superset of them, the rest now +inf) was collected, so the
    # collected top-k is the true top-k when k rows pass θ (the k-th
    # distance is finite) or when θ is unbound (the WHERE-clause result).
    exact = (count <= cap) & (torch.isfinite(best_d[:, k - 1]) | unbound)
    return best_d, best_i, exact


def _exact_scan(qk, qn, data, meta, k, max_distance):
    """K1b/K4b/K2b + K1c: the exact top-k of ``WHERE dist < max_distance``."""
    part_d, part_i = qk.chunk_topk(max_distance, data, meta, k)
    return lex_topk(part_d.reshape(qn, -1), part_i.reshape(qn, -1), k)


def _squeezed(out, squeeze):
    return tuple(x[0] for x in out) if squeeze else out


def fused_threshold_scan_topk(
    query_u8,
    index: PackedSemanticIndex,
    row_meta: torch.Tensor,
    smp,
    k: int = 100,
    max_distance: float = 1e3,
    target_count: Optional[int] = None,
    cap: Optional[int] = None,
    epilogue: str = "dist",
):
    """Batched guaranteed-verifiable u8 cosine threshold scan — the port of
    ``pallas_threshold_scan_topk_v2`` and of the buffer-select
    ``pallas_threshold_scan_topk`` (Q > 1024): K1a's exact-count buffer
    serves every batch size; ``epilogue="cos"`` selects on the cos key
    (K1d + K1e, the JAX ``epilogue="cos"``) with the same results.
    Returns (dist [Q,k], idx [Q,k], exact [Q]).

    ``exact[q]`` ⟺ the result provably equals the exact scan: the
    collect's count is exact, so ``count <= cap`` means every row passing
    its filter (the θ rows, or a superset of them under the cos key) was
    collected, and then a finite k-th distance (k rows under θ) or θ
    unbound (the collected set IS the WHERE-clause result) makes the
    collected top-k the true top-k.  Use via
    ``ops.scan.cosine_scan_topk_auto``, which repairs unproven queries.
    """
    q, squeeze = _as_queries(query_u8, index.device)
    out = _threshold_scan(
        CosineQueries.from_u8(q), index.data, row_meta, smp, k, max_distance,
        target_count, cap, epilogue,
    )
    return _squeezed(out, squeeze)


def fused_cosine_scan_topk(
    query_u8,
    index: PackedSemanticIndex,
    row_meta: torch.Tensor,
    k: int = 100,
    max_distance: float = 1e3,
):
    """Sample-free fused exact scan — the port of ``pallas_cosine_scan_topk``
    (θ = max_distance for every query; K1b + K1c).  Unconditionally the
    exact top-k of ``WHERE dist < max_distance``: the auto path's repair
    and ``--scan-mode pallas``."""
    q, squeeze = _as_queries(query_u8, index.device)
    out = _exact_scan(
        CosineQueries.from_u8(q), q.shape[0], index.data, row_meta, k, max_distance
    )
    return _squeezed(out, squeeze)


def _int4_queries(query_u8, index, query_mode):
    q, squeeze = _as_queries(query_u8, index.device)
    if q.shape[1] != index.dim:
        raise ValueError(f"query width {q.shape[1]} != index dim {index.dim}")
    return Int4Queries.from_u8(q, query_mode), squeeze


def fused_threshold4_scan_topk(
    query_u8,
    index,
    row_meta: torch.Tensor,
    smp,
    k: int = 100,
    max_distance: float = 1e3,
    target_count: Optional[int] = None,
    cap: Optional[int] = None,
    query_mode: str = "asym",
    epilogue: str = "dist",
):
    """Batched guaranteed-verifiable int4 threshold scan over a
    ``PackedSemantic4Index`` — the port of
    ``int4.py:pallas_threshold4_scan_topk``: K4a + K1c at every batch size,
    with the cosine scan's θ estimate (over the packed ``smp``) and proof.
    ``row_meta`` is ``build_semantic4_meta``.  ``query_mode="asym"`` (u8
    queries, kind "cosine4a") or ``"sym"`` (4-bit queries, kind
    "cosine4"); ``epilogue="cos"`` selects on the cos key (K4d + K1e).
    Returns (dist [Q,k], idx [Q,k], exact [Q]); repair the unproven
    queries with :func:`fused_cosine4_scan_topk`."""
    qk, squeeze = _int4_queries(query_u8, index, query_mode)
    out = _threshold_scan(
        qk, index.data, row_meta, smp, k, max_distance, target_count, cap, epilogue
    )
    return _squeezed(out, squeeze)


def fused_cosine4_scan_topk(
    query_u8,
    index,
    row_meta: torch.Tensor,
    k: int = 100,
    max_distance: float = 1e3,
    query_mode: str = "asym",
):
    """Exact int4 top-k of ``WHERE dist < max_distance`` (K4b + K1c) — the
    int4 auto path's repair and small-index scan, equal to
    ``ops.int4.cosine4a_scan_topk`` (asym) / ``cosine4_scan_topk`` (sym)."""
    qk, squeeze = _int4_queries(query_u8, index, query_mode)
    out = _exact_scan(qk, qk.q_codes.shape[0], index.data, row_meta, k, max_distance)
    return _squeezed(out, squeeze)


def _hamming_queries(query_u8, index, byte_limit, wrap_u8):
    q, squeeze = _as_queries(query_u8, index.device)
    if q.shape[1] != index.dim:
        raise ValueError(f"query width {q.shape[1]} != store width {index.dim}")
    limit = index.dim if byte_limit is None else int(byte_limit)
    return HammingQueries(q.contiguous(), limit, bool(wrap_u8)), squeeze


def fused_hamming_threshold_scan_topk(
    query_u8,
    index: PackedHammingIndex,
    meta: torch.Tensor,
    smp,
    k: int = 100,
    max_distance: float = 1e3,
    wrap_u8: bool = False,
    byte_limit: Optional[int] = None,
    target_count: Optional[int] = None,
    cap: Optional[int] = None,
):
    """Batched guaranteed-verifiable Hamming threshold scan over the packed
    u8 rows — the port of ``pallas_hamming_threshold_scan_topk`` (buffer)
    and ``_v2`` (carry): K2a + K1c at every batch size, with the cosine
    scan's θ estimate and proof.  ``meta`` is :func:`build_hamming_meta`
    (validity AND an optional group mask) and ``smp`` its strided sample.
    Returns (dist [Q,k], idx [Q,k], exact [Q])."""
    qk, squeeze = _hamming_queries(query_u8, index, byte_limit, wrap_u8)
    out = _threshold_scan(qk, index.data, meta, smp, k, max_distance, target_count, cap)
    return _squeezed(out, squeeze)


def fused_hamming_scan_topk(
    query_u8,
    index: PackedHammingIndex,
    meta: torch.Tensor,
    k: int = 100,
    max_distance: float = 1e3,
    wrap_u8: bool = False,
    byte_limit: Optional[int] = None,
):
    """Exact Hamming top-k of ``WHERE dist < max_distance`` (K2b + K1c):
    the Hamming repair, and the per-group scan of the mixed-width phash
    search and of the duplicate finder (``byte_limit`` + group ``meta``)."""
    qk, squeeze = _hamming_queries(query_u8, index, byte_limit, wrap_u8)
    out = _exact_scan(qk, qk.q.shape[0], index.data, meta, k, max_distance)
    return _squeezed(out, squeeze)
