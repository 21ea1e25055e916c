"""Fused threshold scans with guaranteed-exact top-k — the counterpart of
``pixelbox_tpu/ops/pallas_scan.py``.

Hand-written Hopper kernels (``csrc/fused_scan.cu``, and the tensor-core
collects in ``csrc/tc_scan.cu``) replace the JAX package's one Pallas TPU
kernel family (``pallas_scan.py:_threshold_kernel``; kinds "cosine",
"cosine4a", "cosine4" and "hamming", selects "carry" and "buffer"):

- **K1a** :func:`cosine_threshold_collect` — exact int8 dot + spec-v2
  epilogue + strict ``dist < θ_q`` filter; passing rows are appended to a
  per-query ``[Q, cap]`` buffer with an exact atomic count.  On the
  tensor cores (int8 ``wgmma``) at the rows of :data:`TC_COSINE_DIMS`
  bytes, on the first port's ``__dp4a`` kernel at other widths.
- **K1b** :func:`cosine_chunk_topk` — the same dot and epilogue with
  θ = max_distance: per row chunk, its first k by (dist, id).  On the
  tensor cores at :data:`TC_COSINE_DIMS` (the select design below), on
  the first port's ``__dp4a`` kernel at other widths
  (:func:`cosine_chunk_topk_dp4a`, which sorts every 1,024-row chunk).
- **K1c** :func:`lex_topk` through :func:`lex_topk_select` — the first k
  of each query's candidates by (dist, id) in one launch for up to
  :data:`SELECT_SLOTS` of them (a longer row: its slices' top-k, then a
  second launch): only the filled slots are read, a radix select finds
  the k-th key in shared memory and the k at or below it are sorted.  It
  finishes K1a's buffer and K1b's partials, and the id as the second key
  makes both independent of atomic order.  A k past :data:`MAX_K` is
  selected in rounds, each launch taking only the keys above the last
  one the round before took.  The first port's segmented
  bitonic sort, :func:`lex_topk_segments` (re-launched until one segment
  was left, :func:`lex_topk_segments_chain`), stays as its timing
  reference.
- **K2a** :func:`hamming_threshold_collect` and **K2b**
  :func:`hamming_chunk_topk` — K1a and K1b for the Hamming kind: the
  differing bits over the first ``byte_limit`` bytes of the packed u8
  phash rows, the optional u8 wrap of the reference (engine.rs:603), one
  f32 multiply by ``f32(1 / (8 * byte_limit))``.  Both multiply the ±1
  form of the bits on the tensor cores at :data:`TC_HAMMING_BYTES`-byte
  hashes (the first port's ``__popc`` kernels at other widths).  K1c
  finishes both.
- **K4a** :func:`cosine4_threshold_collect` and **K4b**
  :func:`cosine4_chunk_topk` — K1a and K1b over the packed int4 rows
  (``ops/int4.py``: two 4-bit codes a byte, column-blocked), unpacked in
  registers (mask, shift + mask); the affine fix of the asymmetric (u8
  query, kind "cosine4a") or the symmetric (4-bit query, kind "cosine4")
  metric, then K1a's epilogue.  Both run on the tensor cores at
  :data:`TC_COSINE4_DIMS` (the rows unpacked into ``wgmma``'s A
  fragment), on the first port's ``__dp4a`` kernels at other widths.  K1c
  finishes both.
- The tensor-core K1b, K2b and K4b (``csrc/tc_scan.cu``
  ``tc_chunk_topk_kernel``) select instead of sorting: per query a shared buffer of the keys below
  the k-th so far, a cheap filter on the integer product before the exact
  distance, and a radix select of the k-th (``csrc/select_device.cuh``)
  when the buffer fills; their chunk (:func:`tc_chunk_rows`, from
  :data:`TC_CHUNK_ROWS`) grows until K1c takes the partials in one launch,
  which list a chunk's first k in row order.
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

- θ estimate (:func:`sample_theta`, was ``_pallas_sample_theta``): at the
  tensor-core widths the θ kernel (``csrc/tc_theta.cu``, two launches on
  int8 ``wgmma``: θ0 over a 1/16 mini-sample, then the sample's top-j
  under θ0); at other widths the chunk top-k + K1c over the mini-sample,
  then K1a/K4a/K2a + K1c over the sample;
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
  mixed-width phash and duplicate scans.  The chunk kernels keep a
  chunk's first :data:`MAX_K`, so a larger k takes K1a/K4a/K2a with θ =
  max_distance and a buffer of every row, then K1c's rounds.

Dispatch is by device and nothing else: a CUDA tensor goes to the kernel
(or the wrapper raises), a CPU tensor goes to the kernel's plain PyTorch
version in this module.  The plain versions compute the dot exactly (a
float64 matmul of int8 codes is exact for any realistic D) and select
with a (dist, id) sort; the CPU tests hold them bit-identical to the JAX
package, and ``chip_smoke.py`` holds the kernels bit-identical to them.

What bounds the kernels on the card: the tensor-core K1a, K4a and K2a
read the rows once per 256 queries and multiply on the tensor cores;
past the product, a branch-free filter of every (query, row) pair on the
accumulators (a few f32 / integer operations a pair) is their cost, and
only its survivors take the exact distance (ops bound at Q >= 256, HBM
read bound below).  The tensor-core K1b, K2b and K4b multiply the same
way; past the product their cost is the selection (the buffers' radix
selects and the exact distances of the rows that enter before the k-th
tightens), not the chunk's length.  K1c is bound by its launch and the
filled entries' bytes.  The first port's K1b / K2b / K4b, kept as timing
references and for other widths, read the index once per 4 queries and
bitonic-sort every slot of each :data:`CHUNK_ROWS`-row chunk — bound by
that sort; K1d/K4d are the ``__dp4a`` K4a's loop without the divide,
clamp and pin; K1e is bound by its gathered rows.  The design keeps
distances out of device memory (only θ-passing rows or each chunk's
top-k are written); fusing the collects with K1c is later work
(ROADMAP.md).
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
from pixelbox_tpu_torch.utils.timing import bump, span

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("fused_scan.cu",)
_TC_SOURCES = ("tc_scan.cu",)
_THETA_SOURCES = ("tc_theta.cu",)
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-gencode", "arch=compute_90a,code=sm_90a", "-fmad=false",
    "-Xptxas", "-v",
)

#: Queries staged per block of the ``__dp4a`` / ``__popc`` collect kernels
#: (K1d, K4d, and K1a / K4a / K2a at the widths the tensor-core kernels do
#: not take); they stage ``_COLLECT_Q * D`` bytes of shared memory (must
#: stay under the 48 KB static-launch limit).
_COLLECT_Q = 32
#: Row widths (bytes) the tensor-core K1a takes (TMA-fed K-major tiles).
TC_COSINE_DIMS = (32, 64, 128)
#: Widths (dims; D/2 packed bytes a row) the tensor-core K4a takes.
TC_COSINE4_DIMS = (128,)
#: Hash width (bytes) the tensor-core K2a takes: the published 16x16 phash.
TC_HAMMING_BYTES = 32
#: Rows per chunk of the first port's K1b / K2b / K4b (power of two); the
#: chunk keeps its first k.
CHUNK_ROWS = 1024
#: The least chunk of the tensor-core K1b / K2b / K4b (rows, a multiple of the
#: 64-row tile); :func:`tc_chunk_rows` doubles it until K1c takes the
#: partials in one launch.
TC_CHUNK_ROWS = 8192
#: Candidates per segment of the first port's K1c (power of two, >= 2k
#: so each pass of its chain shrinks).
SEGMENT = 2048
#: Largest k the kernels take (K1b keeps k of CHUNK_ROWS, K1c k of SEGMENT/2).
MAX_K = 1024
#: Entries of a query's row one block of K1c's select kernel takes (its
#: keys in shared memory); :func:`lex_topk` cuts a longer row into slices.
SELECT_SLOTS = 16384
#: The narrowest slice :func:`lex_topk` cuts a long row into.
_MIN_SLICE = 4096
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
_TC_KERNELS: Optional[_Kernels] = None
_THETA_KERNELS: Optional[_Kernels] = None
_KERNELS_LOCK = threading.Lock()
_TC_KERNELS_LOCK = threading.Lock()
_THETA_KERNELS_LOCK = threading.Lock()


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


def load_tc_kernels() -> _Kernels:
    """Compile ``csrc/tc_scan.cu`` (the tensor-core K1a, K4a, K2a, K1b, K2b
    and K4b) for sm_90a into its own library, beside :func:`load_kernels`'s,
    so the two build in parallel.  Raises on any failure."""
    global _TC_KERNELS
    with _TC_KERNELS_LOCK:
        if _TC_KERNELS is None:
            kern = build_library(_TC_SOURCES, "libpixelbox_tc_scan")
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            kern.lib.px_tc_cosine_collect.restype = ci
            kern.lib.px_tc_cosine_collect.argtypes = [vp] * 7 + [ci] * 5 + [cf] * 3 + [vp] * 4
            kern.lib.px_tc_hamming_collect.restype = ci
            kern.lib.px_tc_hamming_collect.argtypes = [vp] * 4 + [ci] * 5 + [cf, ci] + [vp] * 4
            kern.lib.px_tc_chunk_plan.restype = ci
            kern.lib.px_tc_chunk_plan.argtypes = [ci] * 6 + [ctypes.POINTER(ci)]
            kern.lib.px_tc_hamming_chunk_topk.restype = ci
            kern.lib.px_tc_hamming_chunk_topk.argtypes = (
                [vp, cf, vp, vp] + [ci] * 5 + [cf] + [ci] * 5 + [vp] * 6
            )
            kern.lib.px_tc_cosine_chunk_topk.restype = ci
            kern.lib.px_tc_cosine_chunk_topk.argtypes = (
                [vp] * 4 + [cf, vp, vp] + [ci] * 9 + [vp] * 3 + [cf] * 3 + [vp] * 3
            )
            _TC_KERNELS = kern
        return _TC_KERNELS


def load_theta_kernels() -> _Kernels:
    """Compile ``csrc/tc_theta.cu`` (the θ stage's two launches) for
    sm_90a into its own library, so that it builds in parallel with the
    others.  Raises on any failure."""
    global _THETA_KERNELS
    with _THETA_KERNELS_LOCK:
        if _THETA_KERNELS is None:
            kern = build_library(_THETA_SOURCES, "libpixelbox_tc_theta")
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            kern.lib.px_tc_sample_theta.restype = ci
            kern.lib.px_tc_sample_theta.argtypes = (
                [vp] * 6 + [ci] * 9 + [cf] + [ci] * 2 + [cf] * 4 + [ci] * 6 + [vp] * 6
            )
            _THETA_KERNELS = kern
        return _THETA_KERNELS


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
    lib.px_lex_topk.restype = ci
    lib.px_lex_topk.argtypes = [vp] * 4 + [ci] * 5 + [vp] * 3
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
    "cosine_threshold_collect_dp4a": 0,
    "cosine_chunk_topk": 0,
    "cosine_chunk_topk_dp4a": 0,
    "lex_topk_select": 0,
    "lex_topk_segments": 0,
    "hamming_threshold_collect": 0,
    "hamming_threshold_collect_popc": 0,
    "hamming_chunk_topk": 0,
    "hamming_chunk_topk_popc": 0,
    "cosine4_threshold_collect": 0,
    "cosine4_threshold_collect_dp4a": 0,
    "cosine4_chunk_topk": 0,
    "cosine4_chunk_topk_dp4a": 0,
    "cosine_coskey_collect": 0,
    "cosine4_coskey_collect": 0,
    "coskey_rescore": 0,
    "sample_theta": 0,
    "ivf_probe_topk": 0,
    "ivf_probe_invert": 0,
    "ivf_probe_collect_dp4a": 0,
    "ivf_gathered_collect": 0,
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


#: The kinds (the JAX package's names) and their codes in the kernels' C
#: interface (``kU8``, ``kInt4Asym``, ``kInt4Sym``; ``kHamming`` only the
#: tensor-core chunk kernel's).
_KIND_CODES = {"cosine": 0, "cosine4a": 1, "cosine4": 2, "hamming": 3}
_COSINE_KINDS = ("cosine", "cosine4a", "cosine4")


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
    semantics) for the θ stage and the main pass.  On the card, rows of
    :data:`TC_COSINE_DIMS` bytes (the main path's 128, and 32 and 64) go to
    the tensor-core K1a (``csrc/tc_scan.cu``: int8 ``wgmma`` over TMA-fed
    row tiles, a cos-key prefilter on the accumulators, the spec distance
    and strict θ for the key's survivors only); other widths (e.g. 8 or
    36) go to the ``__dp4a`` kernel (:func:`cosine_threshold_collect_dp4a`,
    its own launch count).  Either writes only the θ-passing rows (~320
    per query at the default target), so distances never reach device
    memory.
    """
    dev, qn, n, d = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta)
    _require(theta, "theta", torch.float32, (qn,), dev)
    if dev.type != "cuda":
        return cosine_threshold_collect_plain(
            q_codes, q_sum, q_mag2, qr, theta, data, meta, cap
        )
    if d not in TC_COSINE_DIMS:
        return cosine_threshold_collect_dp4a(q_codes, q_sum, q_mag2, qr, theta, data, meta, cap)
    return _tc_collect(
        "cosine_threshold_collect", "cosine", q_codes, q_sum, q_mag2, qr, theta, data, meta, cap
    )


def _tc_collect(name, kind, q_codes, q_sum, q_mag2, qr, theta, data, meta, cap):
    """Launch the tensor-core K1a (kind "cosine") or K4a ("cosine4a",
    "cosine4") through ``px_tc_cosine_collect``.  Returns (count, cand_d
    [Q, cap] f32, cand_i [Q, cap] i32)."""
    dev = data.device
    qn, d = q_codes.shape
    if q_codes.data_ptr() % 16:  # a TMA source: copy an unaligned view
        q_codes = q_codes.clone()
    kern = load_tc_kernels()
    count = torch.zeros(qn, dtype=torch.int32, device=dev)
    cand_d = torch.empty((qn, cap), dtype=torch.float32, device=dev)
    cand_i = torch.empty((qn, cap), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_tc_cosine_collect(
            _ptr(q_codes), _ptr(q_sum), _ptr(q_mag2), _ptr(qr), _ptr(theta),
            _ptr(data), _ptr(meta), qn, data.shape[0], d, _KIND_CODES[kind], cap,
            _KEY_SCALE, DIST_SATURATION, KEY_LOOSE,
            _ptr(count), _ptr(cand_d), _ptr(cand_i), _stream(dev),
        )
    _check(rc, name)
    LAUNCHES[name] += 1
    return count, cand_d, cand_i


def cosine_threshold_collect_dp4a(q_codes, q_sum, q_mag2, qr, theta, data, meta, cap: int):
    """K1a on the ``__dp4a`` kernel of the first port (``fused_scan.cu``
    ``threshold_collect_kernel``: one thread a row against 32 staged
    queries), for CUDA tensors only: :func:`cosine_threshold_collect`'s
    path for widths outside :data:`TC_COSINE_DIMS`, and the timing
    reference of the tensor-core kernel.  Same contract and outputs."""
    return _collect_on_card(
        "cosine_threshold_collect_dp4a", "px_threshold_collect",
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
    """K1b: per row chunk, the exact top-k by (dist, id) of {valid rows
    with dist < max_distance}: ([Q, n_chunks, k] f32, [Q, n_chunks, k]
    i32), missing entries +inf / -1 last.  At :data:`TC_COSINE_DIMS` the
    chunk is :func:`tc_chunk_rows` rows and a chunk's k are listed in row
    order; at other widths :data:`CHUNK_ROWS` rows, by (dist, id)
    (:func:`cosine_chunk_rows`).

    Replaces ``pallas_scan.py:_threshold_kernel`` as launched by
    ``pallas_cosine_scan_topk`` (θ = max_distance).  On the card, rows of
    :data:`TC_COSINE_DIMS` bytes (the main path's 128, and 32 and 64) go
    to the tensor-core K1b (``csrc/tc_scan.cu`` ``tc_chunk_topk_kernel``:
    K1a's product on int8 ``wgmma``, then per query a shared buffer of the
    keys below the k-th so far, filtered by K1a's key bound and pruned by
    a radix select; its work past the product follows the rows under the
    k-th and k); other widths to the first port's ``__dp4a`` kernel
    (:func:`cosine_chunk_topk_dp4a`, its own launch count).
    """
    dev, qn, n, d = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta)
    md = float(np.float32(max_distance))
    if dev.type != "cuda":
        return cosine_chunk_topk_plain(q_codes, q_sum, q_mag2, qr, md, data, meta, k)
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the scan kernels' limit of {MAX_K}")
    if d not in TC_COSINE_DIMS:
        return cosine_chunk_topk_dp4a(q_codes, q_sum, q_mag2, qr, md, data, meta, k)
    return _tc_cosine_chunk("cosine_chunk_topk", "cosine", q_codes, q_sum, q_mag2, qr, md, data, meta, k)


def _tc_cosine_chunk(name, kind, q_codes, q_sum, q_mag2, qr, md, data, meta, k):
    """Launch the tensor-core K1b (kind "cosine") or K4b ("cosine4a",
    "cosine4") through ``px_tc_cosine_chunk_topk``: ([Q, n_chunks, k]
    f32, [Q, n_chunks, k] i32) at :func:`tc_chunk_rows`."""
    dev = data.device
    qn, d = q_codes.shape
    n = data.shape[0]
    if q_codes.data_ptr() % 16:  # a TMA source: copy an unaligned view
        q_codes = q_codes.clone()
    with torch.cuda.device(dev):
        kern, plan, (out_d, out_i, _parts) = _tc_chunk_launch(kind, qn, n, d, k, dev)
        rc = kern.lib.px_tc_cosine_chunk_topk(
            _ptr(q_codes), _ptr(q_sum), _ptr(q_mag2), _ptr(qr), md,
            _ptr(data), _ptr(meta), qn, n, d, _KIND_CODES[kind], *plan,
            _KEY_SCALE, DIST_SATURATION, KEY_LOOSE,
            _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, name)
    LAUNCHES[name] += 1
    return out_d, out_i


def cosine_chunk_topk_dp4a(q_codes, q_sum, q_mag2, qr, max_distance, data, meta, k: int):
    """K1b on the first port's ``__dp4a`` kernel (``fused_scan.cu``
    ``chunk_topk_kernel``: 4 queries a block, a bitonic sort of every slot
    of each :data:`CHUNK_ROWS`-row chunk; the index read once per 4
    queries), for CUDA tensors only: :func:`cosine_chunk_topk`'s path for
    widths outside :data:`TC_COSINE_DIMS`, and the timing reference of the
    tensor-core kernel.  Same contract at a chunk of :data:`CHUNK_ROWS`."""
    dev, qn, n, d = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta)
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the scan kernels' limit of {MAX_K}")
    kern = load_kernels()
    n_chunks = -(-n // CHUNK_ROWS)
    out_d = torch.empty((qn, n_chunks, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_chunks, k), dtype=torch.int32, device=dev)
    q_mag2f = q_mag2.to(torch.float32)
    with torch.cuda.device(dev):
        rc = kern.lib.px_chunk_topk(
            _ptr(q_codes), _ptr(q_sum), _ptr(q_mag2f), _ptr(qr), float(np.float32(max_distance)),
            _ptr(data), _ptr(meta), qn, n, d, CHUNK_ROWS, k, n_chunks,
            _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "cosine_chunk_topk_dp4a")
    LAUNCHES["cosine_chunk_topk_dp4a"] += 1
    return out_d, out_i


def cosine_chunk_rows(d: int, n: int, k: int) -> int:
    """The chunk of the K1b kernel that u8 rows of d bytes take:
    :func:`tc_chunk_rows` on the tensor cores, :data:`CHUNK_ROWS` on the
    first port's kernel."""
    return tc_chunk_rows(n, k) if d in TC_COSINE_DIMS else CHUNK_ROWS


def cosine_chunk_topk_plain(q_codes, q_sum, q_mag2, qr, max_distance, data, meta, k):
    """Plain PyTorch version of K1b, as the kernel its width takes lays it
    out: at :data:`TC_COSINE_DIMS` a chunk of :func:`tc_chunk_rows`, its
    first k listed in row order; at other widths the first port's chunk of
    :data:`CHUNK_ROWS`, by (dist, id)."""
    n, d = data.shape
    return _chunk_topk_plain(
        lambda lo, hi: _tile_dist(q_codes, q_sum, q_mag2, qr, data[lo:hi], meta[:, lo:hi]),
        q_codes.shape[0], n, max_distance, k, data.device, cosine_chunk_rows(d, n, k),
        d in TC_COSINE_DIMS,
    )


def _tc_chunk_launch(kind: str, qn: int, n: int, d: int, k: int, dev):
    """Plan of a tensor-core K1b / K2b / K4b launch over n rows of width d
    (u8 bytes, int4 dims or hash bytes): (rows a chunk,
    its args for the C entry — query tile, splits and the parts' buffers —
    and the [Q, n_chunks, k] outputs).  A chunk the plan splits over
    several blocks (few queries: one block a chunk would leave SMs idle)
    needs each block's k smallest and counts, and zeroed tickets that elect
    the block merging them."""
    kern = load_tc_kernels()
    rows = tc_chunk_rows(n, k)
    plan = (ctypes.c_int * 2)()
    _check(kern.lib.px_tc_chunk_plan(_KIND_CODES[kind], qn, n, d, rows, k, plan), f"{kind} chunk plan")
    nq, splits = plan[0], plan[1]
    n_chunks = -(-n // rows)
    parts = []
    if splits > 1:
        parts = [
            torch.empty((qn, n_chunks, splits, k), dtype=torch.int64, device=dev),
            torch.empty((qn, n_chunks, splits), dtype=torch.int32, device=dev),
            torch.zeros((-(-qn // nq), n_chunks), dtype=torch.int32, device=dev),
        ]
    ptrs = [_ptr(t) for t in parts] or [ctypes.c_void_p(None)] * 3
    out_d = torch.empty((qn, n_chunks, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_chunks, k), dtype=torch.int32, device=dev)
    return kern, (rows, k, n_chunks, nq, splits, *ptrs), (out_d, out_i, parts)


def tc_chunk_rows(n: int, k: int) -> int:
    """Rows per chunk of the tensor-core K1b / K2b / K4b over n rows: the least
    power of two from :data:`TC_CHUNK_ROWS` at which K1c takes the
    ``[Q, ceil(n / rows), k]`` partials in one launch (``ceil(n / rows) · k
    <= SELECT_SLOTS``), or one chunk of all n rows."""
    rows = TC_CHUNK_ROWS
    while rows < n and -(-n // rows) * k > SELECT_SLOTS:
        rows *= 2
    return rows


def _chunk_topk_plain(tile, qn, n, max_distance, k, dev, chunk_rows, row_order):
    """The per-chunk top-k shared by the plain K1b and K4b: ``tile(lo, hi)``
    gives a row block's [Q, B] distances and [1, B] validity; a chunk's
    first k by (dist, id) listed by (dist, id), or with ``row_order`` by
    row id (the tensor-core kernels' layout)."""
    n_chunks = -(-n // chunk_rows)
    kk = min(k, chunk_rows)
    out_d = torch.full((qn, n_chunks, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((qn, n_chunks, k), -1, dtype=torch.int32, device=dev)
    md = _f32(max_distance, out_d)
    block = max(chunk_rows, _PLAIN_BLOCK // chunk_rows * chunk_rows)
    for start in range(0, n, block):
        end = min(n, start + block)
        dist, valid = tile(start, end)
        dist = torch.where(valid & (dist < md), dist, torch.full_like(dist, float("inf")))
        nc = -(-(end - start) // chunk_rows)
        pad = nc * chunk_rows - (end - start)
        if pad:
            dist = torch.cat([dist, dist.new_full((qn, pad), float("inf"))], 1)
        # Positions ascend with row id inside a chunk: a stable sort by
        # dist is the (dist, id) order.
        d_s, order = torch.sort(dist.reshape(qn, nc, chunk_rows), dim=-1, stable=True)
        d_s, order = d_s[..., :kk], order[..., :kk]
        if row_order:
            by_row = torch.argsort(torch.where(torch.isfinite(d_s), order, chunk_rows), dim=-1)
            d_s, order = torch.gather(d_s, -1, by_row), torch.gather(order, -1, by_row)
        rows = order + (start + torch.arange(nc, device=dev) * chunk_rows)[None, :, None]
        c0 = start // chunk_rows
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
    pass).  On the card, widths of :data:`TC_COSINE4_DIMS` (the main
    path's 128) go to the tensor-core K4a (``csrc/tc_scan.cu``: the packed
    rows by TMA, unpacked in registers into ``wgmma``'s A fragment, K1a's
    key prefilter on the exact centered dot, the spec distance and strict
    θ for its survivors); other widths to the ``__dp4a`` kernel
    (:func:`cosine4_threshold_collect_dp4a`, its own launch count).
    """
    dev, qn, _, d = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta, packed=True)
    _require(theta, "theta", torch.float32, (qn,), dev)
    if dev.type != "cuda":
        return cosine4_threshold_collect_plain(
            q_codes, q_sum, q_mag2, qr, theta, data, meta, sym, cap
        )
    if d not in TC_COSINE4_DIMS:
        return cosine4_threshold_collect_dp4a(
            q_codes, q_sum, q_mag2, qr, theta, data, meta, sym, cap
        )
    return _tc_collect(
        "cosine4_threshold_collect", "cosine4" if sym else "cosine4a",
        q_codes, q_sum, q_mag2, qr, theta, data, meta, cap,
    )


def cosine4_threshold_collect_dp4a(q_codes, q_sum, q_mag2, qr, theta, data, meta, sym: bool, cap: int):
    """K4a on the ``__dp4a`` kernel of the first port (``fused_scan.cu``
    ``threshold_collect_kernel``: one thread a packed row against 32
    staged queries, each word unpacked into two ``__dp4a`` operands), for
    CUDA tensors only: :func:`cosine4_threshold_collect`'s path for widths
    outside :data:`TC_COSINE4_DIMS`, and the timing reference of the
    tensor-core kernel.  Same contract and outputs."""
    return _collect_on_card(
        "cosine4_threshold_collect_dp4a", "px_cosine4_collect",
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
    :func:`cosine4_threshold_collect`): per row chunk, the exact top-k by
    (dist, id) of {valid rows with dist < max_distance}; ([Q, n_chunks, k]
    f32, [Q, n_chunks, k] i32), missing entries +inf / -1 last.  At
    :data:`TC_COSINE4_DIMS` the chunk is :func:`tc_chunk_rows` rows and a
    chunk's k are listed in row order; at other widths :data:`CHUNK_ROWS`
    rows, by (dist, id) (:func:`int4_chunk_rows`).

    The exact int4 scan behind the repair, the small-index gate and the
    duplicate scans, where the JAX package ran its XLA
    ``cosine4a_scan_topk`` / ``cosine4_scan_topk`` (``int4.py:265``,
    ``:317``).  On the card, widths of :data:`TC_COSINE4_DIMS` (the main
    path's 128) go to the tensor-core K4b (``csrc/tc_scan.cu``
    ``tc_chunk_topk_kernel``: K4a's product on int8 ``wgmma``, then per
    query a shared buffer of the keys below the k-th so far, pruned by a
    radix select; its work past the product follows the rows under the
    k-th and k); other widths to the first port's ``__dp4a`` kernel
    (:func:`cosine4_chunk_topk_dp4a`, its own launch count).
    """
    dev, qn, n, d = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta, packed=True)
    md = float(np.float32(max_distance))
    if dev.type != "cuda":
        return cosine4_chunk_topk_plain(q_codes, q_sum, q_mag2, qr, md, data, meta, sym, k)
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the scan kernels' limit of {MAX_K}")
    if d not in TC_COSINE4_DIMS:
        return cosine4_chunk_topk_dp4a(q_codes, q_sum, q_mag2, qr, md, data, meta, sym, k)
    return _tc_cosine_chunk(
        "cosine4_chunk_topk", "cosine4" if sym else "cosine4a",
        q_codes, q_sum, q_mag2, qr, md, data, meta, k,
    )


def cosine4_chunk_topk_dp4a(q_codes, q_sum, q_mag2, qr, max_distance, data, meta, sym: bool, k: int):
    """K4b on the first port's ``__dp4a`` kernel (``fused_scan.cu``
    ``chunk_topk_kernel``: 4 queries a block, a bitonic sort of every slot
    of each :data:`CHUNK_ROWS`-row chunk), for CUDA tensors only:
    :func:`cosine4_chunk_topk`'s path for widths outside
    :data:`TC_COSINE4_DIMS`, and the timing reference of the tensor-core
    kernel.  Same contract at a chunk of :data:`CHUNK_ROWS`."""
    dev, qn, n, d = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta, packed=True)
    kern = load_kernels()
    n_chunks = -(-n // CHUNK_ROWS)
    out_d = torch.empty((qn, n_chunks, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_chunks, k), dtype=torch.int32, device=dev)
    q_mag2f = q_mag2.to(torch.float32)
    with torch.cuda.device(dev):
        rc = kern.lib.px_cosine4_chunk_topk(
            _ptr(q_codes), _ptr(q_sum), _ptr(q_mag2f), _ptr(qr), float(np.float32(max_distance)),
            _ptr(data), _ptr(meta), qn, n, d, int(sym), CHUNK_ROWS, k, n_chunks,
            _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "cosine4_chunk_topk_dp4a")
    LAUNCHES["cosine4_chunk_topk_dp4a"] += 1
    return out_d, out_i


def int4_chunk_rows(d: int, n: int, k: int) -> int:
    """The chunk of the K4b kernel that int4 rows of d dims take:
    :func:`tc_chunk_rows` on the tensor cores, :data:`CHUNK_ROWS` on the
    first port's kernel."""
    return tc_chunk_rows(n, k) if d in TC_COSINE4_DIMS else CHUNK_ROWS


def cosine4_chunk_topk_plain(q_codes, q_sum, q_mag2, qr, max_distance, data, meta, sym, k,
                             chunk_rows: Optional[int] = None):
    """Plain PyTorch version of K4b, as the kernel its width takes lays it
    out: at :data:`TC_COSINE4_DIMS` a chunk of :func:`tc_chunk_rows`, its
    first k listed in row order; at other widths the first port's chunk of
    :data:`CHUNK_ROWS`, by (dist, id).  ``chunk_rows`` overrides the
    length."""
    n, d = data.shape[0], q_codes.shape[1]
    if chunk_rows is None:
        chunk_rows = int4_chunk_rows(d, n, k)
    return _chunk_topk_plain(
        lambda lo, hi: _tile_dist4(q_codes, q_sum, q_mag2, qr, data[lo:hi], meta[:, lo:hi], sym),
        q_codes.shape[0], n, max_distance, k, data.device, chunk_rows, d in TC_COSINE4_DIMS,
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
#: The key threshold's margin factor ``f32(1 − 1e-5)``.
_KEY_SCALE = float(np.float32(1 - 1e-5))


def cos_key_threshold(theta: torch.Tensor) -> torch.Tensor:
    """[Q] f32 key threshold of the strict distance thresholds ``theta``
    [Q] f32, op for op ``pallas_scan.py:_cos_key_threshold``: ``c =
    fl(fl(1 / fl(1 + θ)) · f32(1 − 1e-5))``, key θ = −c, +inf where θ ≥
    :data:`DIST_SATURATION`.  Computed with f32 tensor ops (IEEE divide)
    on the thresholds' own device, for the kernels and their plain
    versions alike."""
    one = _f32(1.0, theta)
    c = (one / (one + theta)) * _f32(_KEY_SCALE, theta)
    return torch.where(
        theta >= _f32(DIST_SATURATION, theta), torch.full_like(theta, float("inf")), -c
    ).contiguous()


#: The tensor-core K1a's loosening of its key bound, ``1 − 2^-16`` (passed
#: to the kernel): far more than the roundings between the bound and the
#: cos key.
KEY_LOOSE = float(np.float32(1.0 - 2.0**-16))


def key_bound(theta: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    """[Q] f32 bound of the tensor-core K1a's branch-free filter, op for op
    the kernel's ``key_bound`` (``csrc/tc_scan.cu``, once per query tile;
    IEEE divides in both): row r passes query q when
    ``fl(dot_c · rr) > u[q]``, with ``u = fl(fl(c · KEY_LOOSE) / qr)`` and
    ``c = −cos_key_threshold(θ)``; −inf (every valid row) where ``c <= 0``.
    The cos key ``fl(dot_c · fl(qr · rr)) > c`` implies the bound (a few
    roundings apart, far inside the 2^-16 loosening), and ``dist < θ``
    implies the key, so the filter keeps every θ-passing row; the kernel
    then applies the exact distance and the strict θ to the survivors."""
    c = -cos_key_threshold(theta)
    u = (c * _f32(KEY_LOOSE, c)) / qr
    return torch.where(c <= 0, torch.full_like(u, float("-inf")), u).contiguous()


#: ``kMagic2`` of ``csrc/tc_scan.cu``: 1.5·2^24, and its f32 bits.
_MAGIC2 = 1.5 * 2.0**24
_MAGIC2_BITS = 0x4BC00000


def tc_centered_f32(kind: str, dot8, q_sum, row_sum, d: int) -> torch.Tensor:
    """[Q, B] f32 centered dot of the tensor-core collects' phase 1, op for
    op the kernel's construction (``csrc/tc_scan.cu``) from the int8 code
    dot ``dot8`` [Q, B] int32, ``q_sum`` [Q] and ``row_sum`` [B]: an int x
    added to the bits of 1.5·2^24 is the float 1.5·2^24 + 2x, then one f32
    add.  Equal to ``f32(dot_c)`` (:func:`_centered`) for D <= 128 at every
    code — what the CPU tests hold."""
    qs = q_sum.to(torch.int32)[:, None]
    rs = row_sum.to(torch.int32)[None, :]
    magic = torch.tensor(_MAGIC2, dtype=torch.float32)

    def bits_f32(x):
        return x.to(torch.int32).contiguous().view(torch.float32)

    if kind == "cosine":
        z = (2 * qs + d).to(torch.float32) - magic
        return bits_f32(2 * dot8 + (rs + _MAGIC2_BITS)) + z
    if kind == "cosine4a":
        z = (34 * rs).to(torch.float32) - magic
        return bits_f32(34 * dot8 + (_MAGIC2_BITS - 255 * qs - 255 * (d // 2))) + z
    return bits_f32(578 * dot8 + (_MAGIC2_BITS - 4335 * qs + 65025 * (d // 2)) + (-4335 * rs)) - magic


def hamming_pass_count(theta: torch.Tensor, byte_limit: int, wrap_u8: bool) -> torch.Tensor:
    """[Q] int32 T of the tensor-core K2a's integer filter, the kernel's
    per-query threshold (there by a binary search on the same
    ``fl(d · scale) < θ``): the number of bit counts d in ``[0, dmax]`` with
    ``fl(d · scale) < θ`` (dmax = 8·byte_limit, or ≤ 255 under the wrap).
    The distance is monotone in d, so ``dist < θ`` ⟺ ``d < T``: unwrapped,
    ``dot_pm1 > 8·byte_limit − 2T`` on the ±1 product; wrapped, ``(d &
    255) < T``."""
    bits = 8 * byte_limit
    d = torch.arange((min(bits, 255) if wrap_u8 else bits) + 1, device=theta.device)
    dist = d.to(torch.float32) * _f32(hamming_scale(byte_limit), theta)
    return (dist[None, :] < theta[:, None]).sum(dim=1, dtype=torch.int32)


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
    if kind not in _COSINE_KINDS:
        raise ValueError(f"no cos key for kind {kind!r} (cosine kinds: {sorted(_COSINE_KINDS)})")
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
# K1c: the top-k by (dist, id)


def _keys(dist, idx, lens, floor=None):
    """(dist, id) → int64 keys (dist >= 0: its f32 bits order like the
    value); empty entries (non-finite, id < 0, at/after lens, or at or
    below ``floor``, see :func:`lex_topk_select`) → max."""
    valid = torch.isfinite(dist) & (idx >= 0)
    if lens is not None:
        pos = torch.arange(dist.shape[1], device=dist.device)
        valid &= pos[None, :] < lens[:, None]
    bits = dist.contiguous().view(torch.int32).to(torch.int64)
    key = (bits << 32) | idx.to(torch.int64)
    if floor is not None:
        valid &= (floor[:, None] >= 0) & (key > floor[:, None])
    return torch.where(valid, key, torch.full_like(key, torch.iinfo(torch.int64).max))


def _check_topk_args(dist, idx, lens, floor=None):
    dev = dist.device
    qn, m = dist.shape
    _require(dist, "dist", torch.float32, (qn, m), dev)
    _require(idx, "idx", torch.int32, (qn, m), dev)
    if lens is not None:
        _require(lens, "lens", torch.int32, (qn,), dev)
    if floor is not None:
        _require(floor, "floor", torch.int64, (qn,), dev)
    return dev, qn, m


def lex_topk(dist, idx, k: int, lens=None):
    """Exact top-k by (dist, id) of each query's candidates: ([Q, k] f32,
    [Q, k] i32), empty entries +inf / -1; ``lens[q]`` (optional) marks
    how many leading entries of query q's row are meaningful.

    K1c's select kernel (:func:`lex_topk_select`) in one launch for rows
    of up to :data:`SELECT_SLOTS` entries; a longer row (the exact scans'
    chunk partials) is first cut into slices whose top-k a second launch
    selects from (rows past ``SELECT_SLOTS² / k`` entries take a third).
    A k past :data:`MAX_K` is selected in rounds of at most ``MAX_K``:
    each round takes the first entries above the key of the last entry
    the round before took (:func:`floor_keys`).  The ids of a row are
    distinct, so the rounds laid end to end are the first k."""
    if k <= MAX_K:
        return _lex_topk_round(dist, idx, k, lens, None)
    outs_d, outs_i = [], []
    floor = None
    for r0 in range(0, k, MAX_K):
        d, i = _lex_topk_round(dist, idx, min(MAX_K, k - r0), lens, floor)
        outs_d.append(d)
        outs_i.append(i)
        floor = floor_keys(d[:, -1], i[:, -1])
    return torch.cat(outs_d, 1), torch.cat(outs_i, 1)


def _lex_topk_round(dist, idx, k: int, lens, floor):
    """One round of :func:`lex_topk` (k <= MAX_K), above ``floor`` if
    given (only the first launch reads it: its outputs are all above)."""
    qn, m = dist.shape
    above = {} if floor is None else {"floor": floor}
    while m > SELECT_SLOTS:
        d, i = lex_topk_select(dist, idx, k, lens, segment=_slice(m, k), **above)
        dist, idx, lens, above = d.reshape(qn, -1), i.reshape(qn, -1), None, {}
        m = dist.shape[1]
    d, i = lex_topk_select(dist, idx, k, lens, **above)
    return d[:, 0], i[:, 0]


def floor_keys(dist, idx) -> torch.Tensor:
    """[Q] int64 floor of the next selection round from the last entry a
    round took: its (dist, id) key, or -1 — nothing left above — where
    that entry was empty."""
    bits = dist.contiguous().view(torch.int32).to(torch.int64)
    key = (bits << 32) | idx.to(torch.int64)
    return torch.where(torch.isfinite(dist) & (idx >= 0), key, torch.full_like(key, -1)).contiguous()


def _slice(m: int, k: int) -> int:
    """The slice of a row of m > SELECT_SLOTS entries: the narrowest power
    of two from :data:`_MIN_SLICE` whose slices' top-k fit one block."""
    s = _MIN_SLICE
    while s < SELECT_SLOTS and -(-m // s) * k > SELECT_SLOTS:
        s *= 2
    return s


def lex_topk_select(dist, idx, k: int, lens=None, segment: Optional[int] = None, floor=None):
    """Per (query, segment of ``segment`` entries of its row; the whole
    row by default) the segment's first k by (dist, id): ([Q, n_seg, k]
    f32, [Q, n_seg, k] i32), empty entries +inf / -1; entries at or past
    ``lens[q]``, non-finite or with a negative id are empty, and so are,
    with ``floor`` (int64 [Q], :func:`floor_keys`), the entries whose
    (dist, id) key is not above ``floor[q]`` (all of them where it is -1).

    Replaces the selection half of ``pallas_scan.py:_threshold_kernel``
    (its sorted carry insertion) and the buffer wrapper's final top-k.  On
    the card one block a (query, segment) (``csrc/fused_scan.cu``
    ``lex_topk_select_kernel``): it reads only the positions below
    ``lens[q]`` and keeps the valid (dist, id) keys in shared memory,
    radix-selects the k-th (8-bit digits, MSB first, into the id bits on a
    tie plateau) and sorts the k at or below it — bound by the launch and
    the filled entries' bytes, not by the row's length."""
    dev, qn, m = _check_topk_args(dist, idx, lens, floor)
    seg = max(m, 1) if segment is None else int(segment)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the select kernel's 1..{MAX_K}")
    if not 1 <= seg <= SELECT_SLOTS:
        raise ValueError(f"segment {seg} outside the select kernel's 1..{SELECT_SLOTS}")
    if dev.type != "cuda":
        return lex_topk_select_plain(dist, idx, k, lens, seg, floor)
    kern = load_kernels()
    n_seg = max(1, -(-m // seg))
    out_d = torch.empty((qn, n_seg, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_seg, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_lex_topk(
            _ptr(dist), _ptr(idx),
            ctypes.c_void_p(None if lens is None else lens.data_ptr()),
            ctypes.c_void_p(None if floor is None else floor.data_ptr()),
            qn, m, seg, k, n_seg, _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "lex_topk_select")
    LAUNCHES["lex_topk_select"] += 1
    return out_d, out_i


def lex_topk_select_plain(dist, idx, k, lens=None, segment=None, floor=None):
    """Plain PyTorch version of K1c's select kernel: one ``torch.sort`` of
    each segment's int64 (dist, id) keys, the first k."""
    seg = max(dist.shape[1], 1) if segment is None else segment
    return lex_topk_segments_plain(dist, idx, k, lens, seg, floor)


def lex_topk_segments(dist, idx, k: int, lens=None, segment: int = SEGMENT):
    """The first port's K1c, the timing reference of
    :func:`lex_topk_select`: per (query, segment of ``segment``
    candidates) the segment's first k by (dist, id), ([Q, n_seg, k] f32,
    [Q, n_seg, k] i32), empty entries +inf / -1, ``lens`` as there.  On
    the card one block a (query, segment) bitonic-sorts every slot
    (S·log²S/4 compare-exchanges, filled or not)."""
    dev, qn, m = _check_topk_args(dist, idx, lens)
    if k > segment // 2:  # each pass must shrink the pool (the chain's loop)
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


def lex_topk_segments_plain(dist, idx, k, lens=None, segment: int = SEGMENT, floor=None):
    """Plain PyTorch version of both K1c kernels: per segment one sort of
    the int64 keys, the first k (a segment narrower than k padded);
    ``floor`` as :func:`lex_topk_select`'s."""
    qn, m = dist.shape
    n_seg = max(1, -(-m // segment))
    key = _keys(dist, idx, lens, floor)
    big = torch.iinfo(torch.int64).max
    key = torch.cat([key, key.new_full((qn, n_seg * segment - m), big)], 1)
    key = key.reshape(qn, n_seg, segment)
    if segment < k:
        key = torch.cat([key, key.new_full((qn, n_seg, k - segment), big)], 2)
    key = torch.sort(key, dim=-1).values[..., :k]
    empty = key == big
    d = (key >> 32).to(torch.int32).contiguous().view(torch.float32)
    i = (key & 0xFFFFFFFF).to(torch.int32)
    return (
        torch.where(empty, torch.full_like(d, float("inf")), d),
        torch.where(empty, torch.full_like(i, -1), i),
    )


def lex_topk_segments_chain(dist, idx, k: int, lens=None):
    """The first port's ``lex_topk``: :func:`lex_topk_segments` re-launched
    over its own output until one segment remains — the timing reference
    of :func:`lex_topk`.  ([Q, k], [Q, k])."""
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
    and ``_v2``).  On the card, hashes of :data:`TC_HAMMING_BYTES` bytes
    (the published 16x16 phash, any ``byte_limit``) go to the tensor-core
    K2a (``csrc/tc_scan.cu``: each packed row expanded in registers to the
    ±1 int8 form the TPU multiplied, an int8 ``wgmma`` against the ±1
    queries, one integer compare a (query, row) pair); other widths (e.g.
    the 18-byte compat hash) go to the ``__popc`` kernel
    (:func:`hamming_threshold_collect_popc`, its own launch count).  Only
    θ-passing rows are written.
    """
    dev, qn, n, h = _check_hamming_args(q, data, meta, byte_limit)
    _require(theta, "theta", torch.float32, (qn,), dev)
    if dev.type != "cuda":
        return hamming_threshold_collect_plain(q, theta, data, meta, byte_limit, wrap_u8, cap)
    if h != TC_HAMMING_BYTES:
        return hamming_threshold_collect_popc(q, theta, data, meta, byte_limit, wrap_u8, cap)
    if meta.data_ptr() % 16:
        raise ValueError("meta must be 16-byte aligned")
    if q.data_ptr() % 16:  # read with 16-byte loads: copy an unaligned view
        q = q.clone()
    kern = load_tc_kernels()
    count = torch.zeros(qn, dtype=torch.int32, device=dev)
    cand_d = torch.empty((qn, cap), dtype=torch.float32, device=dev)
    cand_i = torch.empty((qn, cap), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_tc_hamming_collect(
            _ptr(q), _ptr(theta), _ptr(data), _ptr(meta), qn, n, h, byte_limit,
            int(wrap_u8), hamming_scale(byte_limit), cap,
            _ptr(count), _ptr(cand_d), _ptr(cand_i), _stream(dev),
        )
    _check(rc, "hamming_threshold_collect")
    LAUNCHES["hamming_threshold_collect"] += 1
    return count, cand_d, cand_i


def hamming_threshold_collect_popc(q, theta, data, meta, byte_limit: int, wrap_u8: bool, cap: int):
    """K2a on the ``__popc`` kernel of the first port (``fused_scan.cu``
    ``hamming_collect_kernel``: one thread a row against 32 staged
    queries), for CUDA tensors only: :func:`hamming_threshold_collect`'s
    path for widths other than :data:`TC_HAMMING_BYTES`, and the timing
    reference of the tensor-core kernel.  Same contract and outputs."""
    dev = data.device
    qn, h = q.shape
    if _COLLECT_Q * h > 48 * 1024:
        raise ValueError(f"hash width {h} too wide for hamming_threshold_collect")
    kern = load_kernels()
    count = torch.zeros(qn, dtype=torch.int32, device=dev)
    cand_d = torch.empty((qn, cap), dtype=torch.float32, device=dev)
    cand_i = torch.empty((qn, cap), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_hamming_collect(
            _ptr(q), _ptr(theta), _ptr(data), _ptr(meta), qn, data.shape[0], h, byte_limit,
            int(wrap_u8), hamming_scale(byte_limit), cap,
            _ptr(count), _ptr(cand_d), _ptr(cand_i), _stream(dev),
        )
    _check(rc, "hamming_threshold_collect_popc")
    LAUNCHES["hamming_threshold_collect_popc"] += 1
    return count, cand_d, cand_i


def hamming_threshold_collect_plain(q, theta, data, meta, byte_limit, wrap_u8, cap):
    """Plain PyTorch version of K2a (collects in ascending row order)."""
    return _collect_plain(
        lambda lo, hi: _hamming_tile_dist(q, data[lo:hi], meta[lo:hi], byte_limit, wrap_u8),
        q.shape[0], data.shape[0], theta, cap, _PLAIN_BLOCK,
    )


def hamming_chunk_topk(q, max_distance, data, meta, byte_limit: int, wrap_u8: bool, k: int):
    """K2b: per row chunk, the exact top-k by (dist, id) of {rows with
    ``meta != 0`` and dist < max_distance}: ([Q, n_chunks, k] f32,
    [Q, n_chunks, k] i32), missing entries +inf / -1 last.  At
    :data:`TC_HAMMING_BYTES`-byte hashes the chunk is :func:`tc_chunk_rows`
    rows and a chunk's k are listed in row order; at other widths
    :data:`CHUNK_ROWS` rows, by (dist, id) (:func:`hamming_chunk_rows`).

    The exact scan behind the Hamming repair, the mixed-width phash search
    and the duplicate scans, where the JAX package ran its XLA
    ``hamming_gemm_scan_topk`` / ``hamming_scan_topk``
    (``hamming_gemm.py:156``, ``scan.py:663``).  On the card, hashes of
    :data:`TC_HAMMING_BYTES` bytes (any ``byte_limit``) go to the
    tensor-core K2b (``csrc/tc_scan.cu`` ``tc_chunk_topk_kernel``: K2a's ±1
    product on int8 ``wgmma``, then per query a shared buffer of the keys
    below the k-th so far, filtered on the integer diff and pruned by a
    radix select; its work past the product follows the rows under the
    k-th and k); other widths to the first port's ``__popc`` kernel
    (:func:`hamming_chunk_topk_popc`, its own launch count).
    """
    dev, qn, n, h = _check_hamming_args(q, data, meta, byte_limit)
    md = float(np.float32(max_distance))
    if dev.type != "cuda":
        return hamming_chunk_topk_plain(q, md, data, meta, byte_limit, wrap_u8, k)
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the scan kernels' limit of {MAX_K}")
    if h != TC_HAMMING_BYTES:
        return hamming_chunk_topk_popc(q, md, data, meta, byte_limit, wrap_u8, k)
    with torch.cuda.device(dev):
        kern, plan, (out_d, out_i, _parts) = _tc_chunk_launch("hamming", qn, n, h, k, dev)
        rc = kern.lib.px_tc_hamming_chunk_topk(
            _ptr(q), md, _ptr(data), _ptr(meta), qn, n, h, byte_limit,
            int(wrap_u8), hamming_scale(byte_limit), *plan,
            _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "hamming_chunk_topk")
    LAUNCHES["hamming_chunk_topk"] += 1
    return out_d, out_i


def hamming_chunk_topk_popc(q, max_distance, data, meta, byte_limit: int, wrap_u8: bool, k: int):
    """K2b on the first port's ``__popc`` kernel (``fused_scan.cu``
    ``hamming_chunk_topk_kernel``: 4 queries a block, a bitonic sort of
    every slot of each :data:`CHUNK_ROWS`-row chunk), for CUDA tensors
    only: :func:`hamming_chunk_topk`'s path for widths other than
    :data:`TC_HAMMING_BYTES`, and the timing reference of the tensor-core
    kernel.  Same contract at a chunk of :data:`CHUNK_ROWS`."""
    dev, qn, n, h = _check_hamming_args(q, data, meta, byte_limit)
    if 4 * CHUNK_ROWS * 8 + 4 * h > 48 * 1024:
        raise ValueError(f"hash width {h} too wide for hamming_chunk_topk_popc")
    kern = load_kernels()
    n_chunks = -(-n // CHUNK_ROWS)
    out_d = torch.empty((qn, n_chunks, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_chunks, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_hamming_chunk_topk(
            _ptr(q), float(np.float32(max_distance)), _ptr(data), _ptr(meta), qn, n, h, byte_limit,
            int(wrap_u8), hamming_scale(byte_limit), CHUNK_ROWS, k, n_chunks,
            _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "hamming_chunk_topk_popc")
    LAUNCHES["hamming_chunk_topk_popc"] += 1
    return out_d, out_i


def hamming_chunk_rows(h: int, n: int, k: int) -> int:
    """The chunk of the K2b kernel that h-byte hashes take:
    :func:`tc_chunk_rows` on the tensor cores, :data:`CHUNK_ROWS` on the
    first port's kernel."""
    return tc_chunk_rows(n, k) if h == TC_HAMMING_BYTES else CHUNK_ROWS


def hamming_chunk_topk_plain(q, max_distance, data, meta, byte_limit, wrap_u8, k,
                             chunk_rows: Optional[int] = None):
    """Plain PyTorch version of K2b: (dist, id) int64 keys per chunk, the k
    smallest by ``torch.topk`` (keys are unique, so the order is), laid
    out as the kernel its width takes does: at :data:`TC_HAMMING_BYTES` a
    chunk of :func:`tc_chunk_rows`, its first k listed in row order; at
    other widths the first port's chunk of :data:`CHUNK_ROWS`, by (dist,
    id).  ``chunk_rows`` overrides the length."""
    dev = data.device
    qn, n = q.shape[0], data.shape[0]
    row_order = q.shape[1] == TC_HAMMING_BYTES
    if chunk_rows is None:
        chunk_rows = hamming_chunk_rows(q.shape[1], n, k)
    n_chunks = -(-n // chunk_rows)
    kk = min(k, chunk_rows)
    out_d = torch.full((qn, n_chunks, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((qn, n_chunks, k), -1, dtype=torch.int32, device=dev)
    md = _f32(max_distance, out_d)
    big = torch.iinfo(torch.int64).max
    per = max(1, _PLAIN_BLOCK // chunk_rows)
    for c0 in range(0, n_chunks, per):
        start, end = c0 * chunk_rows, min(n, (c0 + per) * chunk_rows)
        dist, ok = _hamming_tile_dist(q, data[start:end], meta[start:end], byte_limit, wrap_u8)
        rows = torch.arange(start, end, dtype=torch.int64, device=dev)
        key = (dist.contiguous().view(torch.int32).to(torch.int64) << 32) | rows[None, :]
        key = torch.where(ok & (dist < md), key, torch.full_like(key, big))
        nc = -(-(end - start) // chunk_rows)
        pad = nc * chunk_rows - (end - start)
        if pad:
            key = torch.cat([key, key.new_full((qn, pad), big)], 1)
        top = torch.topk(
            key.reshape(qn, nc, chunk_rows), kk, dim=-1, largest=False, sorted=True
        ).values
        if row_order:
            by_row = torch.argsort(torch.where(top == big, big, top & 0xFFFFFFFF), dim=-1)
            top = torch.gather(top, -1, by_row)
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

    kind = "cosine"

    @property
    def tc_theta(self) -> bool:
        """Whether the θ kernel takes this width."""
        return self.q_codes.shape[1] in TC_COSINE_DIMS

    def dist(self, data, meta):
        return _tile_dist(self.q_codes, self.q_sum, self.q_mag2, self.qr, data, meta)

    def collect(self, theta, data, meta, cap):
        return cosine_threshold_collect(
            self.q_codes, self.q_sum, self.q_mag2, self.qr, theta, data, meta, cap
        )

    def collect_plain(self, theta, data, meta, cap):
        return cosine_threshold_collect_plain(
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

    @property
    def kind(self) -> str:
        return "cosine4" if self.sym else "cosine4a"

    @property
    def tc_theta(self) -> bool:
        return self.q_codes.shape[1] in TC_COSINE4_DIMS

    def dist(self, data, meta):
        return _tile_dist4(self.q_codes, self.q_sum, self.q_mag2, self.qr, data, meta, self.sym)

    def collect(self, theta, data, meta, cap):
        return cosine4_threshold_collect(
            self.q_codes, self.q_sum, self.q_mag2, self.qr, theta, data, meta, self.sym, cap
        )

    def collect_plain(self, theta, data, meta, cap):
        return cosine4_threshold_collect_plain(
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
            self.kind, lens, cand_i,
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

    kind = "hamming"

    @property
    def tc_theta(self) -> bool:
        return self.q.shape[1] == TC_HAMMING_BYTES

    def dist(self, data, meta):
        return _hamming_tile_dist(self.q, data, meta, self.byte_limit, self.wrap_u8)

    def collect(self, theta, data, meta, cap):
        return hamming_threshold_collect(
            self.q, theta, data, meta, self.byte_limit, self.wrap_u8, cap
        )

    def collect_plain(self, theta, data, meta, cap):
        return hamming_threshold_collect_plain(
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

    1. θ0, the j0-th distance (j0 ≈ 4j/16, at least 8) of a 1/16
       mini-subsample of the sample, at most max_distance;
    2. over the FULL sample, the exact count of the rows under θ0 and the
       j-th smallest of their distances.

    ``qk`` is a :class:`CosineQueries`, :class:`Int4Queries` or
    :class:`HammingQueries`; ``smp`` an ``ops.scan.ScanSample`` (contiguous
    ``data`` and its kernel ``meta``, the index's layouts).

    If θ0 comes up short (fewer than j rows under it) or more than
    :func:`sample_cap` rows are under it, the value falls back to θ0
    itself, as the JAX package does (its overflow test is the carry
    kernel's poison flag); θ accuracy only shapes work, never the proof.
    Returns [Q] f32; value == max_distance ⟺ θ is unbound.

    On the card, at the widths of the tensor-core collects (u8 rows of
    :data:`TC_COSINE_DIMS` bytes, int4 rows of :data:`TC_COSINE4_DIMS`
    dims, :data:`TC_HAMMING_BYTES`-byte hashes) both stages are the θ
    kernel (:func:`_tc_sample_theta`, counter ``sample_theta``: two
    launches on int8 ``wgmma``, no torch op between them); at other
    widths stage 1 is the width's chunk top-k + K1c over the mini rows
    (:func:`mini_sample_chunk_theta`) and stage 2 its collect + K1c.  A
    CPU sample takes :func:`sample_theta_plain`.  All three are bit-equal.
    """
    if smp.data.device.type != "cuda":
        return sample_theta_plain(qk, smp, max_distance, j)
    if qk.tc_theta:
        return _tc_sample_theta(qk, smp, max_distance, j)
    return _sample_stage2(qk, smp, mini_sample_chunk_theta(qk, smp, max_distance, j), j)


def sample_theta_plain(qk, smp, max_distance, j: int):
    """Plain PyTorch version of :func:`sample_theta`: the plain-torch
    mini-sample (:func:`mini_sample_theta`), the plain collect of the rows
    under θ0 and the plain select of their j-th."""
    theta0 = mini_sample_theta(qk, smp, max_distance, j)
    cap = sample_cap(j)
    count, cand_d, cand_i = qk.collect_plain(theta0, smp.data, smp.meta, cap)
    best_d, _ = lex_topk_select_plain(cand_d, cand_i, j, torch.clamp(count, max=cap))
    return _theta_from_buffer(theta0, count, best_d[:, 0], cap, j)


def sample_theta_chain(qk, smp, max_distance, j: int):
    """The θ stage as the first port composed it, kept as the θ kernel's
    timing reference (no main path calls it): the plain-torch mini-sample,
    then the width's collect (K1a/K4a/K2a) and K1c over the sample."""
    return _sample_stage2(qk, smp, mini_sample_theta(qk, smp, max_distance, j), j)


def _sample_stage2(qk, smp, theta0, j: int):
    """Stage 2 on the collect kernel and K1c: every sample row under θ0
    into a buffer with an exact count, then its j-th."""
    cap = sample_cap(j)
    count, cand_d, cand_i = qk.collect(theta0, smp.data, smp.meta, cap)
    best_d, _ = lex_topk(cand_d, cand_i, j, lens=torch.clamp(count, max=cap))
    return _theta_from_buffer(theta0, count, best_d, cap, j)


def _theta_from_buffer(theta0, count, best_d, cap: int, j: int):
    """θ from stage 2's sorted best distances [Q, >= j]: the j-th where j
    <= count <= cap (it is finite exactly when count >= j), else θ0."""
    jth = best_d[:, j - 1]
    ok = torch.isfinite(jth) & (count <= cap)
    return torch.where(ok, jth, theta0)


def sample_cap(j: int) -> int:
    """The buffer of :func:`sample_theta`'s stage 2 (16j, at least 2048)."""
    return max(2048, topk_ops._next_pow2(16 * j))


def mini_sample_shape(s: int, j: int) -> Tuple[int, int, int]:
    """(stride, s0, j0) of stage 1 over an s-row sample: the mini rows are
    ``sample[::stride]`` (stride 16, halved while it leaves fewer than
    1,024 rows or does not divide s), s0 of them, and θ0 is their j0-th
    distance, j0 = min(s0, max(8, ⌈4·j·s0 / s⌉))."""
    stride = 16
    while stride > 1 and (s // stride < 1024 or s % stride != 0):
        stride //= 2
    s0 = -(-s // stride)
    return stride, s0, min(s0, max(8, -(-4 * j * s0 // s)))


def _mini_rows(smp, stride: int):
    return smp.data[::stride].contiguous(), smp.meta[..., ::stride].contiguous()


def mini_sample_theta(qk, smp, max_distance, j: int):
    """Stage 1 of :func:`sample_theta` in plain torch: θ0, the j0-th
    distance of the mini-subsample (:func:`mini_sample_shape`); [Q] f32, at
    most max_distance.  The plain version's and the timing reference's."""
    stride, _, j0 = mini_sample_shape(smp.data.shape[0], j)
    mini, mmeta = _mini_rows(smp, stride)
    md = _f32(max_distance, smp.data)
    dist0, valid0 = qk.dist(mini, mmeta)
    dist0 = torch.where(valid0 & (dist0 < md), dist0, torch.full_like(dist0, float("inf")))
    t0, _ = topk_ops.block_topk(dist0, torch.zeros_like(dist0, dtype=torch.int32), j0)
    return torch.minimum(t0[:, j0 - 1], md).contiguous()


def mini_sample_chunk_theta(qk, smp, max_distance, j: int):
    """Stage 1 on the hand kernels at the widths the θ kernel does not take:
    the width's chunk top-k (K1b/K4b/K2b) over the mini rows with k = j0,
    then K1c — the j0-th (dist, id) key's distance is
    :func:`mini_sample_theta`'s j0-th value."""
    stride, _, j0 = mini_sample_shape(smp.data.shape[0], j)
    mini, mmeta = _mini_rows(smp, stride)
    part_d, part_i = qk.chunk_topk(max_distance, mini, mmeta, j0)
    qn = part_d.shape[0]
    t0, _ = lex_topk(part_d.reshape(qn, -1), part_i.reshape(qn, -1), j0)
    return torch.minimum(t0[:, j0 - 1], _f32(max_distance, t0)).contiguous()


#: Query tiles of the θ kernel's launches: A (θ0 over the mini rows) and B
#: (the sample under θ0); ``csrc/tc_theta.cu`` instantiates these.
THETA_A_QUERIES = (8, 32)
THETA_B_QUERIES = (8, 16, 32)
#: Values a launch-A block keeps in shared memory: its queries × its rows.
THETA_VALS = 8192
#: Blocks a θ launch aims at per SM.
_THETA_BLOCKS_PER_SM = 4
_SM_COUNTS: dict = {}


def theta_plan(qn: int, s: int, s0: int, sms: int):
    """The θ kernel's launch plan for qn queries over an s-row sample with
    s0 mini rows on a card of ``sms`` SMs: ((nq0, parts0, tiles0), (nq1,
    parts1, tiles1)) — each launch's query tile, the parts its rows are cut
    into (one block a query tile and part) and the 64-row tiles a part.
    Launch B's query tile is 8 up to 8 queries, 16 up to 32 (its last
    block's selects are the tail), 32 past that.  The parts grow until
    the grid has about four blocks an SM; launch A's part stays within
    :data:`THETA_VALS` values, launch B's takes at least 4 tiles.  The
    result does not depend on the plan."""
    nq0 = THETA_A_QUERIES[0] if qn <= 256 else THETA_A_QUERIES[1]
    nq1 = 8 if qn <= 8 else 16 if qn <= 32 else 32
    blocks = _THETA_BLOCKS_PER_SM * sms
    return (
        (nq0, *_theta_parts(qn, nq0, s0, blocks, 2, THETA_VALS // (64 * nq0))),
        (nq1, *_theta_parts(qn, nq1, s, blocks, 4, None)),
    )


def _theta_parts(qn, nq, n, blocks, min_tiles, max_tiles):
    tiles = -(-n // 64)
    want = max(1, -(-blocks // -(-qn // nq)))
    tpp = max(min_tiles, -(-tiles // want))
    if max_tiles is not None:
        tpp = min(tpp, max_tiles)
    tpp = min(tpp, tiles)
    return -(-tiles // tpp), tpp


def _sm_count(dev) -> int:
    if dev not in _SM_COUNTS:
        _SM_COUNTS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNTS[dev]


def _tc_sample_theta(qk, smp, max_distance, j: int, plan=None):
    """:func:`sample_theta` on the θ kernel (``csrc/tc_theta.cu``
    ``tc_theta_kernel``), for CUDA tensors at the tensor-core widths: launch
    A reads the mini rows straight out of the sample (a tensor map whose
    row pitch is the stride) and writes θ0; launch B counts the sample's
    rows under θ0 exactly and selects the j-th of their distances, or falls
    back to θ0.  Both multiply on int8 ``wgmma`` (K1a's, K4a's and K2a's
    operand paths) and select with a radix select of the distances' bits;
    the last block of a query tile merges the parts.  ``plan`` overrides
    :func:`theta_plan` (timing only).  Raises if the build or a launch
    fails."""
    data, meta = smp.data, smp.meta
    ham = qk.kind == "hamming"
    if ham:
        dev, qn, s, d = _check_hamming_args(qk.q, data, meta, qk.byte_limit)
        q, cos = qk.q, [ctypes.c_void_p(None)] * 3
        ham_args = (qk.byte_limit, int(qk.wrap_u8), hamming_scale(qk.byte_limit))
    else:
        dev, qn, s, d = _check_query_args(
            qk.q_codes, qk.q_sum, qk.q_mag2, qk.qr, data, meta, packed=qk.kind != "cosine"
        )
        q, cos = qk.q_codes, [_ptr(qk.q_sum), _ptr(qk.q_mag2), _ptr(qk.qr)]
        ham_args = (0, 0, 0.0)
    if q.data_ptr() % 16:  # a TMA source / 16-byte loads: copy an unaligned view
        q = q.clone()
    stride, s0, j0 = mini_sample_shape(s, j)
    cap = sample_cap(j)
    (nq0, p0, t0), (nq1, p1, t1) = plan or theta_plan(qn, s, s0, _sm_count(dev))
    kern = load_theta_kernels()
    ws = torch.zeros(-(-qn // nq0) + -(-qn // nq1) + qn, dtype=torch.int32, device=dev)
    part_vals = torch.empty(qn * p0 * j0, dtype=torch.int32, device=dev)
    cand = torch.empty(qn * cap, dtype=torch.int32, device=dev)
    out = torch.empty((2, qn), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_tc_sample_theta(
            _ptr(q), *cos, _ptr(data), _ptr(meta), qn, s, d, _KIND_CODES[qk.kind], stride, s0,
            j0, j, cap, float(np.float32(max_distance)), *ham_args,
            _KEY_SCALE, DIST_SATURATION, KEY_LOOSE, nq0, p0, t0, nq1, p1, t1,
            _ptr(ws), _ptr(part_vals), _ptr(cand), _ptr(out[0]), _ptr(out[1]), _stream(dev),
        )
    _check(rc, "sample_theta")
    LAUNCHES["sample_theta"] += 1
    return out[1]


def _as_queries(query_u8, device, stage=None) -> Tuple[torch.Tensor, bool]:
    """u8 queries [Q, D] (or [D], promoted) on ``device``; the flag says
    whether the caller should squeeze its results back to one query.  A
    copy between host memory and a card is a host sync (from pageable
    memory it waits for the card's queue), counted in the caller's open
    span ``stage`` where one is given."""
    q = query_u8 if torch.is_tensor(query_u8) else torch.as_tensor(np.asarray(query_u8))
    to = device.type if isinstance(device, torch.device) else torch.device(device).type
    if q.device.type != to:
        if stage is None:
            bump("host_syncs")
        else:
            stage.syncs += 1
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
    if cap is None:
        cap = max(4096, topk_ops._next_pow2(8 * target_count))
    with span("scan.theta") as stage:
        theta_j = qk.widen(sample_theta(qk, smp, max_distance, j))
        theta = torch.minimum(theta_j, md).contiguous()
        unbound = ~(theta_j < md)
        stage.then("scan.collect")
        if epilogue == "cos":
            count, _, cand_i = qk.coskey_collect(cos_key_threshold(theta), data, meta, cap)
            lens = torch.clamp(count, max=cap)
            cand_d = qk.rescore(theta, data, meta, lens, cand_i)
        else:
            count, cand_d, cand_i = qk.collect(theta, data, meta, cap)
            lens = torch.clamp(count, max=cap)
        stage.then("scan.select")
        best_d, best_i = lex_topk(cand_d, cand_i, k, lens=lens)
        # count <= cap: every row passing the filter (dist: exactly the θ
        # rows; cos: a superset of them, the rest now +inf) was collected,
        # so the collected top-k is the true top-k when k rows pass θ (the
        # k-th distance is finite) or when θ is unbound (the WHERE-clause
        # result).
        exact = (count <= cap) & (torch.isfinite(best_d[:, k - 1]) | unbound)
    return best_d, best_i, exact


def _exact_scan(qk, qn, data, meta, k, max_distance):
    """K1b/K4b/K2b + K1c: the exact top-k of ``WHERE dist < max_distance``.

    The chunk kernels keep a chunk's first :data:`MAX_K`, so a larger k
    takes the collect instead (:func:`_exact_collect_scan`)."""
    if k > MAX_K:
        return _exact_collect_scan(qk, qn, data, meta, k, max_distance)
    part_d, part_i = qk.chunk_topk(max_distance, data, meta, k)
    return lex_topk(part_d.reshape(qn, -1), part_i.reshape(qn, -1), k)


#: Bytes of the [Q, N] (dist, id) buffer one block of queries of
#: :func:`_exact_collect_scan` may fill.
EXACT_COLLECT_BYTES = 1 << 30


def _exact_collect_scan(qk, qn, data, meta, k, max_distance):
    """The exact top-k for k past :data:`MAX_K`: the width's collect
    (K1a/K4a/K2a) with θ = max_distance for every query and a buffer of
    every row (cap = N, so its exact count never overflows), then K1c's
    rounds.  Queries go in blocks whose buffers stay under
    :data:`EXACT_COLLECT_BYTES`."""
    n = data.shape[0]
    cap = max(1, n)
    step = max(1, EXACT_COLLECT_BYTES // (8 * cap))
    outs = []
    for s in range(0, qn, step):
        e = min(qn, s + step)
        theta = torch.full((e - s,), float(np.float32(max_distance)), dtype=torch.float32, device=data.device)
        count, cand_d, cand_i = _query_rows(qk, s, e).collect(theta, data, meta, cap)
        outs.append(lex_topk(cand_d, cand_i, k, lens=torch.clamp(count, max=cap)))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _query_rows(qk, start: int, end: int):
    """Queries ``start:end`` of a kind object (its tensor fields sliced)."""
    return qk._replace(**{
        f: getattr(qk, f)[start:end] for f in qk._fields if torch.is_tensor(getattr(qk, f))
    })


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
    qk, squeeze = _cosine_queries(query_u8, index)
    out = _threshold_scan(
        qk, index.data, row_meta, smp, k, max_distance, target_count, cap, epilogue,
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
    qk, squeeze = _cosine_queries(query_u8, index)
    out = _exact_scan(qk, qk.q_codes.shape[0], index.data, row_meta, k, max_distance)
    return _squeezed(out, squeeze)


def _cosine_queries(query_u8, index):
    with span("scan.prep") as stage:
        q, squeeze = _as_queries(query_u8, index.device, stage)
        return CosineQueries.from_u8(q), squeeze


def _int4_queries(query_u8, index, query_mode):
    with span("scan.prep") as stage:
        q, squeeze = _as_queries(query_u8, index.device, stage)
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
    with span("scan.prep") as stage:
        q, squeeze = _as_queries(query_u8, index.device, stage)
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
