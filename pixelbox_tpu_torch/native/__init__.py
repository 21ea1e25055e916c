"""Native (C++) host codecs, loaded via ctypes.

The C++ sources live beside this file (``qoi.cpp``: QOI thumbnails;
``image_decode.cpp``: libjpeg/libpng/libwebp decode and the separable
resampler; ``cpu_scan.cpp``: the CPU scan) — unchanged copies of the JAX
package's, so both packages decode, thumbnail and resample alike.  They
are compiled into this package's git-ignored build directory
(``pixelbox_tpu_torch/_build/``, or $PIXELBOX_TPU_TORCH_BUILD_DIR) with
g++ -O3 on first use.  Every native entry point has a pure-Python
fallback in its caller, so a host without a toolchain degrades
gracefully: these are host codecs, not device kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False

_SOURCES = ["qoi.cpp", "cpu_scan.cpp"]
# Decode support links system image codecs; built separately so a host
# without libjpeg/libpng/libwebp still gets the core native library.
_DECODE_SOURCE = "image_decode.cpp"
_DECODE_LIBS = ["-ljpeg", "-lpng16", "-lwebp"]
_SO_NAME = "libpixelbox_native.so"


def _build_dir() -> Path:
    d = os.environ.get("PIXELBOX_TPU_TORCH_BUILD_DIR")
    return Path(d) if d else _PKG / "_build"


def _newest_mtime(paths) -> float:
    return max(p.stat().st_mtime for p in paths)


def _compile(srcs, libs, out: Path) -> None:
    """g++ into a private name, then rename: concurrent test workers must
    never load a half-written library."""
    tmp = out.parent / f".{out.name}.{os.getpid()}"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]
        + [str(s) for s in srcs] + libs + ["-o", str(tmp)],
        check=True, capture_output=True, timeout=240,
    )
    os.replace(tmp, out)


def load_native():
    """Build (if stale) and load the native library; None if unavailable."""
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            srcs = [_SRC_DIR / s for s in _SOURCES if (_SRC_DIR / s).exists()]
            if not srcs:
                raise FileNotFoundError(f"no native sources under {_SRC_DIR}")
            decode_src = _SRC_DIR / _DECODE_SOURCE
            all_srcs = srcs + ([decode_src] if decode_src.exists() else [])
            out_dir = _build_dir()
            out_dir.mkdir(parents=True, exist_ok=True)
            so = out_dir / _SO_NAME
            if not so.exists() or so.stat().st_mtime < _newest_mtime(all_srcs):
                try:
                    _compile(all_srcs, _DECODE_LIBS, so)
                except (OSError, subprocess.SubprocessError):
                    # No image codec libs/headers on this host: build the
                    # core library without native decode.
                    _compile(srcs, [], so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                # Codec headers present at build time but a codec's shared
                # library missing at load time: fall back to the core.
                core = out_dir / ("core_" + _SO_NAME)
                if not core.exists() or core.stat().st_mtime < _newest_mtime(srcs):
                    _compile(srcs, [], core)
                lib = ctypes.CDLL(str(core))
            _configure_signatures(lib)
            _LIB = lib
        except Exception as e:  # toolchain missing, build error, load error
            print(f"pixelbox_tpu_torch: native library unavailable ({e}); "
                  "using Python fallbacks", file=sys.stderr)
            _LIB_FAILED = True
        return _LIB


def _configure_signatures(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.qoi_encode_bound.restype = ctypes.c_size_t
    lib.qoi_encode_bound.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.qoi_encode.restype = ctypes.c_size_t
    lib.qoi_encode.argtypes = [
        u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        u8p, ctypes.c_size_t,
    ]
    lib.qoi_decode_header.restype = ctypes.c_int
    lib.qoi_decode_header.argtypes = [u8p, ctypes.c_size_t, u32p, u32p, u32p]
    lib.qoi_decode.restype = ctypes.c_size_t
    lib.qoi_decode.argtypes = [
        u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, ctypes.c_uint32,
    ]
    if hasattr(lib, "px_decode_rgb"):
        lib.px_sniff.restype = ctypes.c_int
        lib.px_sniff.argtypes = [u8p, ctypes.c_size_t]
        lib.px_decode_header.restype = ctypes.c_int
        lib.px_decode_header.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int, u32p, u32p, u32p, u32p,
        ]
        lib.px_decode_rgb.restype = ctypes.c_int
        lib.px_decode_rgb.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int, u8p, ctypes.c_size_t,
            u32p, u32p,
        ]
        lib.px_resize.restype = None
        lib.px_resize.argtypes = [
            u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        ]
    if hasattr(lib, "cpu_cosine_scan_topk"):
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.cpu_cosine_scan_topk.restype = None
        lib.cpu_cosine_scan_topk.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64,  # db, n, d
            u8p, ctypes.c_int64,                  # queries, q
            ctypes.c_int32, ctypes.c_float,       # k, max_distance
            ctypes.c_int32,                       # n_threads
            f32p, i32p,                           # out dist, out idx
        ]
