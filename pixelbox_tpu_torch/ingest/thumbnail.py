"""QOI thumbnail encode/decode (native C++ with pure-Python fallback).

Thumbnails follow the reference: aspect-preserving fit within 256×256, RGB8,
QOI-compressed, stored in the catalog's ``images.thumbnail`` blob column
(reference src/indexed_image.rs:13, 54-57).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from pixelbox_tpu_torch.native import load_native
from pixelbox_tpu_torch.ops.resample import resize_dimensions, resize_fast

THUMBNAIL_SIZE = (256, 256)  # indexed_image.rs:13


def make_thumbnail(
    img_rgb: np.ndarray, prescaled: np.ndarray | None = None
) -> np.ndarray:
    """HxWx3 u8 → aspect-preserving thumbnail fitting 256×256 (u8).

    Hot ingest path: native C++ separable triangle resampler when built,
    else PIL's SIMD resampler (same kernel family as the image crate's).

    ``prescaled``: an already cover-resized copy of ``img_rgb`` (the
    ingest embed frame's pre-crop ``big`` — it shows the whole image).
    When its dimensions still exceed the fit target, the thumbnail
    resamples from it instead of the full-res original, so the expensive
    full-resolution pass is paid once per ingested image.  Thumbnails
    are display-only blobs (never hashed or compared), so the slightly
    different two-step filter footprint is semantically free.
    """
    h, w = img_rgb.shape[:2]
    if w <= THUMBNAIL_SIZE[0] and h <= THUMBNAIL_SIZE[1]:
        return np.ascontiguousarray(img_rgb, dtype=np.uint8)
    # Fit dims always derive from the ORIGINAL aspect ratio.
    out_w, out_h = resize_dimensions(w, h, *THUMBNAIL_SIZE, fill=False)
    src = img_rgb
    if prescaled is not None:
        ph, pw = prescaled.shape[:2]
        # Use the frame only when it is an actual DOWNSCALE of the
        # original that still covers the fit target: a short-side
        # original (e.g. 300x100 -> cover 672x224) would otherwise hand
        # us an UPSCALED source — blurrier and more pixels to resample
        # than the original itself (ADVICE r4).
        if pw >= out_w and ph >= out_h and pw <= w and ph <= h:
            src = prescaled
    return resize_fast(src, out_w, out_h)


def qoi_encode(img_rgb: np.ndarray) -> bytes:
    """HxWx3 (or HxWx4) u8 → QOI bytes."""
    img = np.ascontiguousarray(img_rgb, dtype=np.uint8)
    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim == 3 else 1
    assert channels in (3, 4), img.shape
    lib = load_native()
    if lib is not None:
        bound = lib.qoi_encode_bound(w, h)
        out = np.empty(bound, dtype=np.uint8)
        n = lib.qoi_encode(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w, h, channels,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            bound,
        )
        if n > 0:
            return out[:n].tobytes()
    return _qoi_encode_py(img, w, h, channels)


def qoi_decode(data: bytes, channels: int = 3) -> Tuple[np.ndarray, Tuple[int, int]]:
    """QOI bytes → (HxWxC u8 array, (width, height))."""
    buf = np.frombuffer(data, dtype=np.uint8)
    lib = load_native()
    if lib is not None:
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        ch = ctypes.c_uint32()
        ok = lib.qoi_decode_header(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch),
        )
        if ok:
            out = np.empty(w.value * h.value * channels, dtype=np.uint8)
            n = lib.qoi_decode(
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out),
                channels,
            )
            if n:
                return out.reshape(h.value, w.value, channels), (w.value, h.value)
        raise ValueError("invalid QOI data")
    return _qoi_decode_py(bytes(data), channels)


# --------------------------------------------------------------------- #
# Pure-Python fallback (correct, slow — only used without a C++ toolchain)


def _qoi_encode_py(img: np.ndarray, w: int, h: int, channels: int) -> bytes:
    out = bytearray()
    out += b"qoif"
    out += w.to_bytes(4, "big") + h.to_bytes(4, "big")
    out += bytes([channels, 0])
    index = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    run = 0
    flat = img.reshape(-1, channels)
    for px_row in flat:
        if channels == 4:
            px = (int(px_row[0]), int(px_row[1]), int(px_row[2]), int(px_row[3]))
        else:
            px = (int(px_row[0]), int(px_row[1]), int(px_row[2]), 255)
        if px == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | (run - 1))
                run = 0
        else:
            if run:
                out.append(0xC0 | (run - 1))
                run = 0
            hidx = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64
            if index[hidx] == px:
                out.append(hidx)
            else:
                index[hidx] = px
                if px[3] == prev[3]:
                    dr = (px[0] - prev[0] + 128) % 256 - 128
                    dg = (px[1] - prev[1] + 128) % 256 - 128
                    db = (px[2] - prev[2] + 128) % 256 - 128
                    dgr, dgb = dr - dg, db - dg
                    if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                        out.append(0x40 | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2))
                    elif -32 <= dg <= 31 and -8 <= dgr <= 7 and -8 <= dgb <= 7:
                        out.append(0x80 | (dg + 32))
                        out.append(((dgr + 8) << 4) | (dgb + 8))
                    else:
                        out += bytes([0xFE, px[0], px[1], px[2]])
                else:
                    out += bytes([0xFF, *px])
        prev = px
    if run:
        out.append(0xC0 | (run - 1))
    out += b"\x00" * 7 + b"\x01"
    return bytes(out)


def _qoi_decode_py(data: bytes, channels: int):
    assert data[:4] == b"qoif", "invalid QOI magic"
    w = int.from_bytes(data[4:8], "big")
    h = int.from_bytes(data[8:12], "big")
    out = np.empty((w * h, channels), dtype=np.uint8)
    index = [(0, 0, 0, 0)] * 64
    px = (0, 0, 0, 255)
    p = 14
    end = len(data) - 8
    run = 0
    for i in range(w * h):
        if run > 0:
            run -= 1
        elif p < end:
            b1 = data[p]
            p += 1
            if b1 == 0xFE:
                px = (data[p], data[p + 1], data[p + 2], px[3])
                p += 3
            elif b1 == 0xFF:
                px = (data[p], data[p + 1], data[p + 2], data[p + 3])
                p += 4
            elif b1 >> 6 == 0:
                px = index[b1 & 0x3F]
            elif b1 >> 6 == 1:
                px = (
                    (px[0] + ((b1 >> 4) & 3) - 2) % 256,
                    (px[1] + ((b1 >> 2) & 3) - 2) % 256,
                    (px[2] + (b1 & 3) - 2) % 256,
                    px[3],
                )
            elif b1 >> 6 == 2:
                b2 = data[p]
                p += 1
                dg = (b1 & 0x3F) - 32
                px = (
                    (px[0] + dg - 8 + ((b2 >> 4) & 0x0F)) % 256,
                    (px[1] + dg) % 256,
                    (px[2] + dg - 8 + (b2 & 0x0F)) % 256,
                    px[3],
                )
            else:
                run = b1 & 0x3F
            index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64] = px
        out[i] = px[:channels]
    return out.reshape(h, w, channels), (w, h)
