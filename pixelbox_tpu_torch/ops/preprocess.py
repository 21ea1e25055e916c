"""Embedder input preprocessing — the host part of the reference's
``ops/preprocess.py`` (reference src/image_hashes/efficientnet.rs:19-29):
``resize_to_fill(224, 224, Triangle)`` → RGB8 → ``pixel/255`` (mean 0,
std 1 — the commented-out ImageNet normalization is NOT applied).

Layout is NHWC like the JAX package; the embedders convert internally.
The reference's batched device resize (``preprocess_batch_tpu``) belongs
to turbo ingest, which waits (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from pixelbox_tpu_torch.ops.resample import (
    resize_dimensions,
    resize_fast,
    resize_to_fill_np,
    to_u8,
)

MODEL_INPUT_SIZE = 224  # efficientnet.rs:6-7


def preprocess_host(
    img_rgb: np.ndarray, size: int = MODEL_INPUT_SIZE, exact: bool = False
) -> np.ndarray:
    """One image HxWx3 u8 → f32 [size, size, 3] in [0, 1] (reference semantics).

    Matches efficientnet.rs:19-29 except layout (HWC here, CHW there).
    Default path runs the native/PIL triangle resampler (same kernel
    family); ``exact=True`` uses the numpy matmul resampler.
    """
    img = np.asarray(img_rgb)
    if exact:
        filled = to_u8(resize_to_fill_np(img, size, size, "triangle"))
    else:
        h, w = img.shape[:2]
        out_w, out_h = resize_dimensions(w, h, size, size, fill=True)
        big = resize_fast(img, out_w, out_h)
        x0 = (out_w - size) // 2
        y0 = (out_h - size) // 2
        filled = big[y0 : y0 + size, x0 : x0 + size]
    return filled.astype(np.float32) / np.float32(255.0)


def fill_resize_u8(img_rgb: np.ndarray, size: int = MODEL_INPUT_SIZE) -> np.ndarray:
    """Cover-resize + center-crop to a square u8 frame (the embedder input,
    ÷255 on the device)."""
    return fill_resize_u8_with_big(img_rgb, size)[0]


def fill_resize_u8_with_big(
    img_rgb: np.ndarray, size: int = MODEL_INPUT_SIZE
) -> tuple:
    """Like :func:`fill_resize_u8` but also returns the pre-crop cover
    image (``big``, u8 [out_h, out_w, 3] with min(out_h, out_w) == size).

    ``big`` still shows the WHOLE image (the crop only trims the long
    axis), so ingest re-uses it as the source for the display thumbnail —
    one full-resolution resample per image instead of two
    (make_thumbnail(prescaled=big)).
    """
    img = np.asarray(img_rgb)
    h, w = img.shape[:2]
    out_w, out_h = resize_dimensions(w, h, size, size, fill=True)
    big = resize_fast(img, out_w, out_h)
    x0 = (out_w - size) // 2
    y0 = (out_h - size) // 2
    return np.ascontiguousarray(big[y0 : y0 + size, x0 : x0 + size]), big
