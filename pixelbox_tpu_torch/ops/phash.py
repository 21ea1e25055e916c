"""Perceptual hash (mean-threshold 16×16) — the host path of the
reference's ``ops/phash.py`` (reference src/image_hashes/phash.rs:3-22).

1. aspect-preserving resize to fit 16×16 with the Gaussian filter;
2. grayscale;
3. mean over pixels — with a FIXED 256 divisor (phash.rs:10), so non-square
   images (fewer than 256 pixels after the aspect-preserving fit)
   underestimate the mean and yield a shorter, biased hash;
4. per-pixel bit = (pixel > mean), packed LSB-first into len/8 bytes
   (32 bytes for square inputs).

Ingest stores this hash in the catalog exactly as the JAX package does;
phash search and the batched device hash wait (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from pixelbox_tpu_torch.ops.resample import (
    box_downsample_np,
    grayscale_np,
    resize_dimensions,
    resize_native,
    resize_np,
    to_u8,
)

HASH_SIZE = 16  # 16x16 = 256 bits = 32 bytes (phash.rs:4-5)


def pack_bits_lsb_first(bits: np.ndarray) -> np.ndarray:
    """Pack a flat 0/1 array LSB-first into bytes (phash.rs:11-20).

    Trailing bits that don't fill a byte are DROPPED (len/8 floor), like the
    reference.
    """
    bits = np.asarray(bits).astype(np.uint8).ravel()
    n_bytes = len(bits) // 8
    if n_bytes == 0:
        return np.zeros(0, dtype=np.uint8)
    b = bits[: n_bytes * 8].reshape(n_bytes, 8)
    return np.packbits(b, axis=-1, bitorder="little").ravel()


def phash(
    img_rgb: np.ndarray, aspect_preserving: bool = True, fast: bool = True
) -> np.ndarray:
    """Perceptual hash of one RGB image (HxWx3 uint8) → uint8 bytes.

    aspect_preserving=True replicates the reference exactly (variable-length
    hash + fixed-256 mean divisor for non-square images).

    fast=True box-prefilters large images by an integer factor before the
    Gaussian resample (≈50× cheaper on megapixel inputs, hash bits
    unchanged in practice since a 16-px Gaussian already averages huge
    windows); fast=False runs the direct dense resample.
    """
    img = np.asarray(img_rgb)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w = img.shape[:2]
    if aspect_preserving:
        out_w, out_h = resize_dimensions(w, h, HASH_SIZE, HASH_SIZE, fill=False)
    else:
        out_w, out_h = HASH_SIZE, HASH_SIZE
    small_u8 = None
    if fast:
        # Box-prefilter only pays off above ~2MP (numpy mean temporaries
        # cost more than the tensordot resample below that).
        factor = max(1, min(h, w) // 1024)
        if factor >= 2:
            img = box_downsample_np(img, factor)
        elif img.dtype == np.uint8:
            # Sub-2MP u8 input: the C++ separable gaussian resample shares
            # resample_weights' definition and the same round-half-away u8
            # output as to_u8(resize_np(...)).
            small_u8 = resize_native(img, out_w, out_h, "gaussian")
    if small_u8 is None:
        # The reference resizes u8→u8 (rounded) then grayscales u8→u8
        # (rounded).
        small_u8 = to_u8(resize_np(img, out_w, out_h, "gaussian"))
    grey = to_u8(grayscale_np(small_u8))
    flat = grey.ravel().astype(np.uint64)
    # Fixed 256 divisor regardless of actual pixel count (phash.rs:10),
    # with integer (floor) division like the Rust u64 division.
    mean = np.uint8(flat.sum() // np.uint64(HASH_SIZE * HASH_SIZE))
    return pack_bits_lsb_first(flat > mean)
