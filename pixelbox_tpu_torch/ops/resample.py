"""Separable image resampling compatible with the reference's image crate.

The reference resizes with the Rust ``image`` crate (phash uses the
Gaussian filter, src/image_hashes/phash.rs:7; the embedder input uses
Triangle, src/image_hashes/efficientnet.rs:20).  That crate's resampler is
a separable convolution: per output pixel, weights are the filter kernel
evaluated at ``(i + 0.5 - (out + 0.5) * scale) / max(scale, 1)`` over a
support window, normalized to sum 1.

Since resampling is **linear** in the input, each axis reduces to a small
dense weight matrix ``W[out, in]``:

    out = Wv @ img @ Wh.T        (per channel)

which is exactly how the TPU path runs it — a batched MXU matmul
(``jnp.einsum``) with host-precomputed weights — while the host path uses
the same matrices in numpy.  Host and device therefore share one weight
definition; only the accumulation order differs (f32 rounding).

Filters (image crate definitions):
- Triangle: kernel max(0, 1-|x|), support 1.0 (bilinear).
- Gaussian: kernel N(0, 0.5) pdf = exp(-x²/0.5)/(0.5·sqrt(2π)), support 3.0.
- CatmullRom / Lanczos3 provided for completeness.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _gaussian(x: np.ndarray, r: float = 0.5) -> np.ndarray:
    return np.exp(-(x**2) / (2.0 * r * r)) / (math.sqrt(2.0 * math.pi) * r)


def _sinc(x: np.ndarray) -> np.ndarray:
    return np.sinc(x)  # sin(pi x)/(pi x)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) < 3.0, _sinc(x) * _sinc(x / 3.0), 0.0)


def _catmull_rom(x: np.ndarray) -> np.ndarray:
    a = np.abs(x)
    return np.where(
        a < 1.0,
        1.5 * a**3 - 2.5 * a**2 + 1.0,
        np.where(a < 2.0, -0.5 * a**3 + 2.5 * a**2 - 4.0 * a + 2.0, 0.0),
    )


FILTERS = {
    "triangle": (_triangle, 1.0),
    "gaussian": (_gaussian, 3.0),
    "lanczos3": (_lanczos3, 3.0),
    "catmullrom": (_catmull_rom, 2.0),
}


@lru_cache(maxsize=256)
def resample_weights(n_in: int, n_out: int, filter_name: str) -> np.ndarray:
    """Dense 1-D resampling matrix W[n_out, n_in] (rows sum to 1), f32."""
    kernel, support = FILTERS[filter_name]
    scale = n_in / n_out
    filter_scale = max(scale, 1.0)
    src_support = support * filter_scale

    w = np.zeros((n_out, n_in), dtype=np.float64)
    for out in range(n_out):
        center = (out + 0.5) * scale
        left = max(int(math.floor(center - src_support)), 0)
        right = min(int(math.ceil(center + src_support)), n_in)
        idx = np.arange(left, right)
        vals = kernel((idx + 0.5 - center) / filter_scale)
        s = vals.sum()
        if s != 0.0:
            vals = vals / s
        else:  # degenerate window — nearest neighbor
            vals = np.zeros(len(idx))
            vals[np.argmin(np.abs(idx + 0.5 - center))] = 1.0
        w[out, left:right] = vals
    return w.astype(np.float32)


def resize_dimensions(w: int, h: int, nw: int, nh: int, fill: bool) -> tuple:
    """Aspect-preserving target size (image crate ``resize_dimensions``).

    fill=False: largest size fitting WITHIN nw×nh; fill=True: smallest size
    COVERING nw×nh.  Both round and clamp to >= 1.
    """
    wratio = nw / w
    hratio = nh / h
    ratio = max(wratio, hratio) if fill else min(wratio, hratio)
    # f64::round rounds half AWAY from zero; Python's round() is banker's
    # (half-to-even) and diverges on exact .5 products (e.g. 5 px at ratio
    # 0.5 → Rust 3, banker's 2), changing thumbnail/phash geometry.
    out_w = max(1, int(math.floor(w * ratio + 0.5)))
    out_h = max(1, int(math.floor(h * ratio + 0.5)))
    # The image crate caps at u32::MAX; irrelevant here.
    return out_w, out_h


def resize_np(
    img: np.ndarray, out_w: int, out_h: int, filter_name: str
) -> np.ndarray:
    """Resize HxWxC (or HxW) float/uint8 image to out_h x out_w, f32 result.

    Matches the image crate's two-pass order (vertical sample then
    horizontal, both in f32) without clamping — callers round/clamp when
    converting back to u8.
    """
    x = np.asarray(img, dtype=np.float32)
    h, w = x.shape[:2]
    wv = resample_weights(h, out_h, filter_name)  # [out_h, h]
    wh = resample_weights(w, out_w, filter_name)  # [out_w, w]
    # Two dense matmuls (vertical then horizontal) beat one 3-operand
    # einsum by a wide margin in numpy.
    if x.ndim == 2:
        return (wv @ x) @ wh.T
    tmp = np.tensordot(wv, x, axes=(1, 0))   # [out_h, w, c]
    out = np.tensordot(tmp, wh, axes=(1, 1)) # [out_h, c, out_w]
    return np.moveaxis(out, 1, 2)


def box_downsample_np(img: np.ndarray, factor: int) -> np.ndarray:
    """Exact integer-factor box filter (mean pooling), f32 result.

    Used as a pre-reduction before small dense resamples: a box pre-filter
    followed by the target filter closely approximates direct resampling
    at large shrink ratios while being ~50× cheaper.
    """
    x = np.asarray(img, dtype=np.float32)
    h, w = x.shape[:2]
    h2, w2 = (h // factor) * factor, (w // factor) * factor
    x = x[:h2, :w2]
    if x.ndim == 2:
        return x.reshape(h2 // factor, factor, w2 // factor, factor).mean((1, 3))
    return x.reshape(h2 // factor, factor, w2 // factor, factor, -1).mean((1, 3))


_NATIVE_FILTERS = {"triangle": 0, "gaussian": 1}


def resize_native(
    img: np.ndarray, out_w: int, out_h: int, filter_name: str = "triangle"
):
    """C++ separable resample (same weight definition as resample_weights);
    returns None when the native library isn't available."""
    import ctypes

    from pixelbox_tpu_torch.native import load_native

    lib = load_native()
    if lib is None or not hasattr(lib, "px_resize"):
        return None
    filt = _NATIVE_FILTERS.get(filter_name)
    if filt is None:
        return None
    x = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    h, w, ch = x.shape
    dst = np.empty((out_h, out_w, ch), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.px_resize(
        x.ctypes.data_as(u8p), w, h, ch,
        dst.ctypes.data_as(u8p), out_w, out_h, filt,
    )
    return dst[:, :, 0] if squeeze else dst


def resize_fast(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Fastest available antialiased triangle resize, u8 out: native C++
    when built, else PIL's SIMD resampler."""
    out = resize_native(img, out_w, out_h, "triangle")
    if out is not None:
        return out
    return resize_pil(img, out_w, out_h)


def resize_pil(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Fast antialiased triangle resize via PIL's SIMD resampler, u8 out.

    PIL's BILINEAR with default antialiasing implements the same
    scale-aware triangle kernel as the image crate's Triangle filter, in
    optimized C — the host ingest hot path uses this; the numpy matmul
    path remains the exactness reference.
    """
    from PIL import Image

    x = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
    return np.asarray(
        Image.fromarray(x).resize((out_w, out_h), Image.BILINEAR)
    )


def resize_preserve_aspect_np(
    img: np.ndarray, nw: int, nh: int, filter_name: str
) -> np.ndarray:
    """image crate ``resize``: aspect-preserving fit within nw×nh."""
    h, w = img.shape[:2]
    out_w, out_h = resize_dimensions(w, h, nw, nh, fill=False)
    return resize_np(img, out_w, out_h, filter_name)


def resize_to_fill_np(
    img: np.ndarray, nw: int, nh: int, filter_name: str = "triangle"
) -> np.ndarray:
    """image crate ``resize_to_fill``: cover nw×nh then center-crop.

    Matches efficientnet.rs:20's preprocessing geometry.
    """
    h, w = img.shape[:2]
    out_w, out_h = resize_dimensions(w, h, nw, nh, fill=True)
    big = resize_np(img, out_w, out_h, filter_name)
    # Center crop (image crate crops with top-left at the rounded center).
    x0 = (out_w - nw) // 2
    y0 = (out_h - nh) // 2
    return big[y0 : y0 + nh, x0 : x0 + nw]


# Luma coefficients used by the image crate's grayscale (Rec.709 primaries
# applied directly to the stored sRGB values).
SRGB_LUMA = np.array([0.2126, 0.7152, 0.0722], dtype=np.float32)


def grayscale_np(rgb: np.ndarray) -> np.ndarray:
    """HxWx3 (u8 or float) → HxW f32 luma, matching image crate weighting."""
    return np.asarray(rgb, dtype=np.float32) @ SRGB_LUMA


def to_u8(x: np.ndarray) -> np.ndarray:
    """f32 → u8 with round-half-away and clamp (image crate NumCast behavior)."""
    return np.clip(np.floor(x + 0.5), 0.0, 255.0).astype(np.uint8)
