"""Bit-exact u8 embedding quantization (torch port of ``ops/quantize.py``).

The reference quantizes each f32 embedding component to a byte via

    128u8.saturating_add_signed((f*128.0).max(-128.0).min(128.0) as i8)

(reference src/image_hashes/efficientnet.rs:39).  Rust's ``as i8`` float→int
cast truncates toward zero, saturates to [-128, 127], and maps NaN to 0, so
the full mapping is::

    q(f) = 128 + clamp(trunc(clamp(f*128, -128, 128)), -128, 127)   (NaN → 128)

e.g. +1.0 → 255, -1.0 → 0, 0.0 → 128, 0.999 → 255 (127.87 truncates to 127).

Dequantization matches the reference's distance-side mapping
``(v/255)*2 - 1`` (reference src/engine.rs:575-577).
"""

from __future__ import annotations

import torch


def quantize_embedding(x: torch.Tensor) -> torch.Tensor:
    """Quantize f32 embeddings to u8, bit-exact with the reference Rust cast.

    Works on any shape; elementwise; computed in f32."""
    xf = torch.as_tensor(x).to(torch.float32)
    scaled = torch.clamp(xf * 128.0, -128.0, 128.0)
    # Rust `as i8`: truncate toward zero, saturate, NaN→0.
    as_i8 = torch.clamp(torch.trunc(scaled), -128.0, 127.0)
    as_i8 = torch.where(torch.isnan(xf), torch.zeros_like(as_i8), as_i8)
    return (as_i8 + 128.0).to(torch.uint8)


def dequantize_embedding(q: torch.Tensor) -> torch.Tensor:
    """Map u8 back to [-1, 1] floats: ``(q/255)*2 - 1`` (engine.rs:575-577)."""
    qf = torch.as_tensor(q).to(torch.float32)
    return (qf / torch.full_like(qf, 255.0)) * 2.0 - 1.0


def center_u8(q: torch.Tensor) -> torch.Tensor:
    """Map u8 → int32 ``2*q - 255`` (an exact integer multiple of the
    dequantized value: ``dequantize(q) == center_u8(q) / 255``)."""
    return 2 * torch.as_tensor(q).to(torch.int32) - 255
