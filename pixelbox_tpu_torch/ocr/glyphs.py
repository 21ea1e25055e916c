"""Glyph template atlas for the OCR recognizer.

Characters render once per (font, face) from the system DejaVu family at
a large point size, crop to their ink bounding box, normalize to a 16×16
zero-mean unit-norm patch, and stack into a template matrix whose rows
make the classification matmul compute normalized cross-correlation
directly (ocr/recognize.py).  Built lazily and cached per process.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import List, Tuple

import numpy as np

PATCH = 16
#: Recognized alphabet.  Characters whose 16×16 normalized patches are
#: near-identical across case (c/o/s/u/v/w/x/z...) resolve by vote of the
#: best-matching template; output is matched case-insensitively anyway
#: (the ocr: operator LIKE-matches, and SQLite LIKE is case-insensitive
#: for ASCII).
ALPHABET = (
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz"
    "0123456789"
    ".,:;!?-+=()[]/'\"%&@#$*"
)

_FONT_DIR = "/usr/share/fonts/truetype/dejavu"
_FONT_FILES = (
    "DejaVuSans.ttf",
    "DejaVuSans-Bold.ttf",
    "DejaVuSerif.ttf",
    "DejaVuSansMono.ttf",
)
_RENDER_PT = 64


def normalize_patch(crop: np.ndarray) -> np.ndarray:
    """Ink crop (f32, ink-positive) → flat zero-mean unit-norm [PATCH²].

    The crop pads to a SQUARE canvas (centered, small margin) before the
    16×16 resize: stretching would turn thin glyphs (l, I, 1, |) into
    near-constant blocks whose zero-mean patch vanishes, and it destroys
    the aspect cues separating them.  Shared by templates and
    recognition crops — identical normalization is what makes the
    template product a correlation coefficient.
    """
    from PIL import Image

    h, w = crop.shape
    side = max(h, w)
    margin = max(1, side // 8)
    canvas = np.zeros((side + 2 * margin, side + 2 * margin), np.float32)
    y0 = margin + (side - h) // 2
    x0 = margin + (side - w) // 2
    canvas[y0 : y0 + h, x0 : x0 + w] = crop
    img = Image.fromarray(
        np.clip(canvas * 255.0, 0, 255).astype(np.uint8)
    ).resize((PATCH, PATCH), Image.BILINEAR)
    v = np.asarray(img, dtype=np.float32).reshape(-1) / 255.0
    v = v - v.mean()
    n = np.linalg.norm(v)
    if n < 1e-6:
        return np.zeros(PATCH * PATCH, np.float32)
    return (v / n).astype(np.float32)


#: Confusion classes for SEARCH matching: shapes classical template OCR
#: cannot reliably separate fold to one representative, applied to both
#: the stored fold-tag and the ocr: query, so "ocr:invoice" finds an
#: image recognized as "lnvo1ce".
_FOLD = str.maketrans({
    "1": "l", "i": "l", "|": "l", "!": "l",
    "0": "o",
    "5": "s",
    "8": "b",
    "2": "z",
    "9": "g", "q": "g",
})


def fold_text(text: str) -> str:
    """Lowercase + confusion-class folding (see _FOLD)."""
    return text.lower().translate(_FOLD)


def _render_glyph(font, ch: str) -> np.ndarray | None:
    from PIL import Image, ImageDraw

    size = _RENDER_PT * 2
    img = Image.new("L", (size, size), 0)
    draw = ImageDraw.Draw(img)
    draw.text((size // 4, size // 4), ch, fill=255, font=font)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    ys, xs = np.nonzero(arr > 0.25)
    if len(ys) == 0:
        return None
    crop = arr[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
    return crop


@lru_cache(maxsize=1)
def glyph_atlas() -> Tuple[np.ndarray, str, np.ndarray]:
    """(templates [n, PATCH²] f32, labels string, aspect [n] f32).

    ``labels[i]`` is the character of template row i; ``aspect`` is the
    glyph's ink h/w ratio (a cheap shape prior the classifier combines
    with correlation to separate look-alikes at different aspect).
    """
    from PIL import ImageFont

    fonts = []
    for name in _FONT_FILES:
        path = os.path.join(_FONT_DIR, name)
        try:
            fonts.append(ImageFont.truetype(path, _RENDER_PT))
        except Exception:
            continue
    if not fonts:
        fonts = [ImageFont.load_default()]

    rows: List[np.ndarray] = []
    labels: List[str] = []
    aspects: List[float] = []
    for font in fonts:
        for ch in ALPHABET:
            crop = _render_glyph(font, ch)
            if crop is None:
                continue
            rows.append(normalize_patch(crop))
            labels.append(ch)
            aspects.append(crop.shape[0] / max(1, crop.shape[1]))
    return (
        np.stack(rows).astype(np.float32),
        "".join(labels),
        np.asarray(aspects, np.float32),
    )
