"""Host-side image decode + EXIF extraction (PIL).

Decode mirrors the reference's per-file work (src/indexed_image.rs:47-91):
guessed-format decode, EXIF tag map, 256×256 QOI thumbnail, both hashes —
except hashes here are computed in device batches by the pipeline, so this
module only produces the decoded RGB array + metadata.

Supported extensions replicate the crawler's list (src/crawler.rs:7).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

# src/crawler.rs:7 — matched case-insensitively.
SUPPORTED_IMAGE_EXTENSIONS = (
    "png", "bmp", "jpg", "jpeg", "jfif", "gif", "tiff", "pnm",
    "webp", "ico", "tga", "exr",
)


def is_supported_image(path: str) -> bool:
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    return ext in SUPPORTED_IMAGE_EXTENSIONS


@dataclass
class DecodedImage:
    filename: str
    path: str
    rgb: np.ndarray  # HxWx3 uint8
    resolution: Tuple[int, int]  # (width, height) of the ORIGINAL image
    tags: Dict[str, str] = field(default_factory=dict)


def extract_exif_tags(pil_img) -> Dict[str, str]:
    """EXIF → {tag name: display value}, like kamadak-exif's field list
    (reference src/indexed_image.rs:60-67)."""
    tags: Dict[str, str] = {}
    try:
        from PIL.ExifTags import TAGS, GPSTAGS

        exif = pil_img.getexif()
        if exif is None:
            return tags
        for tag_id, value in exif.items():
            name = TAGS.get(tag_id, f"Tag{tag_id}")
            tags[str(name)] = _display_value(value)
        # IFD sub-blocks (Exif, GPS) — PIL keeps them separate.
        try:
            from PIL.Image import ExifTags as _ET  # noqa: F401
        except Exception:
            pass
        for ifd_id in (0x8769, 0x8825):  # ExifIFD, GPSIFD
            try:
                ifd = exif.get_ifd(ifd_id)
            except Exception:
                continue
            table = GPSTAGS if ifd_id == 0x8825 else TAGS
            for tag_id, value in ifd.items():
                name = table.get(tag_id, f"Tag{tag_id}")
                tags[str(name)] = _display_value(value)
    except Exception:
        pass
    return tags


def _display_value(value) -> str:
    if isinstance(value, bytes):
        try:
            return value.decode("utf-8", "replace").strip("\x00 ")
        except Exception:
            return value.hex()
    return str(value)


#: Decode-time downscale floor: JPEG/WEBP decode at the smallest
#: DCT/scaler factor keeping min(w, h) >= this (0 = always full size).
#: Every ingest consumer (256 thumbnail, 224 embed frame, 16x16 phash)
#: needs far less than full resolution; query and ingest share this
#: policy so a drag-dropped indexed file still self-matches exactly.
DECODE_MIN_DIM = int(os.environ.get("PIXELBOX_DECODE_MIN_DIM", "448"))


def _native_decode(data: bytes, min_dim: int):
    """C++ decode (libjpeg/libpng/libwebp) → (rgb, (full_w, full_h)) or
    None when the native library / format isn't available."""
    import ctypes

    from pixelbox_tpu_torch.native import load_native

    lib = load_native()
    if lib is None or not hasattr(lib, "px_decode_rgb"):
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) == 0:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    src = buf.ctypes.data_as(u8p)
    fw, fh, sw, sh = (ctypes.c_uint32() for _ in range(4))
    if lib.px_decode_header(
        src, len(buf), min_dim,
        ctypes.byref(fw), ctypes.byref(fh), ctypes.byref(sw), ctypes.byref(sh),
    ) != 0:
        return None
    out = np.empty(int(sh.value) * int(sw.value) * 3, dtype=np.uint8)
    ow, oh = ctypes.c_uint32(), ctypes.c_uint32()
    if lib.px_decode_rgb(
        src, len(buf), min_dim,
        out.ctypes.data_as(u8p), len(out), ctypes.byref(ow), ctypes.byref(oh),
    ) != 0:
        return None
    rgb = out[: int(oh.value) * int(ow.value) * 3].reshape(
        int(oh.value), int(ow.value), 3
    )
    return rgb, (int(fw.value), int(fh.value))


def decode_image_bytes(
    data: bytes, filename: str, path: str, min_dim: Optional[int] = None
) -> Optional[DecodedImage]:
    """Decode from memory (guessed format, like indexed_image.rs:53).

    Prefers the native C++ decoders (with decode-time downscaling for
    JPEG/WEBP — see ``DECODE_MIN_DIM``); EXIF still comes from PIL's lazy
    open, which reads metadata without touching the raster.  Formats the
    native path doesn't cover (GIF, TIFF, …) and any native failure fall
    back to the full PIL decode.
    """
    md = DECODE_MIN_DIM if min_dim is None else min_dim
    try:
        native = _native_decode(data, md)
    except Exception:
        native = None
    if native is not None:
        rgb, (width, height) = native
        tags: Dict[str, str] = {}
        try:
            from PIL import Image

            with Image.open(io.BytesIO(data)) as im:  # lazy: header only
                tags = extract_exif_tags(im)
        except Exception:
            pass
        return DecodedImage(
            filename=filename, path=path, rgb=rgb,
            resolution=(width, height), tags=tags,
        )
    try:
        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            width, height = im.size
            tags = extract_exif_tags(im)
            if md > 0 and im.format == "JPEG":
                # Same DCT downscale policy as the native decoder (PIL's
                # draft() uses libjpeg's scaler), so a host without the
                # native build still produces IDENTICAL pixels — hashes
                # must not depend on which decoder was available.
                denom = 1
                while denom < 8 and min(width, height) // (denom * 2) >= md:
                    denom *= 2
                if denom > 1:
                    im.draft("RGB", (-(-width // denom), -(-height // denom)))
            im.load()
            rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
        return DecodedImage(
            filename=filename, path=path, rgb=rgb,
            resolution=(width, height), tags=tags,
        )
    except Exception:
        # Per-file decode failures are skipped, matching crawler.rs:78-80.
        return None


#: Pseudo-path separator for images inside zip archives (reference
#: roadmap "Index inside of zip files", README.md TODOs):
#: ``/photos/a.zip!/sub/cat.png`` names member ``sub/cat.png`` of the
#: archive — jar-URL style, unambiguous because ``!`` never follows
#: ``.zip`` in a real directory hierarchy the crawler produces.
ZIP_SEP = "!/"


def split_zip_path(path: str) -> Optional[Tuple[str, str]]:
    """``a.zip!/member`` → (archive path, member name); None otherwise."""
    i = path.lower().find(".zip" + ZIP_SEP)
    if i < 0:
        return None
    return path[: i + 4], path[i + 4 + len(ZIP_SEP):]


def read_file_bytes(path: str) -> Optional[bytes]:
    """Read a plain file OR a zip member pseudo-path."""
    zp = split_zip_path(path)
    if zp is not None:
        import zipfile

        zpath, member = zp
        try:
            with zipfile.ZipFile(zpath) as zf:
                return zf.read(member)
        except (OSError, KeyError, zipfile.BadZipFile):
            return None
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def decode_image_file(path: str) -> Optional[DecodedImage]:
    data = read_file_bytes(path)
    if data is None:
        return None
    return decode_image_bytes(data, os.path.basename(path), stringify_filepath(path))


def stringify_filepath(path: str) -> str:
    """Canonical path string (reference src/indexed_image.rs:101-103).

    Zip-member pseudo-paths canonicalize the ARCHIVE part only (the
    member name is already canonical within the archive)."""
    zp = split_zip_path(path)
    if zp is not None:
        zpath, member = zp
        return stringify_filepath(zpath) + ZIP_SEP + member
    try:
        return os.path.realpath(path)
    except OSError:
        return os.path.abspath(path)
