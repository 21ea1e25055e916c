"""Filesystem crawler: glob walk + extension filter.

Replicates the reference crawler's discovery semantics
(src/crawler.rs:35-65): each tracked folder glob gets ``/**/*.*`` appended,
matches are filtered to the 12 supported image extensions
(case-insensitive), and results stream to the decode pool.

The reference runs this on a dedicated thread feeding an unbounded channel
(crawler.rs:27); here it is a generator the pipeline drains from its own
walker thread — same topology, Python idiom.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Iterable, Iterator, List

from pixelbox_tpu_torch.ingest.decode import is_supported_image


def expand_folder_glob(folder: str) -> str:
    """Append ``/**/*.*`` like the reference (crawler.rs:36-40)."""
    return os.path.join(folder, "**", "*.*")


def zip_member_paths(zip_path: str) -> Iterator[str]:
    """Yield ``archive.zip!/member`` pseudo-paths for image members.

    Reference roadmap "Index inside of zip files" (README.md TODOs),
    never built there.  Unreadable/corrupt archives are skipped like
    per-file decode failures (crawler.rs:78-80 semantics).
    """
    import zipfile

    try:
        with zipfile.ZipFile(zip_path) as zf:
            names = zf.namelist()
    except (OSError, zipfile.BadZipFile):
        return
    from pixelbox_tpu_torch.ingest.decode import ZIP_SEP

    for name in names:
        if not name.endswith("/") and is_supported_image(name):
            yield zip_path + ZIP_SEP + name


def crawl(folders: Iterable[str]) -> Iterator[str]:
    """Yield supported image file paths under the tracked folder globs
    (plus image members of any .zip archives found there)."""
    for folder in folders:
        pattern = expand_folder_glob(folder)
        for path in globlib.iglob(pattern, recursive=True):
            if not os.path.isfile(path):
                continue
            if is_supported_image(path):
                yield path
            elif path.lower().endswith(".zip"):
                yield from zip_member_paths(path)


def crawl_list(folders: Iterable[str]) -> List[str]:
    return list(crawl(folders))
