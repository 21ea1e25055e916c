"""Watched-directory polling (reference roadmap README.md:36; a copy of
``serving/watch.py`` with the port's imports).

A poll loop rather than inotify: no extra dependency, works on network
filesystems, and re-uses the idempotent-by-path pipeline, so a spurious
trigger costs one cheap skip pass.  Adds the deletion half the roadmap
item implies: files that vanish from watched folders tombstone their
rows (with a verify-gone double check so transient IO errors can't
mass-delete a library).  Mixed into
:class:`pixelbox_tpu_torch.engine.Engine`.
"""

from __future__ import annotations

from typing import Optional

import sys
import threading


class WatchMixin:
    # ------------------------------------------------------------------ #
    # Watched directories (reference roadmap README.md "Watched
    # directories via notify crate" — never built there).  A poll loop
    # rather than inotify: it needs no extra dependency, works on network
    # filesystems, and re-uses the idempotent-by-path pipeline, so a
    # spurious trigger costs one cheap skip pass.

    def watch(
        self, interval_s: float = 30.0, num_workers: Optional[int] = None
    ) -> None:
        """Start a background watcher: poll tracked folders and index any
        file the catalog doesn't know yet.  Idempotent; stop with
        :meth:`stop_watching` (close() stops it too)."""
        if self._watcher is not None and self._watcher.is_alive():
            return
        # The loop closes over ITS OWN stop event: if stop_watching()'s
        # bounded join times out (watcher mid-ingest) and a new watcher
        # starts later, the old loop still sees its own (set) event and
        # exits instead of adopting the new watcher's unset one.
        stop = threading.Event()
        self._watch_stop = stop
        self.watch_passes = 0  # observability (tests/status surface)
        self.watch_removals = 0  # files deleted on disk → tombstoned here
        self._watch_pending_compact = 0
        # Paths that survived an indexing pass without landing in the
        # catalog (undecodable files): remembered so they don't re-trigger
        # a pass every interval forever.  Cleared per watch() call — a
        # watcher restart retries them.
        failed: set = set()

        def _known_paths() -> set:
            conn = self.catalog._connect()
            return {r[0] for r in conn.execute("SELECT path FROM images")}

        def _scan_pass():
            """One crawl: (new paths to index, present-path set)."""
            from pixelbox_tpu_torch.ingest.crawler import crawl
            from pixelbox_tpu_torch.ingest.decode import stringify_filepath

            known = _known_paths()
            news = []
            present = set()
            for p in crawl(self.get_tracked_folders()):
                sp = stringify_filepath(p)
                present.add(sp)
                if sp not in known and sp not in failed:
                    news.append(sp)
                if stop.is_set():
                    return [], set()
            return news, present

        def _verify_gone(path: str) -> bool:
            """Double-check a crawl-missing path is REALLY gone before
            tombstoning — a transient glob/IO error during the crawl must
            not mass-delete a library.  Only a definitive
            FileNotFoundError counts as gone: EACCES/ESTALE/IO errors (an
            unreachable mount stats like this) are NOT deletion."""
            import os

            from pixelbox_tpu_torch.ingest.decode import split_zip_path

            def _stat_gone(p: str) -> bool:
                try:
                    os.stat(p)
                    return False
                except (FileNotFoundError, NotADirectoryError):
                    return True
                except OSError:
                    return False  # unreachable ≠ deleted

            zp = split_zip_path(path)
            if zp is None:
                return _stat_gone(path)
            zpath, member = zp
            if _stat_gone(zpath):
                return True
            try:
                import zipfile

                with zipfile.ZipFile(zpath) as zf:
                    return member not in zf.namelist()
            except Exception:
                return False  # unreadable archive ≠ deleted members

        def _sync_deletions(present: set) -> None:
            """Tombstone rows whose files vanished from watched folders —
            the other half of the reference's 'Watched directories'
            roadmap item (README.md:36): a watcher that only ADDS leaves
            the index lying about deleted files forever.  Rows outside
            every tracked folder are untouched (that's
            remove-folder --purge's job)."""
            import os

            # Only roots that are REACHABLE right now participate: a
            # folder on an unmounted drive must not mass-tombstone its
            # rows (the crawl silently yields nothing for a missing
            # root, so without this check every row under it would look
            # deleted).
            roots = tuple(
                os.path.realpath(f) + os.sep
                for f in self.get_tracked_folders()
                if os.path.isdir(f)
            )
            if not roots:
                return
            conn = self.catalog._connect()
            rows = conn.execute("SELECT id, path FROM images").fetchall()
            removed = 0
            for image_id, path in rows:
                if stop.is_set():
                    break
                if not path.startswith(roots):
                    continue
                if path in present or not _verify_gone(path):
                    continue
                if self.remove_image(int(image_id)):
                    removed += 1
            if removed:
                self.watch_removals += removed
                self._watch_pending_compact += removed
                failed.clear()  # a delete/re-add cycle must retry cleanly
                # Reclaim device rows once tombstones pile up.
                if self._watch_pending_compact >= max(
                    16, self.get_num_indexed_images() // 100
                ):
                    self.compact()
                    self._watch_pending_compact = 0

        def _loop() -> None:
            while not stop.wait(interval_s):
                try:
                    if self.is_indexing_active():
                        continue
                    news, present = _scan_pass()
                    if news:
                        self.start_indexing(num_workers=num_workers)
                        self.wait_for_indexing()
                        still_missing = set(news) - _known_paths()
                        failed.update(still_missing)
                    if present or self.get_tracked_folders():
                        _sync_deletions(present)
                    self.watch_passes += 1
                except Exception as e:  # noqa: BLE001 — keep watching
                    print(f"watch: {type(e).__name__}: {e}", file=sys.stderr)

        self._watcher = threading.Thread(
            target=_loop, name="pixelbox-watch", daemon=True
        )
        self._watcher.start()

    def is_watching(self) -> bool:
        return self._watcher is not None and self._watcher.is_alive()

    def stop_watching(self) -> None:
        if self._watcher is None:
            return
        self._watch_stop.set()
        self._watcher.join(timeout=10)
        self._watcher = None
