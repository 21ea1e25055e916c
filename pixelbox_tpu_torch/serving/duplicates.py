"""Near-duplicate finding over the whole index (torch port of
``serving/duplicates.py``, single device).

Batched index-vs-itself device scans (the reference's only dedup
affordance is manual per-image "find similar", search.rs:100): unique
near pairs under a strict distance cutoff, plus transitive groups.
``by="phash"`` runs the guaranteed-exact Hamming scan (uniform widths) or
the exact per-width-group scan (compat libraries); ``by="semantic"`` the
guaranteed-exact cosine scan — on an int4 library the int4 scan, its
candidates rescored with the exact u8 metric when ``int4_rerank`` is on.
Mesh serving is not yet ported.  Mixed into
:class:`pixelbox_tpu_torch.engine.Engine`.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from pixelbox_tpu_torch.ops.int4 import cosine4_scan_topk_auto
from pixelbox_tpu_torch.ops.scan import cosine_scan_topk_auto
from pixelbox_tpu_torch.serving.common import _read_locked
from pixelbox_tpu_torch.utils.timing import timed


class DuplicateFinding:
    @_read_locked
    def find_duplicate_pairs(
        self,
        max_distance: float = 0.1,
        k: int = 8,
        batch: int = 256,
        by: str = "phash",
    ) -> List[tuple]:
        """All near-duplicate image pairs across the whole index.

        Scans the index against itself in query batches on the device.
        ``by="phash"``: normalized Hamming over perceptual hashes with
        strict ``dist < max_distance`` (default 0.1 ≈ under 26 of 256
        bits differing).  ``by="semantic"``: reciprocal-cosine over the
        semantic index (guaranteed-exact auto scan; honors the
        library's int4 precision).

        Returns unique ``(id_a, id_b, dist)`` with ``id_a < id_b``,
        sorted by (dist, id_a, id_b).  Each image contributes at most
        ``k-1`` neighbors per direction (k includes the self-match) —
        raise ``k`` for heavily duplicated corpora.  Mixed-width compat
        phash libraries compare within same-true-width groups only
        (duplicate renders share geometry, so cross-aspect pairs are
        not duplicates).
        """
        assert by in ("phash", "semantic"), by
        if self.scan_mesh is not None:
            raise NotImplementedError(
                "mesh-sharded duplicate scans are not yet ported to pixelbox_tpu_torch"
            )
        if by == "phash":
            store, row_by_image, image_ids = (
                self._ph_store, self._ph_row_by_image, self._ph_image_ids,
            )
        else:
            store, row_by_image, image_ids = (
                self._sem_store, self._sem_row_by_image, self._sem_image_ids,
            )
        if store is None or store.size == 0:
            return []
        live_rows = np.asarray(sorted(row_by_image.values()), dtype=np.int64)

        # (group_rows, scan_fn(q_batch) -> (dist [B,k], idx [B,k]))
        groups = []
        if by == "phash":
            widths = np.asarray(self._ph_widths, dtype=np.int64)
            if bool(np.all(widths[live_rows] == store.dim)):
                def scan(qb):
                    return self._phash_gemm_scan(qb, k, max_distance)

                groups.append((live_rows, scan))
            else:
                from pixelbox_tpu_torch.ops.fused_scan import build_hamming_meta
                from pixelbox_tpu_torch.ops.hamming_gemm import hamming_gemm_scan_topk

                index = store.device_index
                for w in np.unique(widths[live_rows]):
                    w = int(w)
                    if w == 0:
                        continue
                    rows = live_rows[widths[live_rows] == w]
                    mask = np.zeros(index.capacity, dtype=bool)
                    mask[rows] = True
                    meta = build_hamming_meta(index, mask)

                    def scan(qb, meta=meta, w=w):
                        d, i = hamming_gemm_scan_topk(
                            torch.from_numpy(qb), index, k=k,
                            max_distance=max_distance, meta=meta, byte_limit=w,
                        )
                        return d.cpu().numpy(), i.cpu().numpy()

                    groups.append((rows, scan))
        elif self.semantic_precision == "int4":
            index = store.device_index

            def base_scan(qb, c, md):
                return cosine4_scan_topk_auto(
                    torch.from_numpy(qb), index, k=c, max_distance=md,
                    sample=self._get_scan_sample(), meta=self._get_row_meta(),
                )

            if self.int4_rerank:
                # Candidates in the int4 metric (unbounded), pair distances
                # in the exact u8 metric — the distances int8 mode reports.
                def scan(qb):
                    return self._int4_scan_rerank(
                        lambda c, md: base_scan(qb, c, md), qb, k, max_distance
                    )
            else:
                def scan(qb):
                    d, i = base_scan(qb, k, max_distance)
                    return d.cpu().numpy(), i.cpu().numpy()

            groups.append((live_rows, scan))
        else:
            index = store.device_index

            def scan(qb):
                d, i = cosine_scan_topk_auto(
                    torch.from_numpy(qb), index, k=k, max_distance=max_distance,
                    sample=self._get_scan_sample(), row_meta=self._get_row_meta(),
                )
                return d.cpu().numpy(), i.cpu().numpy()

            groups.append((live_rows, scan))

        seen = set()
        out = []
        with timed("engine.duplicate_scan"):
            for rows, scan in groups:
                qrows = store.get_rows(rows)
                for s in range(0, len(rows), batch):
                    qb = qrows[s : s + batch]
                    dists, idxs = scan(qb)
                    for qi in range(len(qb)):
                        a = image_ids[int(rows[s + qi])]
                        for d, r in zip(dists[qi], idxs[qi]):
                            if r < 0:
                                break  # hits are sorted; -1 padding follows
                            b = image_ids[int(r)]
                            if b == a:
                                continue
                            key = (min(a, b), max(a, b))
                            if key in seen:
                                continue
                            seen.add(key)
                            out.append((key[0], key[1], float(d)))
        out.sort(key=lambda p: (p[2], p[0], p[1]))
        return out

    def find_duplicate_groups(self, **kwargs) -> List[List[int]]:
        """Connected components of :meth:`find_duplicate_pairs` — each
        group is a sorted list of mutually-near-duplicate image ids
        (transitively: A~B and B~C group A,B,C even if A,C are just
        past the cutoff).  Groups sorted by size desc, then first id."""
        parent: dict = {}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b, _ in self.find_duplicate_pairs(**kwargs):
            parent.setdefault(a, a)
            parent.setdefault(b, b)
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        groups: dict = {}
        for x in parent:
            groups.setdefault(find(x), []).append(x)
        out = [sorted(g) for g in groups.values()]
        out.sort(key=lambda g: (-len(g), g[0]))
        return out
