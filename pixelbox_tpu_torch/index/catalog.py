"""Host-side SQLite catalog — image metadata, tags, tracked folders.

Keeps the reference's exact schema (src/engine.rs:31-48): ``images``,
``tags``, ``watched_directories``, and the two hash tables created from one
template (``phashes`` / ``semantic_hashes``), so an existing pixelbox
database opens unchanged.  The difference is the division of labor: the
reference also *computes* in SQLite (scalar distance UDFs scanned per row,
engine.rs:608-663); here SQLite only stores metadata + durable hash blobs,
and all distance compute happens on device over the packed stores.  The
distance UDFs are still registered (same names/semantics) so ad-hoc SQL
queries against the DB keep working.

Durability semantics match the reference: WAL journaling (engine.rs:122),
``INSERT OR IGNORE`` with ``UNIQUE(path)`` making re-indexing idempotent
(engine.rs:40, 231), separate read-only connections for queries
(engine.rs:119-120).
"""

from __future__ import annotations

import sqlite3
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pixelbox_tpu_torch.ops import oracle

# Schemas from reference src/engine.rs:31-48, with ONE divergence: the
# images id is AUTOINCREMENT so removed-image ids are never recycled
# (SQLite reuses a deleted max rowid otherwise; the reference never
# implemented removal so it never hit this — with removal, a recycled id
# resurrects stale references like cached thumbnails).  Reference-made
# DBs (plain INTEGER PRIMARY KEY) still open unchanged.
IMAGE_SCHEMA_V1 = """CREATE TABLE images (
    id               INTEGER PRIMARY KEY AUTOINCREMENT,
    filename         TEXT NOT NULL,
    path             TEXT NOT NULL,
    image_width      INTEGER,
    image_height     INTEGER,
    thumbnail        BLOB,
    created          DATETIME,
    indexed          DATETIME,
    UNIQUE(path)
)"""
TAG_SCHEMA_V1 = """CREATE TABLE tags (
    image_id        INTEGER,
    name            TEXT NOT NULL,
    value           TEXT
)"""
WATCHED_DIRECTORIES_SCHEMA_V1 = (
    "CREATE TABLE watched_directories (glob TEXT PRIMARY KEY)"
)
HASH_TABLE_SCHEMA_V1 = (
    "CREATE TABLE {tablename} (image_id INTEGER PRIMARY KEY, hash BLOB)"
)


def _register_distance_udfs(conn: sqlite3.Connection) -> None:
    """Register the reference's three distance UDFs (engine.rs:608-663)."""

    def cosine_distance(a: bytes, b: bytes) -> float:
        return float(
            oracle.cosine_distance_np(
                np.frombuffer(a, dtype=np.uint8), np.frombuffer(b, dtype=np.uint8)
            )
        )

    def byte_distance(a: bytes, b: bytes) -> float:
        return float(
            oracle.byte_distance_np(
                np.frombuffer(a, dtype=np.uint8), np.frombuffer(b, dtype=np.uint8)
            )
        )

    def hamming_distance(a: bytes, b: bytes) -> float:
        # Zip-truncate semantics for unequal widths (engine.rs:594-604):
        # aspect-preserving compat phashes vary in byte length.
        return float(oracle.hamming_distance_zip_np(a, b))

    conn.create_function("cosine_distance", 2, cosine_distance, deterministic=True)
    conn.create_function("byte_distance", 2, byte_distance, deterministic=True)
    conn.create_function("hamming_distance", 2, hamming_distance, deterministic=True)


class Catalog:
    """SQLite-backed metadata catalog with the reference schema."""

    def __init__(self, db_path: str, create: bool = False):
        self.db_path = str(db_path)
        exists = Path(self.db_path).exists() or self.db_path == ":memory:"
        if create and self.db_path != ":memory:" and not Path(self.db_path).exists():
            exists = False
        self._local = threading.local()
        self._lock = threading.Lock()
        conn = self._connect()
        if create or not exists:
            self._create_schema(conn)
        conn.execute("PRAGMA journal_mode=WAL")

    # ------------------------------------------------------------------ #

    def _connect(self) -> sqlite3.Connection:
        """Per-thread connection (sqlite3 objects are thread-bound)."""
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.db_path, timeout=30.0)
            conn.execute("PRAGMA journal_mode=WAL")
            # WAL + NORMAL: no fsync per commit (durability to the WAL,
            # same crash-consistency class the reference relies on).
            conn.execute("PRAGMA synchronous=NORMAL")
            _register_distance_udfs(conn)
            self._local.conn = conn
        return conn

    @staticmethod
    def _create_schema(conn: sqlite3.Connection) -> None:
        cur = conn.cursor()
        for schema in (IMAGE_SCHEMA_V1, WATCHED_DIRECTORIES_SCHEMA_V1, TAG_SCHEMA_V1):
            cur.execute(schema)
        # phashes / semantic_hashes from one template (engine.rs:106-109).
        cur.execute(HASH_TABLE_SCHEMA_V1.format(tablename="phashes"))
        cur.execute(HASH_TABLE_SCHEMA_V1.format(tablename="semantic_hashes"))
        conn.commit()

    # ------------------------------------------------------------------ #
    # Images

    def insert_image(
        self,
        filename: str,
        path: str,
        width: int,
        height: int,
        thumbnail: Optional[bytes] = None,
        tags: Optional[Dict[str, str]] = None,
        phash: Optional[bytes] = None,
        semantic_hash: Optional[bytes] = None,
    ) -> Optional[int]:
        """Idempotent insert (INSERT OR IGNORE on UNIQUE(path), engine.rs:228-259).

        Returns the image id, or None if the path was already indexed.
        """
        conn = self._connect()
        with self._lock:
            cur = conn.execute(
                "INSERT OR IGNORE INTO images (filename, path, image_width,"
                " image_height, thumbnail) VALUES (?, ?, ?, ?, ?)",
                (filename, path, width, height, thumbnail),
            )
            if cur.rowcount == 0:
                conn.commit()
                return None
            image_id = cur.lastrowid
            if tags:
                conn.executemany(
                    "INSERT OR IGNORE INTO tags (image_id, name, value) VALUES (?, ?, ?)",
                    [(image_id, k, v) for k, v in tags.items()],
                )
            if phash is not None:
                conn.execute(
                    "INSERT OR IGNORE INTO phashes (image_id, hash) VALUES (?, ?)",
                    (image_id, sqlite3.Binary(phash)),
                )
            if semantic_hash is not None:
                conn.execute(
                    "INSERT OR IGNORE INTO semantic_hashes (image_id, hash) VALUES (?, ?)",
                    (image_id, sqlite3.Binary(semantic_hash)),
                )
            conn.commit()
            return image_id

    def insert_images_batch(self, rows: Sequence[dict]) -> List[Optional[int]]:
        """Insert many images in ONE transaction (the ingest writer's path:
        per-image commits fsync-bound the pipeline).  Each row dict has the
        same keys as :meth:`insert_image` arguments.  Returns ids (None for
        already-indexed paths)."""
        conn = self._connect()
        ids: List[Optional[int]] = []
        with self._lock:
            try:
                for r in rows:
                    cur = conn.execute(
                        "INSERT OR IGNORE INTO images (filename, path,"
                        " image_width, image_height, thumbnail)"
                        " VALUES (?, ?, ?, ?, ?)",
                        (
                            r["filename"], r["path"], r["width"], r["height"],
                            r.get("thumbnail"),
                        ),
                    )
                    if cur.rowcount == 0:
                        ids.append(None)
                        continue
                    image_id = cur.lastrowid
                    tags = r.get("tags")
                    if tags:
                        conn.executemany(
                            "INSERT OR IGNORE INTO tags (image_id, name, value)"
                            " VALUES (?, ?, ?)",
                            [(image_id, k, v) for k, v in tags.items()],
                        )
                    if r.get("phash") is not None:
                        conn.execute(
                            "INSERT OR IGNORE INTO phashes (image_id, hash)"
                            " VALUES (?, ?)",
                            (image_id, sqlite3.Binary(r["phash"])),
                        )
                    if r.get("semantic_hash") is not None:
                        conn.execute(
                            "INSERT OR IGNORE INTO semantic_hashes"
                            " (image_id, hash) VALUES (?, ?)",
                            (image_id, sqlite3.Binary(r["semantic_hash"])),
                        )
                    ids.append(image_id)
                conn.commit()
            except Exception:
                conn.rollback()
                raise
        return ids

    def get_image(self, image_id: int) -> Optional[dict]:
        conn = self._connect()
        row = conn.execute(
            "SELECT id, filename, path, image_width, image_height, thumbnail"
            " FROM images WHERE id = ?",
            (image_id,),
        ).fetchone()
        if row is None:
            return None
        return self._image_rowdict(row)

    def get_images(self, image_ids: Sequence[int]) -> List[Optional[dict]]:
        return [self.get_image(i) for i in image_ids]

    def get_images_with_tags(self, image_ids: Sequence[int]) -> Dict[int, dict]:
        """Batched image+tags lookup: two IN-list queries total, replacing
        per-hit SELECT pairs (the reference assembles one JOIN with
        JSON_GROUP_OBJECT for the same reason, engine.rs:294-315).

        Returns {image_id: rowdict} with a ``"tags"`` dict per row; ids not
        found are absent.
        """
        conn = self._connect()
        out: Dict[int, dict] = {}
        ids = [int(i) for i in image_ids]
        # SQLite caps bound parameters (999 classically); chunk the IN list.
        for start in range(0, len(ids), 500):
            chunk = ids[start : start + 500]
            marks = ",".join("?" * len(chunk))
            for row in conn.execute(
                "SELECT id, filename, path, image_width, image_height,"
                f" thumbnail FROM images WHERE id IN ({marks})",
                chunk,
            ):
                d = self._image_rowdict(row)
                d["tags"] = {}
                out[d["id"]] = d
            for image_id, name, value in conn.execute(
                "SELECT image_id, name, value FROM tags WHERE image_id"
                f" IN ({marks})",
                chunk,
            ):
                if image_id in out:
                    out[image_id]["tags"][name] = value
        return out

    @staticmethod
    def _image_rowdict(row) -> dict:
        return {
            "id": row[0],
            "filename": row[1],
            "path": row[2],
            "resolution": (row[3], row[4]),
            "thumbnail": row[5],
        }

    def get_image_by_path(self, path: str) -> Optional[dict]:
        conn = self._connect()
        row = conn.execute(
            "SELECT id, filename, path, image_width, image_height, thumbnail"
            " FROM images WHERE path = ?",
            (path,),
        ).fetchone()
        return None if row is None else self._image_rowdict(row)

    def has_path(self, path: str) -> bool:
        conn = self._connect()
        return (
            conn.execute("SELECT 1 FROM images WHERE path = ?", (path,)).fetchone()
            is not None
        )

    def num_images(self) -> int:
        conn = self._connect()
        return conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]

    def get_tags(self, image_id: int) -> Dict[str, str]:
        conn = self._connect()
        return {
            name: value
            for name, value in conn.execute(
                "SELECT name, value FROM tags WHERE image_id = ?", (image_id,)
            )
        }

    def set_tag(self, image_id: int, name: str, value: str = "") -> None:
        """Set (or overwrite) a user tag — the reference's roadmap
        "Editable tags" item (README.md TODOs), never implemented there.

        The reference's tags table has no uniqueness constraint
        (engine.rs:41-46: EXIF inserts use INSERT OR IGNORE but duplicate
        (image_id, name) rows are possible); editing therefore deletes
        any existing rows for the name first so a tag has one value.
        """
        conn = self._connect()
        with self._lock:
            conn.execute(
                "DELETE FROM tags WHERE image_id = ? AND name = ?",
                (image_id, name),
            )
            conn.execute(
                "INSERT INTO tags (image_id, name, value) VALUES (?, ?, ?)",
                (image_id, name, value),
            )
            conn.commit()

    def remove_tag(self, image_id: int, name: str) -> bool:
        """Delete a tag by name; True if any row was removed."""
        conn = self._connect()
        with self._lock:
            cur = conn.execute(
                "DELETE FROM tags WHERE image_id = ? AND name = ?",
                (image_id, name),
            )
            conn.commit()
            return cur.rowcount > 0

    # ------------------------------------------------------------------ #
    # Hashes (durable mirror of the device stores)

    _HASH_TABLES = ("phashes", "semantic_hashes", "blip_hashes")

    def iter_hashes(self, table: str) -> Iterable[Tuple[int, bytes]]:
        assert table in self._HASH_TABLES, table
        conn = self._connect()
        if not self._table_exists(table):
            return
        yield from conn.execute(
            f"SELECT image_id, hash FROM {table} ORDER BY image_id"
        )

    def get_hash(self, table: str, image_id: int) -> Optional[bytes]:
        assert table in self._HASH_TABLES, table
        conn = self._connect()
        if not self._table_exists(table):
            return None
        row = conn.execute(
            f"SELECT hash FROM {table} WHERE image_id = ?", (image_id,)
        ).fetchone()
        return None if row is None else row[0]

    def _table_exists(self, table: str) -> bool:
        conn = self._connect()
        return (
            conn.execute(
                "SELECT 1 FROM sqlite_master WHERE type='table' AND name=?",
                (table,),
            ).fetchone()
            is not None
        )

    def ensure_aux_hash_table(self, table: str) -> None:
        """Create an additional hash table from the reference's template
        (engine.rs:48) — used for the BLIP text→image index, an additive
        extension to the reference schema."""
        assert table in self._HASH_TABLES, table
        conn = self._connect()
        with self._lock:
            if not self._table_exists(table):
                conn.execute(HASH_TABLE_SCHEMA_V1.format(tablename=table))
                conn.commit()

    def insert_hash(self, table: str, image_id: int, hash_bytes: bytes) -> None:
        assert table in self._HASH_TABLES, table
        conn = self._connect()
        with self._lock:
            conn.execute(
                f"INSERT OR IGNORE INTO {table} (image_id, hash) VALUES (?, ?)",
                (image_id, sqlite3.Binary(hash_bytes)),
            )
            conn.commit()

    # ------------------------------------------------------------------ #
    # Faces (additive table; reference roadmap "Face search", README.md:33).
    # Unlike the per-image hash tables, one image holds MANY faces, each
    # with its bounding box (normalized [0,1] coords) and its own
    # embedding row in the face device store.

    FACES_SCHEMA_V1 = """CREATE TABLE faces (
        id        INTEGER PRIMARY KEY AUTOINCREMENT,
        image_id  INTEGER NOT NULL,
        x0 REAL, y0 REAL, x1 REAL, y1 REAL,
        hash      BLOB
    )"""

    def ensure_faces_table(self) -> None:
        conn = self._connect()
        with self._lock:
            if not self._table_exists("faces"):
                conn.execute(self.FACES_SCHEMA_V1)
                conn.execute(
                    "CREATE INDEX faces_by_image ON faces (image_id)"
                )
                conn.commit()

    def insert_faces(
        self, image_id: int, faces: Sequence[Tuple[Tuple[float, float, float, float], bytes]]
    ) -> List[int]:
        """Insert (box, hash_bytes) rows for one image; returns face ids."""
        if not faces:
            return []
        self.ensure_faces_table()
        conn = self._connect()
        ids = []
        with self._lock:
            for (x0, y0, x1, y1), h in faces:
                cur = conn.execute(
                    "INSERT INTO faces (image_id, x0, y0, x1, y1, hash)"
                    " VALUES (?, ?, ?, ?, ?, ?)",
                    (
                        image_id,
                        float(x0), float(y0), float(x1), float(y1),
                        sqlite3.Binary(h),
                    ),
                )
                ids.append(int(cur.lastrowid))
            conn.commit()
        return ids

    def iter_faces(self) -> Iterable[Tuple[int, int, Tuple[float, float, float, float], bytes]]:
        """Yield (face_id, image_id, (x0,y0,x1,y1), hash) in face-id order."""
        if not self._table_exists("faces"):
            return
        conn = self._connect()
        for fid, img, x0, y0, x1, y1, h in conn.execute(
            "SELECT id, image_id, x0, y0, x1, y1, hash FROM faces ORDER BY id"
        ):
            yield fid, img, (x0, y0, x1, y1), h

    def get_faces(self, image_id: int) -> List[dict]:
        if not self._table_exists("faces"):
            return []
        conn = self._connect()
        return [
            {"id": fid, "image_id": image_id, "box": (x0, y0, x1, y1)}
            for fid, x0, y0, x1, y1 in conn.execute(
                "SELECT id, x0, y0, x1, y1 FROM faces WHERE image_id = ?"
                " ORDER BY id",
                (image_id,),
            )
        ]

    def num_faces(self) -> int:
        if not self._table_exists("faces"):
            return 0
        conn = self._connect()
        return int(conn.execute("SELECT COUNT(*) FROM faces").fetchone()[0])

    # ------------------------------------------------------------------ #
    # Framework settings (additive table; reference DBs gain it lazily)

    def set_setting(self, key: str, value: str) -> None:
        conn = self._connect()
        with self._lock:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS pixelbox_settings"
                " (key TEXT PRIMARY KEY, value TEXT)"
            )
            conn.execute(
                "INSERT INTO pixelbox_settings (key, value) VALUES (?, ?)"
                " ON CONFLICT(key) DO UPDATE SET value = excluded.value",
                (key, value),
            )
            conn.commit()

    def get_setting(self, key: str) -> Optional[str]:
        conn = self._connect()
        if not self._table_exists("pixelbox_settings"):
            return None
        row = conn.execute(
            "SELECT value FROM pixelbox_settings WHERE key = ?", (key,)
        ).fetchone()
        return None if row is None else row[0]

    # ------------------------------------------------------------------ #
    # Tracked folders (engine.rs:404-439)

    def add_tracked_folder(self, folder_glob: str) -> None:
        conn = self._connect()
        with self._lock:
            conn.execute(
                "INSERT OR IGNORE INTO watched_directories (glob) VALUES (?)",
                (folder_glob,),
            )
            conn.commit()

    def remove_tracked_folder(self, folder_glob: str) -> None:
        conn = self._connect()
        with self._lock:
            conn.execute(
                "DELETE FROM watched_directories WHERE glob = ?", (folder_glob,)
            )
            conn.commit()

    def get_tracked_folders(self) -> List[str]:
        conn = self._connect()
        return [r[0] for r in conn.execute("SELECT glob FROM watched_directories")]

    # ------------------------------------------------------------------ #

    def remove_image(self, image_id: int) -> None:
        """Delete an image row + its tags/hashes (the reference leaves
        this as a TODO at engine.rs:414)."""
        conn = self._connect()
        with self._lock:
            conn.execute("DELETE FROM images WHERE id = ?", (image_id,))
            conn.execute("DELETE FROM tags WHERE image_id = ?", (image_id,))
            for table in self._HASH_TABLES:
                if self._table_exists(table):
                    conn.execute(
                        f"DELETE FROM {table} WHERE image_id = ?", (image_id,)
                    )
            if self._table_exists("faces"):
                conn.execute("DELETE FROM faces WHERE image_id = ?", (image_id,))
            conn.commit()

    def filter_images(self, where_sql: str, params: Sequence) -> List[int]:
        """Image ids matching a parameterized WHERE over images⋈tags.

        Used by the text-query engine (``pixelbox_tpu_torch.query``); unlike the
        reference's string-interpolated LIKE clauses (engine.rs:543-560,
        acknowledged SQL-injectable), everything is bound as parameters.
        """
        conn = self._connect()
        sql = (
            "SELECT DISTINCT images.id FROM images"
            " LEFT JOIN tags ON images.id = tags.image_id"
            f" WHERE {where_sql} ORDER BY images.id"
        )
        return [r[0] for r in conn.execute(sql, tuple(params))]

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
