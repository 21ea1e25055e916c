"""Thin web UI + JSON API over an Engine (torch port of ``serve.py``).

The reference's surface is an egui desktop app (src/main.rs, src/ui/*);
this is its server-side equivalent: a stdlib HTTP server exposing text
search (search.rs:40-49), search-by-image upload (drag-and-drop,
search.rs:28-31), find-similar per result (search.rs:100), thumbnails
(ui/mod.rs:50-59), folder management + reindex (folders.rs) and settings
(settings.rs:9-20) as JSON endpoints plus a minimal HTML front end.
Concurrent similarity requests coalesce into device batches through
``serving.BatchingScanService`` (one scan per modality and bucket).

Endpoints:
  GET  /                      HTML UI
  GET  /api/search?q=...      text query results (offset/limit)
  POST /api/similar           image bytes → similarity results
  GET  /api/similar?id=N      find-similar on an indexed image
  POST /api/phash-similar     image bytes → perceptual-hash results
  GET  /api/thumbnail?id=N    PNG thumbnail
  GET  /api/image?id=N        the original file
  GET  /api/results           page through the cached results
  GET  /api/duplicates        near-duplicate pairs or groups
  GET  /api/folders           tracked folders
  POST /api/folders/add       {"folder": path}
  POST /api/folders/remove    {"folder": path, "purge": bool}
  POST /api/remove            {"id": N}
  POST /api/reindex           start indexing
  POST /api/stop              stop indexing
  POST /api/tag, /api/untag   {"id": N, "name": ..., "value": ...}
  POST /api/watch             {"interval": S} or {"stop": true}
  GET  /api/status            index size, indexing state, settings
  POST /api/settings          {"max_search_results": N, "max_distance": X, ...}

Not yet ported, answered with 501: ``/api/faces``, ``/api/face-similar``,
``text:`` and ``face:`` queries.  Under ``scan_mode: ivf`` similarity
requests coalesce under the service's own ``ivf`` kind (the clustered
index's probed result set, not the exact scan's).
A request thread's error reaches the client as 500; nothing falls back
to the CPU or to a plain version when the card or a kernel fails.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
import urllib.parse
import zipfile
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from pixelbox_tpu_torch.ingest.decode import split_zip_path
from pixelbox_tpu_torch.ingest.thumbnail import qoi_decode
from pixelbox_tpu_torch.ops.ivf import default_nprobe
from pixelbox_tpu_torch.query import parse_query
from pixelbox_tpu_torch.records import IndexedImage
from pixelbox_tpu_torch.serving import BatchingScanService
from pixelbox_tpu_torch.serving.semantic import SCAN_MODES

_PAGE = """<!DOCTYPE html>
<html><head><title>pixelbox-tpu</title><style>
body{font-family:sans-serif;margin:2em;background:#1b1b1f;color:#ddd}
input,button{font-size:1em;padding:.4em;background:#2a2a2f;color:#ddd;border:1px solid #555}
input[type=number]{width:6em}
#results{display:flex;flex-wrap:wrap;gap:12px;margin-top:1em}
.card{width:180px;background:#26262b;padding:8px;border-radius:6px}
.card img{max-width:100%;border-radius:4px}
.card .name{font-size:.8em;word-break:break-all}
.card .dist{font-size:.75em;color:#9a9}
a{color:#8cf}
#drop{border:2px dashed #555;border-radius:6px;padding:.6em 1em;display:inline-block;
      color:#aaa;cursor:pointer;margin-left:.5em}
#drop.hot{border-color:#8cf;color:#8cf}
#settings{margin-top:.6em;font-size:.85em;color:#aaa}
#pager{margin-top:.6em}
#pager button{margin-right:.4em}
</style></head><body>
<h2>pixelbox-tpu</h2>
<div>
<input id="q" size="50" placeholder='query (tag:, exif:, all:, similar:, filename:)'>
<button onclick="search()">Search</button>
<button onclick="reindex()">Reindex</button>
<span id="drop">drop / click to search by image<input id="file" type="file"
  accept="image/*" style="display:none"></span>
<span id="status"></span>
</div>
<div id="settings">
max results <input id="maxres" type="number" min="1" max="10000">
max distance <input id="maxdist" type="number" step="0.05" min="0">
min search len <input id="minlen" type="number" min="0" max="255" title="auto-search after this many characters; 0 disables">
thumb px <input id="thumbsz" type="number" min="60" max="512">
scan <select id="scanmode" title="auto = guaranteed-exact; ivf = clustered ANN (approximate selection, exact distances)">
<option>auto</option><option>exact</option><option>fast</option>
<option>pallas</option><option>ivf</option></select>
nprobe <input id="nprobe" type="number" min="0" style="width:3.5em"
 title="ivf mode: clusters probed per query (higher = better recall; 0 = auto, 2% of clusters)">
<button onclick="saveSettings()">apply</button>
</div>
<div id="pager">
<button onclick="page(-1)">&#8592; prev</button>
<button onclick="page(1)">next &#8594;</button>
<span id="pageinfo"></span>
</div>
<div id="results"></div>
<script>
const PAGE = 60;
let offset = 0;
let searchSeq = 0;  // staleness guard: only the newest query may render
async function search(){
  const q = document.getElementById('q').value;
  offset = 0;
  const seq = ++searchSeq;
  const r = await fetch('/api/search?q='+encodeURIComponent(q)
                        +'&offset=0&limit='+PAGE);
  const items = await r.json();
  if (seq === searchSeq) render(items);
}
async function similar(id){
  offset = 0;
  const r = await fetch('/api/similar?id='+id);
  render(await r.json());
}
async function page(dir){
  offset = Math.max(0, offset + dir*PAGE);
  const r = await fetch('/api/results?offset='+offset+'&limit='+PAGE);
  render(await r.json());
}
async function searchByFile(file){
  offset = 0;
  const r = await fetch('/api/similar', {method:'POST', body:file});
  render(await r.json());
}
async function reindex(){
  await fetch('/api/reindex', {method:'POST'});
  poll();
}
let minSearchLen = 3;
async function saveSettings(){
  const body = {
    max_search_results: +document.getElementById('maxres').value,
    max_distance: +document.getElementById('maxdist').value};
  const ml = document.getElementById('minlen').value;
  if (ml !== '') { minSearchLen = +ml; body.search_min_length = minSearchLen; }
  const ts = +document.getElementById('thumbsz').value;
  if (ts >= 60) { applyThumbSize(ts); body.thumbnail_size = ts; }
  body.scan_mode = document.getElementById('scanmode').value;
  const npEl = document.getElementById('nprobe');
  // 0 resets to the recall-governed auto default; an untouched empty
  // field is omitted.
  if (npEl.value !== '') body.ivf_nprobe = Math.max(0, +npEl.value || 0);
  await fetch('/api/settings', {method:'POST', body:JSON.stringify(body)});
}
function applyThumbSize(px){
  for (const c of document.querySelectorAll('.card')) c.style.width = px+'px';
}
async function poll(){
  const r = await (await fetch('/api/status')).json();
  document.getElementById('status').textContent =
    r.indexing ? ('indexing… '+r.images+' images') : (r.images+' images');
  const mr = document.getElementById('maxres');
  if (mr.value === '') mr.value = r.max_search_results;
  const md = document.getElementById('maxdist');
  if (md.value === '') md.value = r.max_distance;
  const ml = document.getElementById('minlen');
  if (ml.value === '') { ml.value = r.search_min_length; minSearchLen = r.search_min_length; }
  const ts = document.getElementById('thumbsz');
  if (ts.value === '') ts.value = r.thumbnail_size;
  const sm = document.getElementById('scanmode');
  if (!sm.dataset.touched) sm.value = r.scan_mode;
  sm.onchange = () => { sm.dataset.touched = 1; };
  const np = document.getElementById('nprobe');
  if (np.value === '' && r.ivf_nprobe) np.value = r.ivf_nprobe;
  if (r.indexing) setTimeout(poll, 1000);
}
function render(items){
  const el = document.getElementById('results');
  el.innerHTML = '';
  // Cards built with createElement/textContent only: filenames are
  // attacker-controlled (a file named <img onerror=...>.png must render
  // as text, never as markup).
  for (const it of items){
    const d = document.createElement('div'); d.className='card';
    const link = document.createElement('a');
    link.href = '/api/image?id='+encodeURIComponent(it.id);
    link.target = '_blank';  // full-image view (view panel analog)
    const img = document.createElement('img');
    img.src = '/api/thumbnail?id='+encodeURIComponent(it.id);
    link.appendChild(img);
    const name = document.createElement('div'); name.className='name';
    name.textContent = it.filename;
    name.title = it.path + (Object.keys(it.tags||{}).length
      ? '\\n' + Object.entries(it.tags).map(([k,v])=>k+': '+v).join('\\n')
      : '');
    const dist = document.createElement('div'); dist.className='dist';
    dist.textContent = it.distance==null ? '' : 'dist '+it.distance.toFixed(4);
    const a = document.createElement('a'); a.href='#';
    a.textContent = 'find similar';
    a.onclick = () => { similar(it.id); return false; };
    d.append(link, name, dist, a);
    el.appendChild(d);
  }
  document.getElementById('pageinfo').textContent =
    'page ' + (1 + offset/PAGE) + (items.length < PAGE ? ' (end)' : '');
  const ts = +document.getElementById('thumbsz').value;
  if (ts >= 60) applyThumbSize(ts);
}
const drop = document.getElementById('drop');
const fileInput = document.getElementById('file');
drop.onclick = () => fileInput.click();
fileInput.onchange = () => {
  if (fileInput.files.length) searchByFile(fileInput.files[0]);
};
// Drag-and-drop query — the reference's flagship interaction
// (src/ui/search.rs:28-31, 120-163): drop anywhere on the page.
for (const t of [document.body, drop]){
  t.addEventListener('dragover', e => {e.preventDefault(); drop.classList.add('hot');});
  t.addEventListener('dragleave', () => drop.classList.remove('hot'));
  t.addEventListener('drop', e => {
    e.preventDefault(); drop.classList.remove('hot');
    if (e.dataTransfer.files.length) searchByFile(e.dataTransfer.files[0]);
  });
}
poll();
document.getElementById('q').addEventListener('keydown', e=>{if(e.key=='Enter')search()});
// Auto-search past the minimum length (search.rs:40-49; settings.rs:
// "0 disables automatic searching"), debounced.
let searchTimer = null;
document.getElementById('q').addEventListener('input', e=>{
  clearTimeout(searchTimer);
  if (minSearchLen > 0 && e.target.value.length >= minSearchLen)
    searchTimer = setTimeout(search, 300);
});
document.getElementById('q').addEventListener('keydown', e=>{
  if (e.key=='Enter') clearTimeout(searchTimer);
});
</script></body></html>"""

_NOT_PORTED = "is not yet ported to pixelbox_tpu_torch"


def _serialize_results(results, offset: int = 0, limit: int = 0):
    """Serialize a result list; offset/limit implement the pagination the
    reference stubbed but never wired (reference src/ui/mod.rs:61-82)."""
    if offset:
        results = results[offset:]
    if limit:
        results = results[:limit]
    return [
        {
            "id": r.id,
            "filename": r.filename,
            "path": r.path,
            "resolution": list(r.resolution),
            "distance": r.distance_from_query,
            "tags": r.tags,
        }
        for r in results
    ]


def _results_json(engine, offset: int = 0, limit: int = 0):
    return _serialize_results(engine.get_query_results() or [], offset, limit)


class _ThumbCache:
    """Small LRU of encoded PNG thumbnails — the server-side analog of the
    reference's per-image-id texture cache (src/ui/mod.rs:50-59)."""

    def __init__(self, capacity: int = 512):
        self._od = OrderedDict()
        self._cap = capacity
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                return self._od[key]
        return None

    def put(self, key, value):
        with self._lock:
            self._od[key] = value
            self._od.move_to_end(key)
            while len(self._od) > self._cap:
                self._od.popitem(last=False)


_IMAGE_TYPES = {
    "jpg": "image/jpeg", "jpeg": "image/jpeg", "jfif": "image/jpeg",
    "png": "image/png", "gif": "image/gif", "webp": "image/webp",
    "bmp": "image/bmp", "tiff": "image/tiff",
}


def make_handler(engine, lock: threading.Lock, scan_service=None):
    """The request handler class over ``engine``: ``lock`` serializes the
    engine's result cache and its unbatched query paths; ``scan_service``
    (a :class:`BatchingScanService`, or None) coalesces similarity
    queries."""
    thumb_cache = _ThumbCache()
    # UI-level settings (reference MainApp state, settings.rs:9-20):
    # search_min_length 0 disables auto-search; thumbnail_size is the
    # card width in px.
    ui_settings = {"search_min_length": 3, "thumbnail_size": 180}

    def _similar_by_record(rec):
        """Similarity results for a hashed record.

        With a scan service, concurrent requests coalesce into single
        device batches instead of serializing behind the engine lock;
        assembling results stays on the request thread (the catalog uses
        per-thread connections).  The service scans with the
        guaranteed-exact auto path, result-identical to auto, exact, fast
        and pallas, so those modes coalesce freely.  IVF returns another
        (probed) result set, so it coalesces under its own kind
        (``engine.ivf_scan_batched``; both give store row ids).
        """
        ivf = engine.scan_mode == "ivf"
        if scan_service is not None \
                and (not ivf or "ivf" in scan_service.kinds) \
                and engine._sem_store is not None \
                and engine._sem_store.size > 0:
            scan_service.k = int(engine.max_search_results)
            scan_service.max_distance = float(engine.max_distance_from_query)
            # Read lock across scan→assemble: a compaction renumbering
            # between them would map rows through the wrong id table.
            with engine.index_rwlock.read_locked():
                dist, idx = scan_service.submit(rec.visual_hash, kind="ivf" if ivf else "semantic")
                keep = idx >= 0
                results = engine._build_results(idx[keep], dist[keep])
            with lock:
                engine._cached_search_results = results
            return results
        with lock:
            engine.query_by_image_hash_from_image(rec)
            return engine.get_query_results() or []

    def _phash_batchable(ph) -> bool:
        """A uniform-width phash store takes the batched scan; mixed
        widths (compat hashes) take the engine's grouped zip-truncate
        path.  Called under the index read lock."""
        store = engine._ph_store
        return (
            scan_service is not None
            and "phash" in scan_service.kinds
            and store is not None
            and store.size > 0
            and len(ph) >= store.dim
            and engine.phash_store_uniform()
        )

    def _phash_similar(ph):
        """Hamming search for an uploaded image's phash; concurrent
        requests on a uniform-width store coalesce into one device batch
        (kind="phash")."""
        # Read lock across check→scan→assemble: the width check would read
        # the store mid-append otherwise, and a compaction renumbering
        # between scan and assemble would map rows through the wrong ids.
        with engine.index_rwlock.read_locked():
            batched = _phash_batchable(ph)
            if batched:
                scan_service.k = int(engine.max_search_results)
                scan_service.max_distance = float(engine.max_distance_from_query)
                dist, rows = scan_service.submit(np.asarray(ph), kind="phash")
                keep = rows >= 0
                ids = engine.phash_ids_for_rows(rows[keep])
        if batched:
            results = engine._results_from_image_ids(ids, dist[keep])
            with lock:
                engine._cached_search_results = results
            return results
        with lock:
            engine.query_by_phash(ph)
            return engine.get_query_results() or []

    def _refuse_unported_query(q: str) -> None:
        parsed = parse_query(q) if q else None
        if parsed is not None and parsed.text_query is not None:
            raise NotImplementedError(f"text: search (BLIP) {_NOT_PORTED}")
        if parsed is not None and parsed.face_path is not None:
            raise NotImplementedError(f"face: search {_NOT_PORTED}")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, body, ctype="application/json"):
            if isinstance(body, (dict, list)):
                body = json.dumps(body).encode()
            elif isinstance(body, str):
                body = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self, f, size: int, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(size))
            self.end_headers()
            shutil.copyfileobj(f, self.wfile)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            qs = urllib.parse.parse_qs(parsed.query)
            try:
                return self._get(parsed.path, qs)
            except NotImplementedError as e:
                return self._send(501, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the client gets a 500
                return self._send(500, {"error": str(e)})

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            try:
                return self._post(parsed.path, body)
            except NotImplementedError as e:
                return self._send(501, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the client gets a 500
                return self._send(500, {"error": str(e)})

        def _get(self, path, qs):
            if path == "/":
                return self._send(200, _PAGE, "text/html")
            if path == "/api/search":
                q = qs.get("q", [""])[0]
                offset = int(qs.get("offset", ["0"])[0])
                limit = int(qs.get("limit", ["0"])[0])
                _refuse_unported_query(q)
                with lock:
                    engine.query(q)
                    return self._send(200, _results_json(engine, offset, limit))
            if path == "/api/similar":
                image_id = int(qs["id"][0])
                info = engine.catalog.get_image(image_id)
                if info is None:
                    return self._send(404, {"error": "no such image"})
                # Find-similar on a result uses the STORED hash: no
                # decode/embed, and the image matches itself exactly.
                blob = engine.catalog.get_hash("semantic_hashes", image_id)
                if blob is None:
                    return self._send(410, {"error": "no semantic hash"})
                rec = IndexedImage(
                    id=image_id, filename=info["filename"], path=info["path"],
                    visual_hash=np.frombuffer(blob, dtype=np.uint8),
                )
                # Serialize the list returned to THIS request — the engine
                # cache is shared and a concurrent query may overwrite it.
                return self._send(200, _serialize_results(_similar_by_record(rec)))
            if path == "/api/thumbnail":
                image_id = int(qs["id"][0])
                cached = thumb_cache.get(image_id)
                if cached is not None:
                    return self._send(200, cached, "image/png")
                info = engine.catalog.get_image(image_id)
                if info is None or not info["thumbnail"]:
                    return self._send(404, {"error": "no thumbnail"})
                from PIL import Image

                rgb, _ = qoi_decode(info["thumbnail"])
                buf = io.BytesIO()
                Image.fromarray(rgb).save(buf, "PNG")
                png = buf.getvalue()
                thumb_cache.put(image_id, png)
                return self._send(200, png, "image/png")
            if path == "/api/image":
                # The original indexed file, streamed (the reference's
                # view panel, ui/view.rs:14-78); originals can be hundreds
                # of MB and handler threads are concurrent.
                image_id = int(qs["id"][0])
                info = engine.catalog.get_image(image_id)
                if info is None:
                    return self._send(404, {"error": "no such image"})
                ext = info["path"].rsplit(".", 1)[-1].lower()
                ctype = _IMAGE_TYPES.get(ext, "application/octet-stream")
                zp = split_zip_path(info["path"])
                if zp is not None:
                    try:
                        zf = zipfile.ZipFile(zp[0])
                    except (OSError, zipfile.BadZipFile):
                        return self._send(410, {"error": "file unreadable"})
                    with zf:
                        try:
                            zinfo = zf.getinfo(zp[1])
                        except KeyError:
                            return self._send(410, {"error": "file unreadable"})
                        with zf.open(zinfo) as f:
                            return self._stream(f, zinfo.file_size, ctype)
                try:
                    f = open(info["path"], "rb")
                except OSError:
                    return self._send(410, {"error": "file unreadable"})
                with f:
                    return self._stream(f, os.fstat(f.fileno()).st_size, ctype)
            if path == "/api/results":
                # Page through the cached results WITHOUT re-running the
                # query (the pagination the reference stubbed).
                offset = int(qs.get("offset", ["0"])[0])
                limit = int(qs.get("limit", ["0"])[0])
                return self._send(200, _results_json(engine, offset, limit))
            if path == "/api/folders":
                return self._send(200, engine.get_tracked_folders())
            if path == "/api/duplicates":
                by = qs.get("by", ["phash"])[0]
                if by not in ("phash", "semantic"):
                    return self._send(400, {"error": "by must be phash or semantic"})
                md = float(qs.get("max_distance", ["0.1" if by == "phash" else "0.05"])[0])
                # Holds the engine lock for the whole self-scan (an
                # admin-style operation; concurrent searches queue).
                if qs.get("groups", ["0"])[0] in ("1", "true"):
                    with lock:
                        groups = engine.find_duplicate_groups(max_distance=md, by=by)
                    return self._send(200, {"groups": groups})
                with lock:
                    pairs = engine.find_duplicate_pairs(max_distance=md, by=by)
                return self._send(
                    200, {"pairs": [{"a": a, "b": b, "distance": d} for a, b, d in pairs]}
                )
            if path == "/api/faces":
                raise NotImplementedError(f"face search {_NOT_PORTED}")
            if path == "/api/status":
                status = {
                    "images": engine.get_num_indexed_images(),
                    "indexing": engine.is_indexing_active(),
                    "max_search_results": engine.max_search_results,
                    "max_distance": engine.max_distance_from_query,
                    "scan_mode": engine.scan_mode,
                    "ivf_nprobe": engine.ivf_nprobe,  # null = auto
                    # What auto resolves to on the live clustered index
                    # (one device or sharded; null until an ivf query
                    # built one).
                    "ivf_nprobe_effective": (
                        engine.ivf_nprobe
                        or engine._ivf_tuned_nprobe
                        or (default_nprobe(engine._ivf.n_clusters)
                            if engine._ivf is not None else None)
                        or (default_nprobe(engine._ivf_sharded.n_clusters)
                            if engine._ivf_sharded is not None else None)
                    ),
                    "ivf_clusters": engine.ivf_clusters,  # null = auto
                    "semantic_precision": engine.semantic_precision,
                    "embedder": engine._embedder_name,
                    "phash_compat": engine.phash_compat,
                    "watching": engine.is_watching(),
                    "watch_removals": getattr(engine, "watch_removals", 0),
                    "device": str(engine.device),
                    **ui_settings,
                }
                if scan_service is not None:
                    status["scan_batches"] = scan_service.batches_run
                    status["scan_queries"] = scan_service.queries_served
                return self._send(200, status)
            return self._send(404, {"error": "not found"})

        def _post(self, path, body):
            if path == "/api/similar":
                rec = engine.load_image_from_memory(body, "upload", "")
                if rec is None:
                    return self._send(400, {"error": "cannot decode image"})
                return self._send(200, _serialize_results(_similar_by_record(rec)))
            if path == "/api/phash-similar":
                rec = engine.load_image_from_memory(body, "upload", "")
                if rec is None:
                    return self._send(400, {"error": "cannot decode image"})
                return self._send(200, _serialize_results(_phash_similar(rec.phash)))
            if path == "/api/face-similar":
                raise NotImplementedError(f"face search {_NOT_PORTED}")
            data = json.loads(body) if body else {}
            if path == "/api/folders/add":
                engine.add_tracked_folder(data["folder"])
                return self._send(200, engine.get_tracked_folders())
            if path == "/api/folders/remove":
                if data.get("purge"):
                    with lock:
                        n = engine.remove_tracked_folder_and_images(data["folder"])
                    return self._send(
                        200, {"folders": engine.get_tracked_folders(), "removed_images": n}
                    )
                engine.remove_tracked_folder(data["folder"])
                return self._send(200, engine.get_tracked_folders())
            if path == "/api/remove":
                with lock:
                    ok = engine.remove_image(int(data["id"]))
                if not ok:
                    return self._send(404, {"error": "no such image"})
                return self._send(200, {"removed": int(data["id"])})
            if path == "/api/reindex":
                engine.start_indexing()
                return self._send(200, {"started": True})
            if path == "/api/stop":
                engine.stop_indexing()
                return self._send(200, {"stopped": True})
            if path == "/api/tag":
                # Editable tags: {"id": N, "name": ..., "value": ...}.
                image_id = int(data["id"])
                if not engine.set_tag(image_id, str(data["name"]), str(data.get("value", ""))):
                    return self._send(404, {"error": "no such image"})
                return self._send(200, {"tags": engine.catalog.get_tags(image_id)})
            if path == "/api/untag":
                image_id = int(data["id"])
                if not engine.remove_tag(image_id, str(data["name"])):
                    return self._send(404, {"error": "no such tag"})
                return self._send(200, {"tags": engine.catalog.get_tags(image_id)})
            if path == "/api/watch":
                if data.get("stop"):
                    engine.stop_watching()
                else:
                    engine.watch(interval_s=float(data.get("interval", 30.0)))
                return self._send(200, {"watching": engine.is_watching()})
            if path == "/api/settings":
                return self._settings(data)
            return self._send(404, {"error": "not found"})

        def _settings(self, data):
            # Validate every field BEFORE applying any, so a bad value is a
            # clean 400 with nothing half-applied.
            try:
                staged = {}
                if "max_search_results" in data:
                    staged["max_search_results"] = int(data["max_search_results"])
                if "max_distance" in data:
                    staged["max_distance"] = float(data["max_distance"])
                if "search_min_length" in data:
                    staged["search_min_length"] = min(255, max(0, int(data["search_min_length"])))
                if "thumbnail_size" in data:
                    staged["thumbnail_size"] = min(512, max(60, int(data["thumbnail_size"])))
                for key in ("ivf_nprobe", "ivf_clusters"):
                    # null/0 = back to auto (the 2% nprobe policy, ~4·sqrt(N)
                    # clusters); a new cluster count retrains on the next
                    # ivf query.
                    if key in data:
                        v = data[key]
                        staged[key] = None if v in (None, 0, "0", "") else max(1, int(v))
            except (TypeError, ValueError) as e:
                return self._send(400, {"error": f"bad value: {e}"})
            if "scan_mode" in data:
                mode = str(data["scan_mode"])
                if mode not in SCAN_MODES:
                    return self._send(400, {"error": f"bad scan_mode: {mode}"})
                staged["scan_mode"] = mode
            if "max_search_results" in staged:
                engine.max_search_results = staged["max_search_results"]
            if "max_distance" in staged:
                engine.max_distance_from_query = staged["max_distance"]
            for key in ("search_min_length", "thumbnail_size"):
                if key in staged:
                    ui_settings[key] = staged[key]
            if "scan_mode" in staged:
                engine.scan_mode = staged["scan_mode"]
            if "ivf_nprobe" in staged:
                engine.ivf_nprobe = staged["ivf_nprobe"]
            if "ivf_clusters" in staged:
                engine.ivf_clusters = staged["ivf_clusters"]
            return self._send(200, {"ok": True})

    return Handler


def build_scan_service(engine) -> BatchingScanService:
    """Create, register and warm the batching service for an engine —
    :func:`serve`'s startup path, factored out so tests and the chip
    smoke drive it."""
    int4_rerank = engine.semantic_precision == "int4" and engine.int4_rerank
    service = BatchingScanService(
        engine.semantic_scan_inputs,
        k=engine.max_search_results,
        max_distance=engine.max_distance_from_query,
        # int4 libraries rescore candidates with the exact u8 metric from
        # the store's host mirror (the engine's int4_rerank).
        rerank_rows_provider=(lambda: engine._sem_store._host_rows) if int4_rerank else None,
    )
    engine.attach_scan_service(service)
    # Warm every bucket on a non-empty store: the kernels build and the
    # cached sample and meta fill before traffic arrives.  Under the read
    # lock, as a request's scan runs: a watcher may be appending.
    with engine.index_rwlock.read_locked():
        if engine._sem_store is not None and engine._sem_store.size > 0:
            service.warmup(engine._sem_store.dim)
        ph = engine._ph_store
        if (
            "phash" in service.kinds
            and ph is not None
            and ph.size > 0
            and engine.phash_store_uniform()
        ):
            service.warmup(ph.dim, kinds=("phash",))
        if engine.scan_mode == "ivf" and engine._sem_store is not None \
                and engine._sem_store.size > 0:
            # Serving in ivf mode: train and pack the clustered index (and
            # run its probe at every bucket) before traffic arrives.
            service.warmup(engine._sem_store.dim, kinds=("ivf",))
    return service


class _Server(ThreadingHTTPServer):
    # A burst of concurrent clients (the case batching is for) must not
    # overflow the listen backlog (socketserver's default is 5).
    request_queue_size = 256
    daemon_threads = True


def make_server(engine, host: str = "127.0.0.1", port: int = 8333, scan_service=None):
    """The HTTP server over ``engine`` (not yet serving: call
    ``serve_forever``); port 0 picks a free port (``server_address``).
    The embedder loads here, so the first uploads do not pay for it."""
    engine.embedder  # noqa: B018 — loads the model (None in tags-only mode)
    return _Server((host, port), make_handler(engine, threading.Lock(), scan_service))


def serve(engine, host: str = "127.0.0.1", port: int = 8333, batching: bool = True):
    """Run the web UI / JSON API until interrupted.  ``batching=True``
    (default) coalesces concurrent similarity queries into single device
    scans via :class:`BatchingScanService`."""
    scan_service = build_scan_service(engine) if batching else None
    server = make_server(engine, host, port, scan_service)
    print(f"pixelbox-tpu-torch serving on http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if scan_service is not None:
            scan_service.close()
        server.server_close()
