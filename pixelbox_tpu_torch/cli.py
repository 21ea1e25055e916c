"""pixelbox_tpu_torch CLI — the port's operational surface.

    python -m pixelbox_tpu_torch.cli <cmd> <db> ... [--device cuda|cpu]

Subcommands (the JAX CLI's names and flags):

    init <db>                      — create a library
    add-folder <db> <folder>       — track a folder
    remove-folder <db> <folder>    — stop tracking it (--purge: and remove its images)
    folders <db>                   — list tracked folders
    index <db>                     — crawl tracked folders, index new images
    watch <db>                     — index, then keep indexing new files
    remove-image <db> <id>         — remove one image from the index
    compact <db>                   — drop tombstoned rows from the device stores
    tag <db> <id> <name> [value]   — set a user tag
    untag <db> <id> <name>         — remove a tag
    search <db> <query...>         — text query (similar:/tag:/exif:/all:/...)
    similar <db> <image>           — find images similar to a file
    similar-id <db> <id>           — find images similar to an indexed image
    phash-similar <db> <image>     — near-duplicate search by perceptual hash
    duplicates <db>                — whole-index near-duplicate pairs/groups
    show <db> <id>                 — one indexed image's metadata
    stats <db>                     — index statistics
    serve <db>                     — the web UI + JSON API (micro-batched scans)

``--device`` defaults to ``cuda`` and never falls back to the CPU.  Every
scan mode is ported: ``auto``/``exact``/``fast``/``pallas``, and ``ivf``
(the clustered ANN; ``--nprobe``, ``--ivf-clusters`` and
``--ivf-target-recall`` tune it).  ``--precision int4`` packs the semantic index
two 4-bit codes a byte and rescores its candidates with the exact u8
metric (``--no-int4-rerank`` turns the rescore off).  Not yet ported:
``face-similar``, ``faces``, ``index-faces``, ``train`` and ``finalize``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _open_engine(args, create=False):
    from pixelbox_tpu_torch.engine import Engine

    kwargs = {"device": args.device}
    if args.embedder:
        kwargs["embedder"] = args.embedder
    if args.dim:
        kwargs["dim"] = args.dim
    if args.model:
        kwargs["embedder_kwargs"] = {"checkpoint_path": args.model}
    if args.precision:
        kwargs["semantic_precision"] = args.precision
    if args.no_int4_rerank:
        kwargs["int4_rerank"] = False
    eng = Engine(args.db, create=create, **kwargs)
    if args.scan_mode:
        eng.scan_mode = args.scan_mode
    if args.nprobe:
        eng.ivf_nprobe = int(args.nprobe)
    if args.ivf_target_recall:
        eng.ivf_target_recall = float(args.ivf_target_recall)
    if args.ivf_clusters:
        eng.ivf_clusters = int(args.ivf_clusters)
    return eng


def _print_results(engine, as_json=False):
    results = engine.get_query_results() or []
    if as_json:
        print(
            json.dumps(
                [
                    {
                        "id": r.id,
                        "filename": r.filename,
                        "path": r.path,
                        "resolution": list(r.resolution),
                        "distance": r.distance_from_query,
                        "tags": r.tags,
                    }
                    for r in results
                ],
                indent=2,
            )
        )
        return
    for r in results:
        dist = "" if r.distance_from_query is None else f"  dist={r.distance_from_query:.6f}"
        # Similarity display matches the search panel: 1/(1+dist)
        # (reference src/ui/search.rs:91).
        sim = (
            ""
            if r.distance_from_query is None
            else f"  sim={1.0 / (1.0 + r.distance_from_query):.4f}"
        )
        print(f"{r.id:6d}  {r.path}{dist}{sim}")
    print(f"{len(results)} results", file=sys.stderr)


def _duplicates(engine, args) -> int:
    md = args.max_distance
    if md is None:
        md = 0.1 if args.by == "phash" else 0.05
    if args.groups:
        groups = engine.find_duplicate_groups(max_distance=md, k=args.k, by=args.by)
        if args.json:
            print(json.dumps(groups, indent=2))
        else:
            for g in groups:
                print("group:")
                for i in g:
                    info = engine.catalog.get_image(i)
                    print(f"  {i}  {info['path'] if info else '?'}")
            print(f"{len(groups)} duplicate groups", file=sys.stderr)
        return 0
    pairs = engine.find_duplicate_pairs(max_distance=md, k=args.k, by=args.by)
    if args.json:
        print(json.dumps([{"a": a, "b": b, "distance": d} for a, b, d in pairs], indent=2))
    else:
        for a, b, d in pairs:
            ia = engine.catalog.get_image(a)
            ib = engine.catalog.get_image(b)
            print(
                f"dist={d:.6f}  {a}:{ia['path'] if ia else '?'}"
                f"  <->  {b}:{ib['path'] if ib else '?'}"
            )
        print(f"{len(pairs)} near-duplicate pairs", file=sys.stderr)
    return 0


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pixelbox-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_db_cmd(name, **kw):
        sp = sub.add_parser(name, **kw)
        sp.add_argument("db", help="catalog database path")
        sp.add_argument(
            "--device", default="cuda",
            help="torch device for the store, embedder and scans (default "
            "cuda; a missing card is an error, never a silent CPU run)",
        )
        sp.add_argument(
            "--embedder", default=None,
            help="stub|efficientnet|none ('none' = tags-only mode). The "
            "choice persists in the library; explicit flags override.",
        )
        sp.add_argument("--dim", type=int, default=None, help="embedding width")
        sp.add_argument(
            "--model", default=None,
            help="EfficientNet checkpoint: the JAX package's .npz format",
        )
        sp.add_argument(
            "--scan-mode", dest="scan_mode", default=None,
            choices=("auto", "exact", "fast", "pallas", "ivf"),
            help="similarity scan mode (default auto: verified-exact; fast "
            "is served as auto; pallas = the fused exact kernel scan; ivf = "
            "clustered ANN — approximate selection over the --nprobe nearest "
            "clusters, exact distances; composes with --precision int4: "
            "half-byte buckets + exact-u8 rerank)",
        )
        sp.add_argument(
            "--nprobe", type=int, default=None,
            help="ivf mode: clusters probed per query (default: "
            "recall-governed — 2%% of clusters, floor 8; higher = "
            "better recall, slower)",
        )
        sp.add_argument(
            "--ivf-target-recall", dest="ivf_target_recall", type=float, default=None,
            help="ivf mode: MEASURE nprobe instead of the 2%% policy — "
            "tune on held-out noisy copies of indexed rows until "
            "recall@10 vs the exact scan meets this target (e.g. 0.99); "
            "--nprobe overrides",
        )
        sp.add_argument(
            "--ivf-clusters", dest="ivf_clusters", type=int, default=None,
            help="ivf mode: k-means cluster count (default ~4*sqrt(N))",
        )
        sp.add_argument(
            "--precision", default=None, choices=("int8", "int4"),
            help="semantic index precision: int4 packs 2x rows per card "
            "(the catalog keeps full u8 hashes). Queries retrieve top-C "
            "candidates from the int4 index and rescore them with the "
            "EXACT u8 metric from the host mirror, so reported distances "
            "are true u8 values. Persisted in the library; later commands "
            "inherit it.",
        )
        sp.add_argument(
            "--no-int4-rerank", action="store_true",
            help="skip the exact-u8 rescoring of int4 candidates "
            "(raw asymmetric int4-metric results)",
        )
        return sp

    add_db_cmd("init", help="create a new library database")
    sp = add_db_cmd("add-folder", help="track a folder for indexing")
    sp.add_argument("folder")
    sp = add_db_cmd("remove-folder", help="stop tracking a folder")
    sp.add_argument("folder")
    sp.add_argument("--purge", action="store_true",
                    help="also remove every indexed image under the folder")
    sp = add_db_cmd("remove-image", help="remove one image from the index")
    sp.add_argument("id", type=int)
    add_db_cmd("compact", help="drop tombstoned rows from the device stores after removals")
    add_db_cmd("folders", help="list tracked folders")
    sp = add_db_cmd("index", help="crawl tracked folders and index new images")
    sp.add_argument("--workers", type=int, default=None)
    sp = add_db_cmd(
        "watch",
        help="index once, then keep watching tracked folders for new images "
        "until interrupted",
    )
    sp.add_argument("--workers", type=int, default=None)
    sp.add_argument("--interval", type=float, default=30.0, help="poll interval in seconds")
    sp = add_db_cmd("tag", help="set a user tag on an indexed image")
    sp.add_argument("id", type=int)
    sp.add_argument("name")
    sp.add_argument("value", nargs="?", default="")
    sp = add_db_cmd("untag", help="remove a tag from an indexed image")
    sp.add_argument("id", type=int)
    sp.add_argument("name")
    sp = add_db_cmd("search", help="text query (similar:/tag:/exif:/all:/filename:/ocr:)")
    sp.add_argument("query", nargs="+")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--limit", type=int, default=100)
    sp = add_db_cmd("similar", help="find images similar to a file")
    sp.add_argument("image")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--max-distance", type=float, default=1e3)
    sp = add_db_cmd(
        "similar-id",
        help="find images similar to an INDEXED image (its stored hash, no re-decode)",
    )
    sp.add_argument("id", type=int)
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--max-distance", type=float, default=1e3)
    sp = add_db_cmd("phash-similar", help="find near-duplicates by perceptual hash")
    sp.add_argument("image")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--max-distance", type=float, default=1e3)
    sp = add_db_cmd(
        "duplicates",
        help="find near-duplicate image pairs across the whole index "
        "(batched device self-scan)",
    )
    sp.add_argument("--by", default="phash", choices=("phash", "semantic"))
    sp.add_argument(
        "--max-distance", type=float, default=None,
        help="strict distance cutoff (default: 0.1 hamming for phash, "
        "0.05 reciprocal-cosine for semantic)",
    )
    sp.add_argument("--k", type=int, default=8, help="max neighbors considered per image")
    sp.add_argument("--groups", action="store_true",
                    help="print transitive duplicate GROUPS instead of pairs")
    sp.add_argument("--json", action="store_true")
    sp = add_db_cmd("show", help="show one indexed image's metadata")
    sp.add_argument("id", type=int)
    add_db_cmd("stats", help="index statistics")
    sp = add_db_cmd("serve", help="serve the web UI and JSON API")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8333)
    sp.add_argument("--no-batching", action="store_true",
                    help="disable micro-batched query coalescing")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    try:
        engine = _open_engine(args, create=args.cmd == "init")
    except (NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        if args.cmd == "init":
            print(f"Created library at {args.db}")
        elif args.cmd == "add-folder":
            engine.add_tracked_folder(args.folder)
            print(f"Tracking {args.folder}")
        elif args.cmd == "remove-folder":
            if args.purge:
                n = engine.remove_tracked_folder_and_images(args.folder)
                print(f"Stopped tracking {args.folder}; removed {n} images")
            else:
                engine.remove_tracked_folder(args.folder)
                print(f"Stopped tracking {args.folder}")
        elif args.cmd == "remove-image":
            if not engine.remove_image(args.id):
                print(f"No image with id {args.id}", file=sys.stderr)
                return 1
            print(f"Removed image {args.id}")
        elif args.cmd == "compact":
            engine.compact()
            print("Compacted device stores")
        elif args.cmd == "folders":
            for f in engine.get_tracked_folders():
                print(f)
        elif args.cmd == "index":
            engine.start_indexing(num_workers=args.workers)
            engine.wait_for_indexing()
            print(f"Indexed images: {engine.get_num_indexed_images()}")
        elif args.cmd == "watch":
            engine.start_indexing(num_workers=args.workers)
            engine.wait_for_indexing()
            print(f"Indexed images: {engine.get_num_indexed_images()}")
            engine.watch(interval_s=args.interval, num_workers=args.workers)
            print(
                f"Watching {len(engine.get_tracked_folders())} folder(s) "
                f"every {args.interval:g}s — Ctrl-C to stop."
            )
            try:
                while engine.is_watching():
                    time.sleep(1.0)
            except KeyboardInterrupt:
                pass
        elif args.cmd == "tag":
            if not engine.set_tag(args.id, args.name, args.value):
                print(f"No image with id {args.id}", file=sys.stderr)
                return 1
            print(f"Tagged {args.id}: {args.name}={args.value!r}")
        elif args.cmd == "untag":
            if not engine.remove_tag(args.id, args.name):
                print(f"No tag {args.name!r} on image {args.id}", file=sys.stderr)
                return 1
            print(f"Untagged {args.id}: {args.name}")
        elif args.cmd == "search":
            from pixelbox_tpu_torch.query import QueryTokenizeError

            engine.max_search_results = args.limit
            try:
                engine.query(" ".join(args.query))
            except QueryTokenizeError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
            if engine.last_query_error:
                print(f"warning: {engine.last_query_error}", file=sys.stderr)
            _print_results(engine, as_json=args.json)
        elif args.cmd == "similar":
            engine.max_search_results = args.limit
            engine.max_distance_from_query = args.max_distance
            try:
                engine.query_by_image_hash_from_file(args.image)
            except NotImplementedError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
            if engine.last_query_error:
                print(f"error: {engine.last_query_error}", file=sys.stderr)
                return 1
            _print_results(engine, as_json=args.json)
        elif args.cmd == "similar-id":
            engine.max_search_results = args.limit
            engine.max_distance_from_query = args.max_distance
            try:
                engine.query_by_image_hash_from_id(args.id)
            except NotImplementedError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
            if engine.last_query_error:
                print(f"error: {engine.last_query_error}", file=sys.stderr)
                return 1
            _print_results(engine, as_json=args.json)
        elif args.cmd == "phash-similar":
            from pixelbox_tpu_torch.ingest.decode import decode_image_file
            from pixelbox_tpu_torch.ops.phash import phash as phash_fn

            decoded = decode_image_file(args.image)
            if decoded is None:
                print(f"error: cannot decode image: {args.image}", file=sys.stderr)
                return 1
            engine.max_search_results = args.limit
            engine.max_distance_from_query = args.max_distance
            engine.query_by_phash(
                phash_fn(decoded.rgb, aspect_preserving=engine.phash_compat)
            )
            _print_results(engine, as_json=args.json)
        elif args.cmd == "duplicates":
            return _duplicates(engine, args)
        elif args.cmd == "show":
            info = engine.catalog.get_image(args.id)
            if info is None:
                print(f"No image with id {args.id}", file=sys.stderr)
                return 1
            info["tags"] = engine.catalog.get_tags(args.id)
            info["thumbnail"] = (
                f"<{len(info['thumbnail'])} bytes QOI>" if info["thumbnail"] else None
            )
            print(json.dumps(info, indent=2))
        elif args.cmd == "stats":
            from pixelbox_tpu_torch.utils.timing import get_stats

            print(
                json.dumps(
                    {
                        "images": engine.get_num_indexed_images(),
                        "tracked_folders": engine.get_tracked_folders(),
                        "semantic_dim": (
                            engine._sem_store.dim if engine._sem_store else None
                        ),
                        "semantic_precision": engine.semantic_precision,
                        "embedder": engine._embedder_name,
                        "phash_compat": engine.phash_compat,
                        "phash_dim": engine._ph_store.dim if engine._ph_store else None,
                        "device": str(engine.device),
                        "timings": get_stats(),
                    },
                    indent=2,
                )
            )
        elif args.cmd == "serve":
            from pixelbox_tpu_torch.serve import serve

            serve(engine, host=args.host, port=args.port, batching=not args.no_batching)
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
