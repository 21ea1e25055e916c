"""pixelbox_tpu_torch CLI — the port's operational surface.

    python -m pixelbox_tpu_torch.cli <cmd> <db> ... [--device cuda|cpu]

Subcommands (the JAX CLI's names and flags):

    init <db>                      — create a library
    add-folder <db> <folder>       — track a folder
    index <db>                     — crawl tracked folders, index new images
    search <db> <query...>         — text query (similar:/tag:/exif:/all:/...)
    similar <db> <image>           — find images similar to a file
    show <db> <id>                 — one indexed image's metadata
    stats <db>                     — index statistics

``--device`` defaults to ``cuda`` and never falls back to the CPU.  Scan
modes ``auto``/``exact``/``fast``/``pallas`` are ported; ``ivf`` and
``--precision int4`` exit with a "not yet ported" error.
"""

from __future__ import annotations

import argparse
import json
import sys


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
    eng = Engine(args.db, create=create, **kwargs)
    if args.scan_mode:
        eng.scan_mode = args.scan_mode
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
            "is served as auto; pallas = the fused exact kernel scan; ivf "
            "is not yet ported)",
        )
        sp.add_argument(
            "--precision", default=None, choices=("int8", "int4"),
            help="semantic index precision (int4 is not yet ported)",
        )
        return sp

    add_db_cmd("init", help="create a new library database")
    sp = add_db_cmd("add-folder", help="track a folder for indexing")
    sp.add_argument("folder")
    sp = add_db_cmd("index", help="crawl tracked folders and index new images")
    sp.add_argument("--workers", type=int, default=None)
    sp = add_db_cmd("search", help="text query (similar:/tag:/exif:/all:/filename:/ocr:)")
    sp.add_argument("query", nargs="+")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--limit", type=int, default=100)
    sp = add_db_cmd("similar", help="find images similar to a file")
    sp.add_argument("image")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--max-distance", type=float, default=1e3)
    sp = add_db_cmd("show", help="show one indexed image's metadata")
    sp.add_argument("id", type=int)
    add_db_cmd("stats", help="index statistics")
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
        elif args.cmd == "index":
            engine.start_indexing(num_workers=args.workers)
            engine.wait_for_indexing()
            print(f"Indexed images: {engine.get_num_indexed_images()}")
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
                        "device": str(engine.device),
                        "timings": get_stats(),
                    },
                    indent=2,
                )
            )
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
