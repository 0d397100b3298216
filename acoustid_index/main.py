"""Process entry point: standalone index node, replica node, or coordinator.

CLI flags mirror the reference's table (/root/reference/src/main.zig:40-65,
README "Configuration"); unknown flags warn and continue.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="acoustid-index", add_help=True)
    p.add_argument("--dir", default="data", help="Data directory")
    p.add_argument("--host", default="127.0.0.1", help="Listen address")
    p.add_argument("--port", type=int, default=8080, help="Listen port")
    p.add_argument("--checkpoint-threshold", type=int, default=100_000)
    p.add_argument("--checkpoint-age-ms", type=int, default=60_000, help="0 disables")
    p.add_argument("--legacy-port", type=int, default=0, help="0 = off")
    p.add_argument(
        "--search-port",
        type=int,
        default=0,
        help="Native C++ search-plane port (search-only fast path; 0 = off, -1 = auto-pick)",
    )
    p.add_argument("--load-concurrency", type=int, default=0, help="0 = unlimited")
    p.add_argument("--coordinator", action="store_true", help="Run as changelog coordinator")
    p.add_argument(
        "--coordinator-dir",
        default=None,
        help="Coordinator mode: persist the changelog here (default: memory only)",
    )
    p.add_argument("--coordinator-url", default=None, help="Replica mode: consume this changelog")
    p.add_argument("--peers", default=None, help="Comma-separated peer base URLs (snapshot donors)")
    p.add_argument("--bootstrap-timeout-ms", type=int, default=1_800_000, help="0 disables")
    p.add_argument("--profile-port", type=int, default=0, help="XLA profiler gRPC port (0 = off)")
    p.add_argument(
        "--mesh-shards",
        type=int,
        default=0,
        help="Serve search hash-range-sharded over an N-device mesh (0 = single device)",
    )
    return p


def run_server(args) -> None:
    from .multi.multi_index import MultiIndex
    from .server.app import App
    from .server.http import HttpServer

    if args.profile_port:
        from .utils.profiling import start_profiler_server

        start_profiler_server(args.profile_port)

    searcher = None
    if args.mesh_shards:
        from .parallel.serving import ShardedBatchingSearcher

        searcher = ShardedBatchingSearcher(n_shards=args.mesh_shards)
        logging.info("search sharded over %d devices", searcher.n_shards)

    mi = MultiIndex.open(
        args.dir,
        checkpoint_threshold=args.checkpoint_threshold,
        checkpoint_age=(args.checkpoint_age_ms / 1000.0) if args.checkpoint_age_ms else None,
        sync=args.coordinator_url is None,  # upstream owns durability in cluster mode
        load_concurrency=args.load_concurrency or None,
        searcher=searcher,
    )

    replicator = None
    if args.coordinator_url:
        from .cluster.remote_coordinator import RemoteCoordinator
        from .cluster.replicator import Replicator

        peers = [u.strip() for u in (args.peers or "").split(",") if u.strip()]
        coordinator = RemoteCoordinator(args.coordinator_url)
        replicator = Replicator(
            mi,
            coordinator,
            peers=peers,
            bootstrap_timeout=(args.bootstrap_timeout_ms / 1000.0) if args.bootstrap_timeout_ms else None,
        )
        mi.replication = replicator
        replicator.start()

    import jax

    devices = jax.devices()
    device = {"platform": devices[0].platform, "kind": devices[0].device_kind, "count": len(devices)}
    logging.info("devices: %s", device)
    print(f"DEVICE {json.dumps(device)}", flush=True)

    app = App(mi)
    server = HttpServer(args.host, args.port, app.router, app.error_response, app.not_found)
    logging.info("serving on %s:%d (dir=%s)", args.host, server.port, args.dir)
    print(f"LISTENING {server.port}", flush=True)

    # Warm the search programs for each open index in the background so the
    # first real query doesn't pay the compile (the persistent XLA cache
    # makes this near-instant on later restarts).
    def warm():
        from .multi.multi_index import SearchRequestParams

        # Tracing holds the GIL in long stretches; let the listener answer
        # its first health probes before the compile churn starts.
        threading.Event().wait(2.0)
        for name in mi.index_names():
            try:
                mi.search(name, SearchRequestParams(query=[1, 2, 3], timeout=0))
                ref = mi._get_ref(name)
                try:
                    snapshot = ref.index.acquire_reader()
                    if snapshot.num_docs() and hasattr(ref.index.searcher, "warm"):
                        ref.index.searcher.warm(snapshot)
                finally:
                    mi._release_ref(ref)
            except Exception:
                logging.debug("warmup search failed for %r", name, exc_info=True)

    threading.Thread(target=warm, daemon=True, name="warmup").start()

    legacy_server = None
    if args.legacy_port:
        from .server.legacy import LegacyServer

        legacy_server = LegacyServer(args.host, args.legacy_port, mi, read_only=replicator is not None)
        legacy_server.serve_background()

    native_front = None
    if args.search_port:
        from .server.native_front import NativeFront

        native_front = NativeFront(mi, max(args.search_port, 0))  # -1 = bind port 0
        native_front.start()
        logging.info("native search plane on 127.0.0.1:%d", native_front.port)
        print(f"SEARCHPLANE {native_front.port}", flush=True)  # port-0 binds resolve here

    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    server.serve_background()
    stop.wait()
    logging.info("shutting down")
    server.shutdown()
    if native_front is not None:
        native_front.stop()
    if legacy_server is not None:
        legacy_server.shutdown()
    if replicator is not None:
        replicator.stop()
    mi.close()
    if hasattr(mi.searcher, "close"):
        mi.searcher.close()  # join the dispatch/collect/precompile threads
    # All durability work is behind us (WAL synced, manifests written).
    # Skip interpreter finalization: daemon threads can still be inside XLA
    # C++ (a warmup compile, a stale device_get), and tearing the
    # interpreter down under them aborts/segfaults the process (observed:
    # "FATAL: exception not rethrown" on SIGTERM right after heavy
    # checkpoint+search activity).  _exit reports the clean shutdown the
    # operator should see.
    logging.shutdown()
    os._exit(0)


def run_coordinator(args) -> None:
    from .cluster.coordinator import MemoryCoordinator
    from .cluster.coordinator_server import CoordinatorApp
    from .server.http import HttpServer

    if args.coordinator_dir:
        from .cluster.file_coordinator import FileCoordinator

        coordinator = FileCoordinator(args.coordinator_dir)
        logging.info("durable changelog in %s", args.coordinator_dir)
    else:
        coordinator = MemoryCoordinator()
    app = CoordinatorApp(coordinator)
    server = HttpServer(args.host, args.port, app.router, app.error_response, app.not_found)
    logging.info("coordinator on %s:%d", args.host, server.port)
    print(f"LISTENING {server.port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    server.serve_background()
    stop.wait()
    server.shutdown()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args, unknown = build_parser().parse_known_args(argv)
    for flag in unknown:
        logging.warning("ignoring unknown flag: %s", flag)
    if args.coordinator:
        run_coordinator(args)
    else:
        run_server(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
