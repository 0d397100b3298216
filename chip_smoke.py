#!/usr/bin/env python3
"""Bring-up smoke test: the search server on a GPU, end to end.

    python chip_smoke.py              # one card, the full path
    python chip_smoke.py --cards 4    # the --mesh-shards 4 serving path only

One card runs, in order (each JAX phase in a child process of its own, so
only one process ever holds the card):

  program — builds the --docs corpus (default 10M fingerprints x 24 hashes,
            240M postings, ~1.9 GB interleaved) on the card, compiles the
            batched search program, checks its self-retrieval and its
            blocked range phase against a bounded binary search over the
            whole table (exact), and times both per batch;
  server  — `python -m acoustid_index.main` with JAX_PLATFORMS=cuda:
            bulk ingest of the corpus over POST /main/_bulk, the checkpoint
            (a device merge: any host-merge fallback fails the run),
            memory-tier inserts, updates and deletes over /_update, 64
            queries (20 target + 100 noise hashes, limit 40, min_score
            ceil(|q|/20), score_pct 10) on the Python port and on the native
            search plane, then a restart on the same directory and more
            queries.  Every answer must equal, ids and scores, a plain numpy
            reference of the engine's search semantics built on the host
            from the same seed.

The last stdout line is {"ok": true, "device": {...}} with the device as
the server's JAX reports it; any failure exits non-zero without it.
`--cpu-rehearsal` runs the same phases on the CPU backend at a small
--docs and prints no result line.
"""

from __future__ import annotations

import argparse
import http.client
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HASHES_PER_DOC = 24
TARGET_HASHES = 20
NOISE_HASHES = 100
N_QUERIES = 64
N_RESTART_QUERIES = 16
LIMIT = 40
SCORE_PCT = 10
BULK_DOCS = 100_000  # 9.6 MB of hashes per POST, under the server's 16 MiB body cap
BATCH = 256  # program-phase batch (the serving program's largest batch bucket)
TIME_CALLS = 50
SEARCH_TIMEOUT_MS = 10_000


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def doc_hashes(ids: np.ndarray, n: int = HASHES_PER_DOC) -> np.ndarray:
    """The corpus: deterministic per-doc hash sets in wrapping u32
    arithmetic (the program phase evaluates the same formula on the card)."""
    j = np.arange(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = ids.astype(np.uint32)[:, None] * np.uint32(2654435761)
        h = h + j[None, :] * np.uint32(0x27D4EB2F) + np.uint32(12345)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(16))
    return h.astype(np.uint32)


def make_query(rng, hashes) -> np.ndarray:
    target = rng.choice(np.asarray(hashes, np.uint32), min(TARGET_HASHES, len(hashes)), replace=False)
    noise = rng.integers(0, 2**32, NOISE_HASHES, dtype=np.uint32)
    return np.unique(np.concatenate([target, noise]))


# ---------------------------------------------------------------- reference


class Reference:
    """The engine's search semantics (tests/oracle.py: per-posting hit
    counts, newest segment wins, superseded and deleted docs dropped,
    score desc / id asc, min_score and the best-anchored score_pct cutoff,
    limit) over the corpus plus the changed docs, in numpy."""

    def __init__(self, n_docs: int):
        keys = []
        for lo in range(1, n_docs + 1, 1_000_000):
            ids = np.arange(lo, min(lo + 1_000_000, n_docs + 1), dtype=np.uint32)
            h = doc_hashes(ids).astype(np.uint64)
            keys.append(((h << np.uint64(32)) | ids.astype(np.uint64)[:, None]).reshape(-1))
        self.keys = np.sort(np.concatenate(keys))
        self.changed = {}  # doc id -> current hashes (tuple) or None (deleted)

    def apply(self, changes) -> None:
        for c in changes:
            if "insert" in c:
                self.changed[c["insert"]["id"]] = tuple(c["insert"]["hashes"])
            else:
                self.changed[c["delete"]["id"]] = None

    def search(self, query: np.ndarray, min_score: int):
        q = np.unique(query.astype(np.uint64))
        lo = np.searchsorted(self.keys, q << np.uint64(32))
        hi = np.searchsorted(self.keys, (q << np.uint64(32)) | np.uint64(0xFFFFFFFF), side="right")
        docs = np.concatenate([self.keys[a:b] for a, b in zip(lo, hi)] or [np.empty(0, np.uint64)])
        ids, counts = np.unique((docs & np.uint64(0xFFFFFFFF)).astype(np.int64), return_counts=True)
        scores = dict(zip(ids.tolist(), counts.tolist()))
        qset = set(int(x) for x in q)
        for doc, hashes in self.changed.items():
            scores.pop(doc, None)
            if hashes is not None:
                s = sum(1 for h in hashes if h in qset)
                if s:
                    scores[doc] = s
        cands = sorted(((d, s) for d, s in scores.items() if s >= min_score), key=lambda t: (-t[1], t[0]))
        out, ms = [], min_score
        for d, s in cands:
            if len(out) == LIMIT or s < ms:
                break
            if not out:
                ms = max(ms, s * SCORE_PCT // 100)
            out.append((d, s))
        return out


# ------------------------------------------------------------------- server


class Server:
    def __init__(self, data_dir: str, env: dict, extra_args, log_path: str):
        cmd = [
            sys.executable, "-m", "acoustid_index.main",
            "--dir", data_dir, "--port", "0", "--search-port", "-1",
        ] + list(extra_args)
        self.log_file = open(log_path, "ab")
        self.proc = subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=self.log_file, text=True,
            start_new_session=True,
        )
        self.lines = {}
        self._ready = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            word, _, rest = line.strip().partition(" ")
            if word in ("LISTENING", "SEARCHPLANE", "DEVICE"):
                self.lines[word] = rest
            if {"LISTENING", "SEARCHPLANE"} <= set(self.lines):
                self._ready.set()
        self._ready.set()

    def wait_ready(self, timeout: float) -> None:
        if not self._ready.wait(timeout) or self.proc.poll() is not None:
            raise PhaseError(f"server did not come up (rc={self.proc.poll()}, lines={self.lines})")
        self.py = http.client.HTTPConnection("127.0.0.1", int(self.lines["LISTENING"]), timeout=600)
        self.native = http.client.HTTPConnection("127.0.0.1", int(self.lines["SEARCHPLANE"]), timeout=600)

    def device(self) -> dict:
        return json.loads(self.lines["DEVICE"])

    def stop(self, timeout: float = 180.0) -> int:
        try:
            if self.proc.poll() is None:
                self.proc.send_signal(signal.SIGTERM)
                try:
                    self.proc.wait(timeout)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()
                    raise PhaseError("server ignored SIGTERM")
        finally:
            reap_group(self.proc.pid)
            self.log_file.close()
        return self.proc.returncode


def call(conn, method: str, path: str, body=None, ctype="application/json"):
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    headers = {"Content-Type": ctype, "Accept": "application/json"} if body is not None else {}
    conn.request(method, path, body=body, headers=headers)
    r = conn.getresponse()
    return r.status, r.read()


def search(conn, query: np.ndarray, min_score: int, deadline: float):
    body = {
        "query": [int(x) for x in query],
        "limit": LIMIT,
        "min_score": min_score,
        "score_pct": SCORE_PCT,
        "timeout": SEARCH_TIMEOUT_MS,
    }
    while True:
        status, data = call(conn, "POST", "/main/_search", body)
        if status == 200:
            return [(r["id"], r["score"]) for r in json.loads(data)["results"]]
        if status != 503 or time.time() > deadline:
            raise PhaseError(f"search answered {status}: {data[:200]!r}")
        time.sleep(0.5)  # a program still compiling; retry


def metrics(conn) -> dict:
    status, data = call(conn, "GET", "/_metrics")
    if status != 200:
        raise PhaseError(f"/_metrics answered {status}")
    out = {}
    for line in data.decode().splitlines():
        if line and not line.startswith("#") and "{" not in line:
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def check_queries(server, ref, queries, label: str, deadline: float) -> None:
    for port, conn in (("python", server.py), ("native", server.native)):
        for k, q in enumerate(queries):
            min_score = math.ceil(len(q) / 20)
            got = search(conn, q, min_score, deadline)
            want = ref.search(q, min_score)
            if got != want:
                raise PhaseError(f"{label} query {k} on the {port} port: {got[:5]} != {want[:5]}")


# ----------------------------------------------------------- program phase


def program_phase(args) -> None:
    """Child process: the batched search program compiled for the card on
    the smoke's corpus built there; its range phase checked against a
    bounded binary search over the whole table, and timed."""
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu_rehearsal:
        raise PhaseError(f"no GPU: JAX reports {dev.platform}")
    from acoustid_index.engine.searcher import _params_for
    from acoustid_index.ops import search_kernel
    from acoustid_index.ops.binsearch import lower_bound, steps_for, upper_bound
    from acoustid_index.ops.block_lookup import tier_ranges_blocked
    from acoustid_index.ops.build import sort_postings
    from acoustid_index.ops.layout import BLOCK, interleave_jnp

    n_docs = args.docs
    n_post = n_docs * HASHES_PER_DOC
    cap = 1 << max(n_post - 1, 1).bit_length()
    mcap = 1 << max(n_docs - 1, 1).bit_length()

    @jax.jit
    def make_table():
        ids = jnp.arange(1, n_docs + 1, dtype=jnp.uint32)
        j = jnp.arange(HASHES_PER_DOC, dtype=jnp.uint32)
        h = ids[:, None] * jnp.uint32(2654435761)
        h = h + j[None, :] * jnp.uint32(0x27D4EB2F) + jnp.uint32(12345)
        h = h ^ (h >> jnp.uint32(13))
        h = h * jnp.uint32(0x85EBCA6B)
        h = h ^ (h >> jnp.uint32(16))
        docids = jnp.broadcast_to(ids[:, None], h.shape).reshape(-1)
        hs, ds = sort_postings(h.reshape(-1), docids, n_post)
        hp = jnp.full((cap,), 0xFFFFFFFF, jnp.uint32).at[:n_post].set(hs)
        dp = jnp.full((cap,), 0xFFFFFFFF, jnp.uint32).at[:n_post].set(ds)
        mention = jnp.full((mcap,), 0xFFFFFFFF, jnp.uint32).at[:n_docs].set(ids)
        return interleave_jnp(hp, dp), hp, mention

    t0 = time.time()
    inter, hashes, mention = jax.block_until_ready(make_table())
    build_s = time.time() - t0
    file_tier = {
        "inter": inter,
        "block_index": hashes[::BLOCK],
        "seg_start": jnp.zeros(1, jnp.int32),
        "seg_len": jnp.full(1, n_post, jnp.int32),
        "mention_ids": mention,
        "mention_len": jnp.int32(n_docs),
    }
    mem_tier = {
        "hashes": jnp.full(1024, 0xFFFFFFFF, jnp.uint32),
        "docids": jnp.full(1024, 0xFFFFFFFF, jnp.uint32),
        "block_index": jnp.full(1, 0xFFFFFFFF, jnp.uint32),
        "seg_start": jnp.zeros(1, jnp.int32),
        "seg_len": jnp.zeros(1, jnp.int32),
        "mention_ids": jnp.full(1024, 0xFFFFFFFF, jnp.uint32),
        "mention_len": jnp.int32(0),
    }

    params = _params_for(128)
    rng = np.random.default_rng(args.seed + 1)
    batches, targets = [], []
    for _ in range(4):
        t = rng.integers(1, n_docs + 1, BATCH)
        qs = np.zeros((BATCH, params.query_len), np.uint32)
        lens = np.zeros(BATCH, np.int32)
        ms = np.zeros(BATCH, np.int32)
        for b, hs in enumerate(doc_hashes(t.astype(np.uint32))):
            q = make_query(rng, hs)
            qs[b, : len(q)], lens[b], ms[b] = q, len(q), math.ceil(len(q) / 20)
        pin = search_kernel.pack_inputs_np(
            qs, lens, np.full(BATCH, LIMIT, np.int32), ms, np.full(BATCH, SCORE_PCT, np.int32)
        )
        valid = np.arange(params.query_len)[None, :] < lens[:, None]
        batches.append((jax.device_put(pin), jnp.asarray(qs), jnp.asarray(valid)))
        targets.append(t)

    search_fn = search_kernel.search_segments_batch_packed_io.__wrapped__
    t0 = time.time()
    program = jax.jit(lambda ft, mt, pin: search_fn(params, ft, mt, pin)).lower(
        file_tier, mem_tier, batches[0][0]
    ).compile()
    compile_s = time.time() - t0
    ranges = jax.jit(
        lambda ft, q, v: tier_ranges_blocked(ft, q, v, params.per_hash_cap, emit=True)[:3]
    ).lower(file_tier, batches[0][1], batches[0][2]).compile()
    steps = steps_for(cap)
    reference = jax.jit(
        lambda h, q: (
            lower_bound(h, q, jnp.int32(0), jnp.int32(n_post), steps=steps),
            upper_bound(h, q, jnp.int32(0), jnp.int32(n_post), steps=steps),
        )
    )

    outs = [np.asarray(program(file_tier, mem_tier, b[0])) for b in batches]
    hit = np.mean(np.concatenate([o[:, 0] == t for o, t in zip(outs, targets)]))
    if hit < 0.95:
        raise PhaseError(f"self-retrieval hit rate {hit}")
    for _, q, v in batches:
        lo, cnt, trunc = (np.asarray(x) for x in ranges(file_tier, q, v))
        want_lo, want_hi = (np.asarray(x) for x in reference(hashes, q))
        v = np.asarray(v)
        want_cnt = np.where(v, want_hi - want_lo, 0)
        if bool(trunc) or not np.array_equal(cnt, want_cnt) or not np.array_equal(
            lo[want_cnt > 0], want_lo[want_cnt > 0]
        ):
            raise PhaseError("blocked range phase differs from the whole-table binary search")

    def timed(fn, argsets):
        ts = []
        for r in range(TIME_CALLS):
            a = argsets[r % len(argsets)]
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1000.0

    search_ms = timed(program, [(file_tier, mem_tier, b[0]) for b in batches])
    range_ms = timed(ranges, [(file_tier, b[1], b[2]) for b in batches])
    stats = dev.memory_stats() or {}
    print("PROGRAM " + json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
        "docs": n_docs, "postings": n_post, "batch": BATCH, "query_bucket": params.query_len,
        "hit_rate": float(hit), "table_build_s": build_s, "compile_s": compile_s,
        "search_batch_ms": search_ms, "range_phase_ms": range_ms,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }), flush=True)


# --------------------------------------------------------------- the smoke


def reap_group(pid: int) -> None:
    """Kill whatever a child left behind in its session (a compiler
    subprocess still running when the child exited)."""
    try:
        os.killpg(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def run_child(cmd, env, timeout: float, label: str) -> str:
    t0 = time.time()
    p = subprocess.Popen(
        cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        reap_group(p.pid)
        if p.poll() is None:
            p.wait()
    sys.stderr.write(err[-4000:])
    if p.returncode != 0:
        sys.stderr.write(out[-4000:])
        raise PhaseError(f"{label} exited {p.returncode}")
    print(f"phase {label}: {time.time() - t0:.1f}s", flush=True)
    return out


def updates(rng, n_docs: int):
    """Two _update batches: new docs, re-inserted (updated) docs, deletes,
    and within-memory-tier supersession (a new doc deleted, an updated doc
    updated again)."""
    pick = rng.choice(np.arange(1, n_docs + 1), 24, replace=False).tolist()
    new_ids = list(range(n_docs + 1, n_docs + 9))
    fresh = lambda: [int(x) for x in rng.integers(0, 2**32, HASHES_PER_DOC, dtype=np.uint32)]
    first = [{"insert": {"id": i, "hashes": fresh()}} for i in new_ids + pick[:8]]
    second = [{"delete": {"id": i}} for i in pick[8:16] + new_ids[:1]]
    second += [{"insert": {"id": pick[0], "hashes": fresh()}}]
    return [first, second], pick, new_ids


def smoke(args) -> dict:
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["JAX_PLATFORMS"] = "cpu" if args.cpu_rehearsal else "cuda"
    rng = np.random.default_rng(args.seed)
    n_docs = args.docs
    work = os.path.join(ROOT, ".smoke_data")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    server_log = os.path.join(work, "server.log")

    t0 = time.time()
    ref_box = {}
    ref_thread = threading.Thread(target=lambda: ref_box.setdefault("ref", Reference(n_docs)), daemon=True)
    ref_thread.start()

    if args.cpu_rehearsal and args.cards > 1:
        env["AITPU_HOST_DEVICE_COUNT"] = str(args.cards)
    if args.cards == 1:
        out = run_child(
            [sys.executable, os.path.abspath(__file__), "--phase", "program", "--docs", str(n_docs),
             "--seed", str(args.seed)] + (["--cpu-rehearsal"] if args.cpu_rehearsal else []),
            env, 900, "program",
        )
        k = json.loads(next(l for l in out.splitlines() if l.startswith("PROGRAM "))[8:])
        print(f"search program on {k['device']['kind']}, {k['docs']} docs, batch {k['batch']}: "
              f"{k['search_batch_ms']:.4f} ms per batch (range phase {k['range_phase_ms']:.4f} ms), "
              f"compile {k['compile_s']:.1f}s, table build {k['table_build_s']:.1f}s, "
              f"peak bytes {k['peak_bytes_in_use']}, range phase exact", flush=True)

    extra = ["--checkpoint-threshold", str(n_docs * HASHES_PER_DOC - 1), "--checkpoint-age-ms", "0"]
    if args.cards > 1:
        extra += ["--mesh-shards", str(args.cards)]
    deadline = time.time() + 1000
    phase_t = time.time()
    server = Server(os.path.join(work, "index"), env, extra, server_log)
    try:
        server.wait_ready(300)
        device = server.device()
        print(f"phase start: {time.time() - phase_t:.1f}s ({device})", flush=True)

        phase_t = time.time()
        from acoustid_index.utils import mpack

        status, data = call(server.py, "PUT", "/main", {})
        if status != 200:
            raise PhaseError(f"create index answered {status}")
        for lo in range(1, n_docs + 1, BULK_DOCS):
            ids = np.arange(lo, min(lo + BULK_DOCS, n_docs + 1), dtype=np.uint32)
            body = mpack.packb({"i": ids.tobytes(), "h": doc_hashes(ids).tobytes(), "k": HASHES_PER_DOC})
            status, data = call(server.py, "POST", "/main/_bulk", body, "application/vnd.msgpack")
            if status != 200:
                raise PhaseError(f"bulk ingest answered {status}: {data[:200]!r}")
        print(f"phase ingest: {time.time() - phase_t:.1f}s ({n_docs} docs)", flush=True)

        phase_t = time.time()
        while metrics(server.py).get("aitpu_checkpoints_total", 0) < 1:
            if time.time() > deadline or server.proc.poll() is not None:
                raise PhaseError("no checkpoint")
            time.sleep(1.0)
        m = metrics(server.py)
        if m.get("aitpu_device_merge_fallbacks_total", 0) != 0:
            raise PhaseError(f"{m['aitpu_device_merge_fallbacks_total']:.0f} device merges fell back to the host")
        if m.get("aitpu_device_merges_total", 0) < 1:
            raise PhaseError("the checkpoint did not take the device merge")
        print(f"phase checkpoint: {time.time() - phase_t:.1f}s "
              f"(device merges {m['aitpu_device_merges_total']:.0f}, host fallbacks 0)", flush=True)

        phase_t = time.time()
        batches, picked, new_ids = updates(rng, n_docs)
        ref_thread.join()
        ref = ref_box["ref"]
        for changes in batches:
            status, data = call(server.py, "POST", "/main/_update", {"changes": changes})
            if status != 200:
                raise PhaseError(f"_update answered {status}: {data[:200]!r}")
            ref.apply(changes)
        print(f"phase memory-tier writes: {time.time() - phase_t:.1f}s "
              f"(reference ready {time.time() - t0:.1f}s after start)", flush=True)

        # Targets: random corpus docs, updated docs (by their new hashes,
        # and four by their old ones), deleted docs and new docs.
        def hashes_of(doc, current=True):
            h = ref.changed.get(doc) if current else None  # None: deleted
            return h if h is not None else doc_hashes(np.array([doc], np.uint32))[0]

        targets = [int(x) for x in rng.integers(1, n_docs + 1, N_QUERIES - 24)]
        queries = [make_query(rng, hashes_of(t)) for t in targets + picked[:16] + new_ids]
        queries += [make_query(rng, hashes_of(t, current=False)) for t in picked[:4]]

        phase_t = time.time()
        check_queries(server, ref, queries, "serving", deadline)
        print(f"phase queries: {time.time() - phase_t:.1f}s ({len(queries)} queries x 2 ports, exact)", flush=True)
        m = metrics(server.py)
        if m.get("aitpu_device_merge_fallbacks_total", 0) != 0:
            raise PhaseError("a device merge fell back to the host")

        if args.cards == 1:
            phase_t = time.time()
            rc = server.stop()
            if rc != 0:
                raise PhaseError(f"server exited {rc} on SIGTERM")
            server = Server(os.path.join(work, "index"), env, extra, server_log)
            server.wait_ready(300)
            check_queries(server, ref, queries[:N_RESTART_QUERIES], "restart", deadline)
            print(f"phase restart: {time.time() - phase_t:.1f}s ({N_RESTART_QUERIES} queries x 2 ports, exact)", flush=True)
            device = server.device()
    finally:
        rc = server.stop()
    if rc != 0:
        raise PhaseError(f"server exited {rc} on SIGTERM")
    shutil.rmtree(work, ignore_errors=True)
    print(f"total: {time.time() - t0:.1f}s", flush=True)
    return device


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4), help="4: the --mesh-shards 4 path only")
    p.add_argument("--docs", type=int, default=10_000_000, help="corpus fingerprints (24 hashes each)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu-rehearsal", action="store_true", help="run on the CPU backend; prints no result")
    p.add_argument("--phase", choices=("program",), help=argparse.SUPPRESS)
    args = p.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "acoustid_index")):
        log("chip_smoke: the acoustid_index package is not beside this script")
        return 2
    sys.path.insert(0, ROOT)
    try:
        if args.phase == "program":
            program_phase(args)
            return 0
        if not args.cpu_rehearsal:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60,
            )
            cards = [l for l in smi.stdout.splitlines() if l.strip()]
            if smi.returncode != 0 or len(cards) < args.cards:
                log(f"chip_smoke: need {args.cards} GPU(s); nvidia-smi rc={smi.returncode}")
                return 2
            print("card (name, power limit):", flush=True)
            for line in cards:
                print(line, flush=True)
        device = smoke(args)
    except (PhaseError, subprocess.TimeoutExpired, OSError) as exc:
        log(f"chip_smoke: FAILED: {exc}")
        return 1
    if args.cpu_rehearsal:
        log(f"chip_smoke: CPU rehearsal passed ({device})")
        return 3
    if device["platform"] != "gpu" or device["count"] != args.cards:
        log(f"chip_smoke: server ran on {device}, wanted {args.cards} GPU(s)")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
