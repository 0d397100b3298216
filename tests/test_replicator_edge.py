"""Replicator edge cases mirroring the reference's unit matrix
(Replicator.zig tests): poison-op parking, corpus-stream retry (a transient
failure must never degrade to an incomplete replay), and three-replica
convergence."""

import threading
import time

import pytest

from acoustid_index.cluster.coordinator import BootstrapStream, MemoryCoordinator
from acoustid_index.cluster.replicator import Replicator
from acoustid_index.engine import errors
from acoustid_index.engine.model import Insert
from acoustid_index.multi.multi_index import MultiIndex, SearchRequestParams

from test_replication import Node, search_ids


def test_three_replicas_converge(tmp_path):
    coordinator = MemoryCoordinator()
    nodes = [Node(tmp_path / f"n{i}", coordinator) for i in range(3)]
    try:
        nodes[0].mi.create_index("idx")
        for n in nodes:
            n.wait_exists("idx")
        v = 0
        for i, n in enumerate(nodes):  # writes from every node interleaved
            v = n.mi.update("idx", [Insert(id=10 + i, hashes=[10 + i, 999])])
        for n in nodes:
            n.wait_version("idx", v)
        want = search_ids(nodes[0], "idx", [999])
        assert len(want) == 3
        for n in nodes[1:]:
            assert search_ids(n, "idx", [999]) == want
    finally:
        for n in nodes:
            n.close()


def test_poison_meta_op_does_not_wedge_others(tmp_path):
    """A create that keeps failing must be parked and retried without
    blocking reconciliation of other indexes."""
    coordinator = MemoryCoordinator()
    mi = MultiIndex.open(str(tmp_path / "node"), checkpoint_age=None, sync=False)
    repl = Replicator(mi, coordinator, ryw_timeout=10.0)
    mi.replication = repl

    real_reconcile = mi.reconcile_create
    fail_until = [time.monotonic() + 1.5]

    def flaky(name, generation):
        if name == "poison" and time.monotonic() < fail_until[0]:
            raise RuntimeError("injected reconcile failure")
        return real_reconcile(name, generation)

    mi.reconcile_create = flaky
    repl.start()
    try:
        coordinator.create_index("poison")
        coordinator.create_index("healthy")
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not mi.check_index_exists("healthy"):
            time.sleep(0.05)
        assert mi.check_index_exists("healthy")  # not wedged behind the poison op
        # The parked poison op is retried once the failure clears.
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not mi.check_index_exists("poison"):
            time.sleep(0.1)
        assert mi.check_index_exists("poison")
    finally:
        repl.stop()
        mi.close()


class FlakyThenGoodCoordinator(MemoryCoordinator):
    """open_bootstrap fails twice, then serves the corpus."""

    def __init__(self, corpus):
        super().__init__(bootstrap_corpus=corpus)
        self.attempts = 0

    def open_bootstrap(self, index_name, generation):
        self.attempts += 1
        if self.attempts <= 2:
            raise errors.CoordinatorError("injected transient failure")
        return super().open_bootstrap(index_name, generation)


def test_corpus_seed_retries_instead_of_incomplete_replay(tmp_path):
    corpus = {("idx", 1): (40, [[Insert(id=i, hashes=[i, 321]) for i in range(1, 8)]])}
    coordinator = FlakyThenGoodCoordinator(corpus)
    node = Node(tmp_path / "a", coordinator)
    try:
        node.mi.create_index("idx")
        node.wait_exists("idx")
        node.wait_version("idx", 40, timeout=30)  # installed at the stream position
        assert coordinator.attempts >= 3  # retried through the failures
        assert len(search_ids(node, "idx", [321])) == 7  # full corpus, not a replay
    finally:
        node.close()


def test_truncated_corpus_stream_never_installs(tmp_path):
    """A stream that dies before its end marker must raise, not install a
    partial corpus (BootstrapStream contract)."""

    class TruncatingStream(BootstrapStream):
        position = 50

        def __init__(self):
            self.sent = 0

        def next_batch(self):
            if self.sent == 0:
                self.sent = 1
                return [Insert(id=1, hashes=[1])]
            raise errors.CoordinatorError("transport died mid-stream")

    mi = MultiIndex.open(str(tmp_path / "n"), checkpoint_age=None, sync=False)
    try:
        mi.create_index("idx")
        with pytest.raises(errors.CoordinatorError):
            mi.bootstrap_lineage_from_source("idx", 1, TruncatingStream())
        # The live index is untouched (still empty at version 0).
        assert mi.get_peer_status("idx")["version"] == 0
    finally:
        mi.close()


def test_wedged_peer_probe_is_bounded(monkeypatch):
    """A listening-but-never-accepting peer (peers.zig:387-453) must not
    wedge donor discovery: the probe times out and the peer is skipped."""
    import socket

    from acoustid_index.cluster import peers as peers_mod

    wedged = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    wedged.bind(("127.0.0.1", 0))
    wedged.listen(1)  # handshake completes via the backlog; no accept, no bytes
    port = wedged.getsockname()[1]
    monkeypatch.setattr(peers_mod, "PROBE_TIMEOUT", 0.5)
    try:
        t0 = time.monotonic()
        donors = peers_mod.find_donors([f"http://127.0.0.1:{port}"], "idx", 1, 0)
        took = time.monotonic() - t0
        assert donors == []
        assert took < 5.0, f"probe not bounded: {took:.1f}s"
    finally:
        wedged.close()


def test_dripping_snapshot_donor_trips_backstop(tmp_path):
    """A donor that accepts and then drips the snapshot forever must trip
    the WHOLE-TRANSFER backstop (Replicator.zig:62-69): the per-socket-op
    timeout never fires (bytes keep arriving), so only an absolute deadline
    over the entire transfer can unwedge the consumer."""
    import socket

    stop_evt = threading.Event()

    def dripper(server):
        conn, _ = server.accept()
        conn.recv(65536)
        conn.sendall(
            b"HTTP/1.1 200 OK\r\nContent-Type: application/octet-stream\r\n"
            b"Content-Length: 1000000\r\n\r\n"
        )
        # One byte every 100ms: a per-socket-op read timeout never trips.
        try:
            while not stop_evt.is_set():
                conn.sendall(b"x")
                stop_evt.wait(0.1)
        except OSError:
            pass
        finally:
            conn.close()

    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    port = server.getsockname()[1]
    t = threading.Thread(target=dripper, args=(server,), daemon=True)
    t.start()

    coordinator = MemoryCoordinator()
    mi = MultiIndex.open(str(tmp_path / "n"), checkpoint_age=None, sync=False)
    repl = Replicator(mi, coordinator, bootstrap_timeout=1.0)
    try:
        mi.create_index("idx")

        from acoustid_index.cluster.peers import Donor

        donor = Donor(base_url=f"http://127.0.0.1:{port}", generation=1, version=5, file_version=5)
        consumer = repl._consumers.get("idx")
        if consumer is None:
            from acoustid_index.cluster.replicator import _Consumer

            consumer = _Consumer(name="idx", generation=1)
        t0 = time.monotonic()
        got = repl._fetch_snapshot(consumer, donor)
        took = time.monotonic() - t0
        assert got is None  # transfer aborted, not installed
        assert took < 10.0, f"backstop did not fire: {took:.1f}s"
        assert took >= 0.9  # it really streamed until the deadline
    finally:
        stop_evt.set()
        repl.stop()
        mi.close()
        server.close()


def test_dripping_corpus_stream_trips_backstop():
    """Same backstop over the corpus stream: a feed yielding batches forever
    must be cut at the absolute deadline, not trusted to finish."""
    from acoustid_index.cluster.replicator import _DeadlineStream

    class ForeverStream(BootstrapStream):
        position = 10

        def next_batch(self):
            time.sleep(0.05)
            return [Insert(id=1, hashes=[1])]

        def close(self):
            pass

    wrapped = _DeadlineStream(ForeverStream(), time.monotonic() + 0.3, "corpus")
    with pytest.raises(errors.ReplicationTimeout):
        for _ in range(1000):
            wrapped.next_batch()
