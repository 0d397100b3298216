"""Durable coordinator: restart resumes the exact acknowledged state.

The reference's built-in coordinator is memory-only (Coordinator.zig); the
FileCoordinator adds crash-safe persistence with the WAL's framing, so
these tests pin the recovery semantics: full-state reopen, torn-tail
recovery, rejected appends writing nothing, compaction correctness, and
stale-log cleanup after a crash mid-compaction."""

import os
import time

import pytest

from acoustid_index.cluster.file_coordinator import FileCoordinator
from acoustid_index.engine import errors
from acoustid_index.engine.model import Delete, Insert, SetMetadata


def mk(path, **kw):
    return FileCoordinator(str(path), sync=False, **kw)


def past():
    return time.monotonic() - 1.0


def fill(c):
    gen = c.create_index("main")
    c.append("main", gen, [Insert(1, (10, 20)), Insert(2, (30,))], expected=None)
    c.append("main", gen, [Delete(1)], expected=2)
    c.append("main", gen, [SetMetadata((("k", "v"),))], expected=3)
    gen2 = c.create_index("other")
    c.append("other", gen2, [Insert(7, (70,))], expected=None)
    c.delete_index("other")
    return gen, gen2


def assert_state(c, gen, gen2):
    assert c.active_indexes() == {"main": gen}
    assert c.last_seq("main", gen) == 4
    entries = c.read("main", gen, after=0, max_entries=100, deadline=past())
    assert [e.id for e in entries] == [1, 2, 3, 4]
    assert entries[0].change == Insert(1, (10, 20))
    assert entries[2].change == Delete(1)
    assert entries[3].change == SetMetadata((("k", "v"),))
    meta = c.read_meta(after=0, max_ops=100, deadline=past())
    assert [(m.pos, m.kind, m.index_name) for m in meta] == [
        (1, "create", "main"),
        (2, "create", "other"),
        (3, "delete", "other"),
    ]
    # deleted lineage's history is still readable (generation-scoped feeds)
    assert c.last_seq("other", gen2) == 1


def test_reopen_restores_state(tmp_path):
    c = mk(tmp_path)
    gen, gen2 = fill(c)
    c.close()

    c2 = mk(tmp_path)
    assert_state(c2, gen, gen2)
    # appends continue the seq after reopen, and expected still validates
    assert c2.append("main", gen, [Insert(9, (90,))], expected=4) == 5
    with pytest.raises(errors.VersionMismatch):
        c2.append("main", gen, [Insert(10, (1,))], expected=4)
    c2.close()


def test_retention_floor_survives(tmp_path):
    c = mk(tmp_path)
    gen, _ = fill(c)
    c.set_retention_floor("main", gen, 2)
    c.close()

    c2 = mk(tmp_path)
    with pytest.raises(errors.BelowRetention):
        c2.read("main", gen, after=1, max_entries=10, deadline=past())
    entries = c2.read("main", gen, after=2, max_entries=10, deadline=past())
    assert [e.id for e in entries] == [3, 4]
    c2.close()


def test_rejected_append_writes_nothing(tmp_path):
    c = mk(tmp_path)
    gen = c.create_index("main")
    c.append("main", gen, [Insert(1, (1,))], expected=None)
    with pytest.raises(errors.VersionMismatch):
        c.append("main", gen, [Insert(2, (2,))], expected=99)
    c.close()
    c2 = mk(tmp_path)
    assert c2.last_seq("main", gen) == 1
    c2.close()


def test_torn_tail_recovers_valid_prefix(tmp_path):
    c = mk(tmp_path)
    gen, _ = fill(c)
    c.close()

    logs = sorted(p for p in os.listdir(tmp_path) if p.endswith(".clog"))
    assert logs
    path = tmp_path / logs[-1]
    data = path.read_bytes()
    path.write_bytes(data[:-3])  # tear the last record mid-payload

    c2 = mk(tmp_path)
    # Last record was the "other" delete: it is lost, everything before holds.
    assert c2.active_indexes() == {"main": gen, "other": 2}
    assert c2.last_seq("main", gen) == 4
    c2.close()


def test_torn_first_record_does_not_eat_later_appends(tmp_path):
    """A torn FIRST record makes the reopened log reuse the same filename
    (next_ordinal == file start).  The torn bytes must be truncated at
    load — otherwise acknowledged records append BEHIND them and are
    silently lost on the NEXT restart."""
    c = mk(tmp_path)
    c.create_index("main")
    c.close()

    logs = [p for p in os.listdir(tmp_path) if p.endswith(".clog")]
    assert len(logs) == 1
    path = tmp_path / logs[0]
    path.write_bytes(path.read_bytes()[:-3])  # tear the ONLY record

    c2 = mk(tmp_path)
    assert c2.active_indexes() == {}  # torn create was never acknowledged
    gen = c2.create_index("main")  # acknowledged (fsync'd) after reopen
    c2.append("main", gen, [Insert(1, (10,))], expected=0)
    c2.close()

    c3 = mk(tmp_path)  # second restart: the acknowledged records must hold
    assert c3.active_indexes() == {"main": gen}
    assert c3.last_seq("main", gen) == 1
    c3.close()


def test_failed_write_rolls_back_torn_bytes(tmp_path):
    """A write that fails mid-record (e.g. ENOSPC at flush) must roll the
    file back to its durable end: otherwise the NEXT successful,
    acknowledged append lands BEHIND the torn bytes, and replay's
    torn-tail truncation destroys it on restart."""
    c = mk(tmp_path)
    gen = c.create_index("main")
    c.append("main", gen, [Insert(1, (10,))], expected=None)

    class TornWriteFile:
        """Writes half the bytes, then fails — a partial flush."""

        def __init__(self, fh):
            self._fh = fh
            self._failed = False

        def write(self, b):
            if not self._failed:
                self._fh.write(b[: max(1, len(b) // 2)])
                self._fh.flush()
                self._failed = True
                raise OSError(28, "No space left on device")
            return self._fh.write(b)

        def __getattr__(self, name):
            return getattr(self._fh, name)

    real = c._get_file()
    c._fh = TornWriteFile(real)
    with pytest.raises(OSError):
        c.append("main", gen, [Insert(2, (20,))], expected=1)
    c._fh = real  # the proxy only exists to inject the failure

    # Acknowledged after the failure — must survive restarts.
    c.append("main", gen, [Insert(3, (30,))], expected=1)
    c.close()

    c2 = mk(tmp_path)
    entries = c2.read("main", gen, after=0, max_entries=10, deadline=past())
    assert [e.change for e in entries] == [Insert(1, (10,)), Insert(3, (30,))]
    assert c2.last_seq("main", gen) == 2
    c2.close()


def test_unrecoverable_write_fail_stops(tmp_path):
    """If the rollback truncate also fails, the coordinator must fail-stop
    (refuse further appends) rather than risk acked records behind torn
    bytes; a restart recovers via torn-tail truncation."""
    c = mk(tmp_path)
    gen = c.create_index("main")

    class BrokenFile:
        def __init__(self, fh):
            self._fh = fh

        def write(self, b):
            self._fh.write(b[: max(1, len(b) // 2)])
            self._fh.flush()
            raise OSError(28, "No space left on device")

        def truncate(self, *a):
            raise OSError(5, "Input/output error")

        def __getattr__(self, name):
            return getattr(self._fh, name)

    c._fh = BrokenFile(c._get_file())
    with pytest.raises(OSError):
        c.append("main", gen, [Insert(1, (10,))], expected=None)
    assert c._broken
    with pytest.raises(errors.CoordinatorError):
        c.append("main", gen, [Insert(2, (20,))], expected=None)
    c.close()

    c2 = mk(tmp_path)  # restart: torn tail truncated, create survived
    assert c2.active_indexes() == {"main": gen}
    assert c2.last_seq("main", gen) == 0
    gen_dir_ok = c2.append("main", gen, [Insert(5, (50,))], expected=0)
    assert gen_dir_ok == 1
    c2.close()


def test_compaction_and_reopen(tmp_path):
    c = mk(tmp_path)
    gen, gen2 = fill(c)
    c.compact()
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".clog")]
    assert (tmp_path / "snapshot.mpk").exists()
    # post-compaction appends land in fresh logs and replay on top
    c.append("main", gen, [Insert(9, (90,))], expected=4)
    c.close()

    c2 = mk(tmp_path)
    assert c2.last_seq("main", gen) == 5
    entries = c2.read("main", gen, after=0, max_entries=100, deadline=past())
    assert [e.id for e in entries] == [1, 2, 3, 4, 5]
    meta = c2.read_meta(after=0, max_ops=100, deadline=past())
    assert len(meta) == 3
    c2.close()


def test_auto_compaction_threshold(tmp_path):
    c = mk(tmp_path, compact_bytes=256)
    gen = c.create_index("main")
    for i in range(1, 40):
        c.append("main", gen, [Insert(i, (i,))], expected=None)
    assert (tmp_path / "snapshot.mpk").exists()
    c.close()
    c2 = mk(tmp_path)
    assert c2.last_seq("main", gen) == 39
    c2.close()


def test_stale_logs_deleted_after_crashy_compaction(tmp_path):
    c = mk(tmp_path)
    gen, gen2 = fill(c)
    # Simulate a crash between snapshot rename and log cleanup: snapshot
    # the state but leave the old logs on disk.
    with c._lock:
        state = c._snapshot_state()
    import msgpack

    (tmp_path / "snapshot.mpk").write_bytes(msgpack.packb(state, use_bin_type=True))
    c.close()

    c2 = mk(tmp_path)  # must not double-apply the folded records
    assert_state(c2, gen, gen2)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".clog")]
    c2.close()


def test_log_rotation(tmp_path):
    c = mk(tmp_path, max_file_size=128)
    gen = c.create_index("main")
    for i in range(1, 20):
        c.append("main", gen, [Insert(i, (i, i + 1))], expected=None)
    logs = [p for p in os.listdir(tmp_path) if p.endswith(".clog")]
    assert len(logs) > 1
    c.close()
    c2 = mk(tmp_path, max_file_size=128)
    assert c2.last_seq("main", gen) == 19
    c2.close()
