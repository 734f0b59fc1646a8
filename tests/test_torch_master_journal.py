"""Twin of ``tests/test_master_journal.py``, against the port (:mod:`dlrover_tpu_torch`).

Master crash recovery: journal crash-consistency properties
(arbitrary truncation/corruption -> prefix-consistent replay or
snapshot fallback, never an exception past recovery), replay
idempotence, exactly-once shard re-queueing, rendezvous round/KV/exit
decision restoration, the session-resync handshake, and the recovery
counter + ``master_recovered`` event on every recovery path.
"""

import json
import os
import random
import threading
import time

import pytest

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import MessageClient, MessageServer, RequestHandler
from dlrover_tpu_torch.common.constants import JobExitReason, NodeStatus
from dlrover_tpu_torch.master import journal as jmod
from dlrover_tpu_torch.master.journal import StateJournal, replay_dir
from dlrover_tpu_torch.master.master import JobMaster
from dlrover_tpu_torch.telemetry.events import EVENT_LOG_ENV, read_events
from dlrover_tpu_torch.telemetry.metrics import get_registry


def _counter_value(name: str) -> float:
    return get_registry().counter(name).value()


@pytest.fixture()
def event_log(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv(EVENT_LOG_ENV, str(path))
    return path


def _events(path, etype):
    if not os.path.exists(path):
        return []
    return [e for e in read_events(str(path)) if e.get("type") == etype]


# ---------------------------------------------------------------------------
# journal framing properties
# ---------------------------------------------------------------------------


def _write_entries(d, n=12, snapshot_at=None):
    j = StateJournal(str(d))
    for i in range(n):
        j.append("node", {"id": i, "status": "running"})
        if snapshot_at is not None and i == snapshot_at:
            j.snapshot({"upto": i})
    j.close()
    return j


def test_append_replay_roundtrip(tmp_path):
    _write_entries(tmp_path / "j", n=5)
    rep = replay_dir(str(tmp_path / "j"))
    assert not rep.truncated
    assert [d["id"] for _s, _k, d in rep.entries] == list(range(5))
    assert rep.last_seq == 5


def test_truncation_recovers_prefix_at_every_byte(tmp_path):
    """Property: truncate journal.log at EVERY byte boundary — replay
    must yield a strict prefix of the original entry list and never
    raise."""
    src = tmp_path / "src"
    _write_entries(src, n=6)
    log = (src / "journal.log").read_bytes()
    full = [d["id"] for _s, _k, d in replay_dir(str(src)).entries]
    seen_lengths = set()
    for cut in range(len(log) + 1):
        d = tmp_path / f"cut{cut}"
        os.makedirs(d)
        (d / "journal.log").write_bytes(log[:cut])
        rep = replay_dir(str(d))  # must not raise
        ids = [x["id"] for _s, _k, x in rep.entries]
        assert ids == full[: len(ids)], f"non-prefix at cut {cut}"
        seen_lengths.add(len(ids))
    # every prefix length is reachable, so nothing was silently
    # swallowed whole
    assert seen_lengths == set(range(len(full) + 1))


def test_corruption_recovers_prefix(tmp_path):
    """Property: flip one byte anywhere — replay stops at (or before)
    the corrupted record, stays prefix-consistent, never raises, and
    never resurrects anything past the corruption (a rolled-back
    decision cannot reappear)."""
    src = tmp_path / "src"
    _write_entries(src, n=8)
    log = bytearray((src / "journal.log").read_bytes())
    full = [d["id"] for _s, _k, d in replay_dir(str(src)).entries]
    rng = random.Random(7)
    for trial in range(40):
        pos = rng.randrange(len(log))
        mutated = bytearray(log)
        mutated[pos] ^= 0xFF
        d = tmp_path / f"flip{trial}"
        os.makedirs(d)
        (d / "journal.log").write_bytes(bytes(mutated))
        rep = replay_dir(str(d))  # must not raise
        ids = [x["id"] for _s, _k, x in rep.entries]
        assert ids == full[: len(ids)], (
            f"non-prefix after flipping byte {pos}"
        )


def test_torn_tail_falls_back_to_snapshot(tmp_path):
    """Corrupting the FIRST post-snapshot record leaves exactly the
    snapshot state."""
    d = tmp_path / "j"
    j = StateJournal(str(d))
    j.append("node", {"id": 0})
    j.snapshot({"upto": 0})
    j.append("node", {"id": 1})
    j.append("node", {"id": 2})
    j.close()
    log = bytearray((d / "journal.log").read_bytes())
    log[len(jmod.MAGIC) + 10] ^= 0xFF  # inside record 1's payload
    (d / "journal.log").write_bytes(bytes(log))
    rep = replay_dir(str(d))
    assert rep.truncated
    assert rep.snapshot == {"upto": 0}
    assert rep.entries == []


def test_snapshot_rotation_skips_folded_entries(tmp_path):
    d = tmp_path / "j"
    j = StateJournal(str(d))
    for i in range(4):
        j.append("node", {"id": i})
    j.snapshot({"upto": 3})
    j.append("node", {"id": 4})
    j.close()
    rep = replay_dir(str(d))
    assert rep.snapshot == {"upto": 3}
    assert [x["id"] for _s, _k, x in rep.entries] == [4]
    # a crash between snapshot rename and log rotation is simulated
    # by re-appending pre-snapshot seqs: they must be skipped
    assert rep.snapshot_seq == 4 and rep.last_seq == 5


def test_snapshot_with_earlier_seq_preserves_raced_appends(tmp_path):
    """A mutation journaled BETWEEN state capture and snapshot write
    (seq > the pre-capture seq the snapshot is stamped with) must
    survive the rotation and replay on top — raced mutations may be
    double-applied (idempotent), never lost."""
    d = tmp_path / "j"
    j = StateJournal(str(d))
    j.append("node", {"id": 0})
    seq_before_capture = j.last_seq
    # ...capture happens here; meanwhile another thread appends:
    j.append("node", {"id": 1})
    j.snapshot({"upto": 0}, seq=seq_before_capture)
    j.close()
    rep = replay_dir(str(d))
    assert rep.snapshot == {"upto": 0}
    assert [x["id"] for _s, _k, x in rep.entries] == [1]


def test_reopen_truncates_torn_tail_and_appends_cleanly(tmp_path):
    d = tmp_path / "j"
    _write_entries(d, n=3)
    with open(d / "journal.log", "ab") as f:
        f.write(b"\x00\x01garbage-torn-tail")
    j = StateJournal(str(d))  # reopen: discards the torn tail
    assert j.recovered.truncated
    assert len(j.recovered.entries) == 3
    j.append("node", {"id": 99})
    j.close()
    rep = replay_dir(str(d))
    assert [x["id"] for _s, _k, x in rep.entries][-1] == 99
    assert not rep.truncated


def test_torn_header_reopen_starts_clean_log(tmp_path):
    """A crash mid-header-write leaves a partial MAGIC; reopening
    must rewrite a clean header so subsequent appends are visible to
    replay (truncating to garbage would silently brick the journal)."""
    d = tmp_path / "j"
    os.makedirs(d)
    (d / "journal.log").write_bytes(jmod.MAGIC[:3])
    j = StateJournal(str(d))
    j.append("node", {"id": 7})
    j.close()
    rep = replay_dir(str(d))
    assert [x["id"] for _s, _k, x in rep.entries] == [7]


def test_concurrent_appends_stay_crc_clean(tmp_path):
    """The journal is fed from many threads (RPC handlers, monitors,
    the run loop): concurrent appends must serialize — every record
    survives replay with a unique seq and no CRC truncation."""
    d = tmp_path / "j"
    j = StateJournal(str(d))
    per_thread = 40

    def worker(tid):
        for i in range(per_thread):
            j.append("node", {"id": tid * 1000 + i})

    threads = [
        threading.Thread(target=worker, args=(t,)) for t in range(6)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    j.close()
    rep = replay_dir(str(d))
    assert not rep.truncated
    assert len(rep.entries) == 6 * per_thread
    seqs = [s for s, _k, _d in rep.entries]
    assert len(set(seqs)) == len(seqs)
    ids = {x["id"] for _s, _k, x in rep.entries}
    assert len(ids) == 6 * per_thread


def test_rotation_crash_leaves_replayable_log(tmp_path):
    """Rotation is tmp+rename: at any moment journal.log on disk is
    either the full old log or the complete rotated one — simulate
    the 'crash before rename' state and replay both sides."""
    d = tmp_path / "j"
    j = StateJournal(str(d))
    for i in range(3):
        j.append("node", {"id": i})
    seq = j.last_seq
    j.append("node", {"id": 99})  # races the capture
    j.snapshot({"upto": 2}, seq=seq)
    j.close()
    # post-rotation: snapshot + the raced record
    rep = replay_dir(str(d))
    assert rep.snapshot == {"upto": 2}
    assert [x["id"] for _s, _k, x in rep.entries] == [99]
    # no stray tmp file left behind
    assert not os.path.exists(str(d / "journal.log.tmp"))


def test_replay_idempotent(tmp_path):
    d = tmp_path / "j"
    _write_entries(d, n=6, snapshot_at=2)
    once = replay_dir(str(d))
    twice = replay_dir(str(d))
    assert once.snapshot == twice.snapshot
    assert once.entries == twice.entries
    assert once.last_seq == twice.last_seq


# ---------------------------------------------------------------------------
# master-level recovery
# ---------------------------------------------------------------------------


def _dataset_params(size=6, name="ds"):
    return msg.DatasetShardParams(
        batch_size=1, num_epochs=1, dataset_size=size, shuffle=False,
        num_minibatches_per_shard=1, dataset_name=name,
        task_type="training", storage_type="table",
    )


def _crashed_master(journal_dir):
    """Build a master, drive some state, 'crash' it (no stop/snapshot:
    the journal tail is all a successor gets)."""
    m = JobMaster(port=0, node_num=1, job_name="jr",
                  journal_dir=journal_dir)
    m.task_manager.new_dataset(_dataset_params())
    t1 = m.task_manager.get_dataset_task(0, "ds")
    t2 = m.task_manager.get_dataset_task(0, "ds")
    assert m.task_manager.report_dataset_task("ds", t1.task_id, True)
    m.elastic_rdzv.join_rendezvous(0, 0, 1, "127.0.0.1")
    rnd, _g, world, _c = m.elastic_rdzv.get_comm_world(0)
    assert rnd == 1 and world == {0: 1}
    m.servicer.report(
        0, "worker", msg.KeyValuePair(key="coord", value=b"addr")
    )
    m._server.stop()
    return m, t1, t2


def test_recovery_requeues_only_unacked_shards(tmp_path, event_log):
    before = _counter_value("dlrover_master_recoveries_total")
    m1, t1, t2 = _crashed_master(str(tmp_path / "j"))
    m2 = JobMaster(port=0, node_num=1, job_name="jr",
                   journal_dir=str(tmp_path / "j"))
    try:
        assert m2.recoveries == 1
        assert (
            _counter_value("dlrover_master_recoveries_total")
            == before + 1
        )
        recovered = _events(event_log, "master_recovered")
        assert recovered and recovered[-1]["requeued"] == 1
        ds = m2.task_manager._datasets["ds"]
        # the acked shard is done; the unacked lease is back at the
        # head of the queue
        assert ds.completed_count == 1 and not ds.doing
        assert (ds.todo[0].start, ds.todo[0].end) == (t2.start, t2.end)
        # re-dispatching the rest completes without ever re-issuing
        # the acked range: exactly-once completion across the crash
        seen = []
        while True:
            t = m2.task_manager.get_dataset_task(1, "ds")
            if t.task_id < 0:
                break
            seen.append((t.start, t.end))
            m2.task_manager.report_dataset_task("ds", t.task_id, True)
        assert (t1.start, t1.end) not in seen
        assert ds.completed()
    finally:
        m2._server.stop()


def test_recovery_restores_rdzv_round_world_and_kv(tmp_path):
    m1, _t1, _t2 = _crashed_master(str(tmp_path / "j"))
    m2 = JobMaster(port=0, node_num=1, job_name="jr",
                   journal_dir=str(tmp_path / "j"))
    try:
        # the respawned master re-enters round 1 with the completed
        # world: a healthy agent polling get_comm_world sees the SAME
        # answer and is not restarted
        rnd, _g, world, _c = m2.elastic_rdzv.get_comm_world(0)
        assert rnd == 1 and world == {0: 1}
        assert m2.elastic_rdzv.num_nodes_waiting() == 0
        assert m2.kv_store.get("coord") == b"addr"
    finally:
        m2._server.stop()


def test_recovery_is_idempotent_across_restarts(tmp_path):
    """Crash -> recover -> crash again (no new mutations) -> recover:
    identical state (replay twice == replay once)."""
    _crashed_master(str(tmp_path / "j"))
    m2 = JobMaster(port=0, node_num=1, job_name="jr",
                   journal_dir=str(tmp_path / "j"))
    state2 = (
        m2.task_manager._datasets["ds"].full_state(),
        m2.elastic_rdzv.journal_state(),
    )
    m2._server.stop()
    m3 = JobMaster(port=0, node_num=1, job_name="jr",
                   journal_dir=str(tmp_path / "j"))
    state3 = (
        m3.task_manager._datasets["ds"].full_state(),
        m3.elastic_rdzv.journal_state(),
    )
    m3._server.stop()
    assert state2 == state3
    assert m3.recoveries == 2


def test_recovery_restores_network_check_results(tmp_path):
    """The network-check rendezvous
    RESULTS survive a mid-check master crash — previously only round
    membership replayed, so a respawned master forgot every status/
    elapsed report that had already arrived and fault confirmation
    ("abnormal in two consecutive rounds") restarted from scratch."""
    m1 = JobMaster(port=0, node_num=2, job_name="nc",
                   journal_dir=str(tmp_path / "j"))
    nc = m1.network_rdzv
    for rank in (0, 1):
        nc.join_rendezvous(rank, rank, 1, "127.0.0.1")
    rnd, group, world, _c = nc.get_comm_world(0)
    assert rnd == 1 and world  # round complete, groups built
    # reports flow through the servicer so the journal hook fires
    m1.servicer.report(0, "worker", msg.NetworkStatusRequest(
        node_id=0, normal=True, elapsed_time=1.0))
    m1.servicer.report(1, "worker", msg.NetworkStatusRequest(
        node_id=1, normal=False, elapsed_time=9.0))
    fault_before = nc.check_fault_node()
    stragglers_before = nc.detect_stragglers()
    assert fault_before == ([1], "need-second-round")
    assert stragglers_before[0] == [1]
    m1._server.stop()  # crash: no graceful snapshot

    m2 = JobMaster(port=0, node_num=2, job_name="nc",
                   journal_dir=str(tmp_path / "j"))
    try:
        nc2 = m2.network_rdzv
        # the check verdicts are identical across the crash
        assert nc2.check_fault_node() == fault_before
        assert nc2.detect_stragglers() == stragglers_before
        # the pairwise grouping survives: a re-joining agent polling
        # get_comm_world sees its group again
        rnd2, _g2, world2, _c2 = nc2.get_comm_world(0)
        assert rnd2 == 1 and world2 == {0: 1, 1: 1}
        # and the snapshot path carries the same state (graceful
        # stop folds it in; a 3rd incarnation replays snapshot-only)
        m2.stop()
        m3 = JobMaster(port=0, node_num=2, job_name="nc",
                       journal_dir=str(tmp_path / "j"))
        assert m3.network_rdzv.check_fault_node() == fault_before
        assert m3.network_rdzv.detect_stragglers() == (
            stragglers_before
        )
        m3._server.stop()
    finally:
        m2._server.stop()


def test_netcheck_round2_grouping_identical_across_crash(tmp_path):
    """Review regression: round ≥ 2 groups fastest-with-slowest by
    the PREVIOUS round's elapsed times.  Replay must rebuild groups
    with the same ordering the live path used (times read BEFORE the
    check-round counter advances) — with 4 nodes whose times force a
    non-neighbour pairing, a divergent rebuild would pair different
    members than the pre-crash agents were already given."""
    m1 = JobMaster(port=0, node_num=4, job_name="nc2",
                   journal_dir=str(tmp_path / "j"))
    nc = m1.network_rdzv
    for rank in range(4):
        nc.join_rendezvous(rank, rank, 1, "127.0.0.1")
    rnd, _g, world, _c = nc.get_comm_world(0)
    assert rnd == 1 and world
    # neighbour-pair times that sort into a DIFFERENT round-2 pairing
    for node, elapsed in ((0, 1.0), (1, 2.0), (2, 8.0), (3, 9.0)):
        m1.servicer.report(node, "worker", msg.NetworkStatusRequest(
            node_id=node, normal=True, elapsed_time=elapsed))
    for rank in range(4):
        nc.join_rendezvous(rank, rank, 1, "127.0.0.1")
    rnd, _g, _w, _c = nc.get_comm_world(0)
    assert rnd == 2
    groups_before = nc.journal_state()["check"]["groups"]
    # fastest-with-slowest: {0,3} and {1,2}, not neighbours
    assert sorted(sorted(g) for g in groups_before) == [[0, 3], [1, 2]]
    m1._server.stop()  # crash: entry replay only, no snapshot

    m2 = JobMaster(port=0, node_num=4, job_name="nc2",
                   journal_dir=str(tmp_path / "j"))
    try:
        check = m2.network_rdzv.journal_state()["check"]
        assert check["groups"] == groups_before
        assert check["check_round"] == 2
        # every rank polling the recovered master sees its pre-crash
        # group world
        for rank, peers in ((0, {0: 1, 3: 1}), (1, {1: 1, 2: 1})):
            _r, _g, world, _c = m2.network_rdzv.get_comm_world(rank)
            assert world == peers
    finally:
        m2._server.stop()


def test_journaled_job_exit_decision_honored(tmp_path):
    m1 = JobMaster(port=0, node_num=1, job_name="jx",
                   journal_dir=str(tmp_path / "j"))
    m1.job_manager.update_node_status(0, "worker", NodeStatus.RUNNING)
    m1.job_manager.job_exit_reason = JobExitReason.CODE_ERROR
    m1._server.stop()
    m2 = JobMaster(port=0, node_num=1, job_name="jx",
                   journal_dir=str(tmp_path / "j"))
    try:
        assert m2.job_manager.job_exit_reason == JobExitReason.CODE_ERROR
        # the respawned master refuses to resurrect the aborted job
        assert m2.run() == 1
    finally:
        m2._server.stop()


def test_session_resync_rebuilds_liveness(tmp_path):
    m = JobMaster(port=0, node_num=1, job_name="rs")
    try:
        resp = m.servicer.get(
            0, "worker",
            msg.SessionResyncRequest(
                node_id=0, node_rank=0, local_world_size=1,
                restart_count=0, last_step=7,
            ),
        )
        assert isinstance(resp, msg.SessionResyncResponse)
        assert resp.incarnation == m.incarnation
        assert 0 in m.elastic_rdzv._alive_nodes
        assert m.speed_monitor.completed_global_step == 7
        node = m.job_manager.get_node(0)
        assert node is not None and node.heartbeat_time > 0
    finally:
        m._server.stop()


class _Echo(RequestHandler):
    def get(self, node_id, node_type, message):
        return message

    def report(self, node_id, node_type, message):
        return True


def test_client_parks_and_resyncs_across_server_restart():
    """Kill the server mid-session, bring a new one up on the SAME
    port: a client whose retry envelope is too short must park in the
    re-resolve loop, reconnect, and fire the session-resync handshake
    exactly once."""
    s1 = MessageServer(0, _Echo())
    s1.start()
    port = s1.port
    resyncs = []
    client = MessageClient(
        f"127.0.0.1:{port}", retries=2, backoff_base=0.05,
        backoff_max=0.1, resync_timeout=15.0,
    )
    client.set_session_resync(lambda: resyncs.append(time.time()))
    assert client.get(msg.BaseRequest(node_id=1)).node_id == 1
    s1.stop()
    # stop() closes the LISTENER; the established per-connection
    # thread lingers in-process — drop the client's socket so the
    # next request sees what a dead master process looks like
    # (connection refused on reconnect)
    client.close()

    s2_holder = {}

    def _respawn():
        time.sleep(1.0)
        s2 = MessageServer(port, _Echo())
        s2.start()
        s2_holder["s"] = s2

    t = threading.Thread(target=_respawn, daemon=True)
    t.start()
    try:
        # retries exhaust while the port is dead -> park -> respawned
        # server answers -> handshake replayed, request completes
        assert client.get(msg.BaseRequest(node_id=2)).node_id == 2
        assert len(resyncs) == 1
    finally:
        t.join()
        client.close()
        s2_holder["s"].stop()


# -- journal mirror: host-portable control plane ------------------------


def test_mirror_matches_local_after_flush(tmp_path):
    """Appends + a snapshot rotation group-commit to the mirror; a
    graceful close drains the queue, after which replaying the mirror
    yields exactly the local journal's state."""
    local, mirror = str(tmp_path / "local"), str(tmp_path / "mirror")
    j = StateJournal(local, mirror_dir=mirror, mirror_interval_s=0.02)
    for i in range(30):
        j.append("k", {"i": i})
    j.snapshot({"base": True}, seq=20)
    for i in range(30, 34):
        j.append("k", {"i": i})
    j.close()
    a, b = replay_dir(local), replay_dir(mirror)
    assert a.snapshot == b.snapshot
    assert a.snapshot_seq == b.snapshot_seq == 20
    assert a.entries == b.entries
    assert a.last_seq == b.last_seq == 34


def test_mirror_lag_bounded_by_group_commit_window(tmp_path):
    """The journal_mirror_flush events stamp how old the oldest
    un-flushed record was at each group commit — bounded by the
    configured window plus scheduling jitter, never unbounded."""
    os.environ[EVENT_LOG_ENV] = str(tmp_path / "events.jsonl")
    try:
        local = str(tmp_path / "local")
        mirror = str(tmp_path / "mirror")
        interval = 0.05
        j = StateJournal(
            local, mirror_dir=mirror, mirror_interval_s=interval
        )
        for i in range(50):
            j.append("k", {"i": i})
            time.sleep(0.005)
        j.close()
        flushes = [
            e for e in read_events(str(tmp_path / "events.jsonl"))
            if e.get("type") == "journal_mirror_flush"
        ]
        assert flushes, "no group commits recorded"
        assert sum(e["records"] for e in flushes) == 50
        # lag ≤ window + generous scheduling slack (CI boxes stall)
        assert max(e["lag_s"] for e in flushes) < interval + 2.0
        # group commit actually batched: fewer flushes than appends
        assert len(flushes) < 50
    finally:
        os.environ.pop(EVENT_LOG_ENV, None)


def test_restore_from_mirror_equals_restore_from_local(tmp_path):
    """A FRESH journal dir pointed at the mirror seeds itself and
    replays the same state the dead master's local dir would have —
    the different-host respawn path."""
    local, mirror = str(tmp_path / "local"), str(tmp_path / "mirror")
    j = StateJournal(local, mirror_dir=mirror, mirror_interval_s=0.02)
    for i in range(12):
        j.append("dispatch", {"task_id": i})
    j.snapshot({"tasks": 12}, seq=6)
    j.append("ack", {"task_id": 0})
    j.close()
    fresh = str(tmp_path / "fresh")
    j2 = StateJournal(fresh, mirror_dir=mirror)
    assert j2.seeded_from_mirror
    local_replay = replay_dir(local)
    assert j2.recovered.snapshot == local_replay.snapshot
    assert j2.recovered.entries == local_replay.entries
    assert j2.recovered.last_seq == local_replay.last_seq == 13
    # the seeded journal keeps appending into BOTH logs
    j2.append("ack", {"task_id": 1})
    j2.close()
    assert replay_dir(mirror).last_seq == 14
    # a local dir WITH state wins over the mirror (same-host respawn:
    # the local log is fresher than the lagging mirror)
    j3 = StateJournal(local, mirror_dir=mirror)
    assert not j3.seeded_from_mirror
    j3.close()


def test_torn_mirror_tail_replays_prefix_consistent(tmp_path):
    """A mirror whose last group commit was torn mid-frame (the
    master died mid-write) seeds a fresh dir with the valid prefix —
    and the next incarnation's appends extend a CLEAN mirror log
    instead of burying records after garbage."""
    local, mirror = str(tmp_path / "local"), str(tmp_path / "mirror")
    j = StateJournal(local, mirror_dir=mirror, mirror_interval_s=0.02)
    for i in range(10):
        j.append("k", {"i": i})
    j.close()
    log = os.path.join(mirror, "journal.log")
    size = os.path.getsize(log)
    with open(log, "r+b") as f:
        f.truncate(size - 5)  # tear the final frame
    fresh = str(tmp_path / "fresh")
    j2 = StateJournal(fresh, mirror_dir=mirror)
    assert j2.seeded_from_mirror
    assert j2.recovered.last_seq == 9  # record 10 torn away
    assert j2.recovered.truncated
    j2.append("k", {"i": "post-tear"})
    j2.close()
    m = replay_dir(mirror)
    assert not m.truncated  # the torn tail was cut before appending
    assert m.last_seq == 10
    assert m.entries[-1][2] == {"i": "post-tear"}


def test_arming_mirror_over_existing_journal_resyncs(tmp_path):
    """Pointing a mirror at a journal dir that ALREADY has history
    must replicate that history, not just new appends — otherwise the
    mirror looks seed-eligible (has_state) while missing the records
    every later entry depends on."""
    local, mirror = str(tmp_path / "local"), str(tmp_path / "mirror")
    j = StateJournal(local)  # no mirror yet
    for i in range(8):
        j.append("k", {"i": i})
    j.close()
    j2 = StateJournal(local, mirror_dir=mirror, mirror_interval_s=0.02)
    j2.append("k", {"i": "after-arming"})
    j2.close()
    a, b = replay_dir(local), replay_dir(mirror)
    assert b.last_seq == a.last_seq == 9
    assert b.entries == a.entries  # pre-arming history included


def test_failed_mirror_flush_resyncs_without_seq_gap(tmp_path):
    """A flush that dies mid-write (broken handle / browned-out tier)
    must not leave a sequence HOLE in the mirror: the mirror resyncs
    from the local journal and stays a consistent prefix."""
    local, mirror = str(tmp_path / "local"), str(tmp_path / "mirror")
    j = StateJournal(local, mirror_dir=mirror, mirror_interval_s=0.02)
    for i in range(5):
        j.append("k", {"i": i})
    j.mirror.flush()
    # sabotage the mirror's handle: the next group commit raises
    # ValueError (closed file), which must schedule a resync — not
    # kill the thread, not skip the batch
    j.mirror._fh.close()
    for i in range(5, 12):
        j.append("k", {"i": i})
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if replay_dir(mirror).last_seq >= 12:
            break
        time.sleep(0.05)
    j.close()
    a, b = replay_dir(local), replay_dir(mirror)
    assert b.last_seq == a.last_seq == 12
    # no gap: every seq present exactly once, in order
    assert [s for s, _k, _d in b.entries] == list(range(1, 13))


def test_mirror_env_defaults(tmp_path, monkeypatch):
    """DLROVER_MASTER_JOURNAL_MIRROR_DIR arms the mirror without any
    constructor plumbing (the JobMaster path)."""
    mirror = str(tmp_path / "mirror")
    monkeypatch.setenv(jmod.JOURNAL_MIRROR_DIR_ENV, mirror)
    j = StateJournal(str(tmp_path / "local"))
    assert j.mirror is not None and j.mirror.dir == mirror
    j.append("k", {"x": 1})
    j.close()
    assert replay_dir(mirror).last_seq == 1


def test_resync_reconciles_mirror_lagged_ack(tmp_path):
    """Exactly-once under mirror lag: a worker's session resync
    reporting an ack the recovered master never saw closes the lease
    (doing OR already-requeued todo) instead of re-dispatching it."""
    from dlrover_tpu_torch.common.messages import DatasetShardParams
    from dlrover_tpu_torch.master.task_manager import TaskManager

    tm = TaskManager()
    tm.new_dataset(DatasetShardParams(
        dataset_name="ds", batch_size=1, dataset_size=4,
        num_minibatches_per_shard=1, storage_type="table",
    ))
    t0 = tm.get_dataset_task(0, "ds")
    assert t0.task_id >= 0
    # lease open (mirror lost the ack): resync closes it
    assert tm.reconcile_acked_task("ds", t0.task_id)
    ds = tm._datasets["ds"]
    assert t0.task_id not in ds.doing
    assert ds.completed_count == 1
    # requeued variant: dispatch, requeue (recovery epilogue ran
    # before the resync arrived), then the late resync still lands
    t1 = tm.get_dataset_task(0, "ds")
    assert tm.requeue_unacked() == 1
    assert tm.reconcile_acked_task("ds", t1.task_id)
    assert ds.completed_count == 2
    assert all(t.task_id != t1.task_id for t in ds.todo)
    # unknown/negative ids are ignored
    assert not tm.reconcile_acked_task("ds", 999)
    assert not tm.reconcile_acked_task("", 1)


def test_resync_reconciles_multiple_acks_in_one_window(tmp_path):
    """Several acks can complete inside ONE mirror group-commit
    window; the resync handshake ships the whole recent-ack history
    and the servicer closes EVERY lease, not just the most recent —
    otherwise the earlier shards re-dispatch and train twice."""
    from dlrover_tpu_torch.common.constants import NodeType
    from dlrover_tpu_torch.common.messages import DatasetShardParams
    from dlrover_tpu_torch.master.job_manager import JobManager
    from dlrover_tpu_torch.master.kv_store import KVStoreService
    from dlrover_tpu_torch.master.rdzv_manager import (
        ElasticTrainingRendezvousManager,
        NetworkCheckRendezvousManager,
    )
    from dlrover_tpu_torch.master.servicer import MasterServicer
    from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
    from dlrover_tpu_torch.master.task_manager import TaskManager

    tm = TaskManager()
    tm.new_dataset(DatasetShardParams(
        dataset_name="ds", batch_size=1, dataset_size=4,
        num_minibatches_per_shard=1, storage_type="table",
    ))
    t0 = tm.get_dataset_task(0, "ds")
    t1 = tm.get_dataset_task(0, "ds")
    jm = JobManager()
    jm.add_node(NodeType.WORKER, 0)
    servicer = MasterServicer(
        task_manager=tm,
        job_manager=jm,
        rdzv_managers={
            "elastic-training": ElasticTrainingRendezvousManager(),
            "network-check": NetworkCheckRendezvousManager(),
        },
        kv_store=KVStoreService(),
        speed_monitor=SpeedMonitor(),
    )
    resp = servicer.get(0, "worker", msg.SessionResyncRequest(
        node_id=0,
        last_acked_dataset="ds",
        last_acked_task=t1.task_id,
        recent_acked_tasks=[("ds", t0.task_id), ("ds", t1.task_id)],
    ))
    assert resp.success
    ds = tm._datasets["ds"]
    assert t0.task_id not in ds.doing and t1.task_id not in ds.doing
    assert ds.completed_count == 2


def test_append_many_one_lock_one_fsync_replay_equal(
    tmp_path, monkeypatch,
):
    """The multi-record append: a 64-record
    batch claims the io lock once and fsyncs ONCE — the per-record
    flavour paid 64 — while replay sees exactly the same contiguous,
    CRC-clean record stream a sequential append loop would have
    produced."""
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(
        jmod.os, "fsync",
        lambda fd: (calls.append(fd), real_fsync(fd))[1],
    )
    j = StateJournal(str(tmp_path / "batch"))
    base = len(calls)
    records = [("ack_reconciled", {"dataset": "ds", "task_id": i})
               for i in range(64)]
    seqs = j.append_many(records)
    assert len(calls) == base + 1  # one fsync for the whole batch
    assert seqs == list(range(seqs[0], seqs[0] + 64))
    assert j.append_many([]) == []  # no-op, no io
    j.close()

    # the sequential twin replays identically (minus seq offsets)
    j2 = StateJournal(str(tmp_path / "seq"))
    for kind, data in records:
        j2.append(kind, data)
    j2.close()
    r1 = jmod.replay_dir(str(tmp_path / "batch"))
    r2 = jmod.replay_dir(str(tmp_path / "seq"))
    assert [(k, d) for _s, k, d in r1.entries] == [
        (k, d) for _s, k, d in r2.entries
    ]
    assert r1.last_seq == r2.last_seq


def test_append_many_respects_window_and_durable_kinds(
    tmp_path, monkeypatch,
):
    """Under a group-commit window a routine batch rides the flusher
    (zero inline fsyncs); a batch containing a DURABLE kind fsyncs
    inline — same contract as single appends."""
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(
        jmod.os, "fsync",
        lambda fd: (calls.append(fd), real_fsync(fd))[1],
    )
    j = StateJournal(str(tmp_path), fsync_window_s=30.0)
    base = len(calls)
    j.append_many([("node", {"i": i}) for i in range(10)])
    assert len(calls) == base  # batched into the window
    assert j._fsync_pending
    j.append_many([
        ("node", {"i": 99}), ("decision", {"kind": "no_relaunch"}),
    ])
    assert len(calls) == base + 1  # durable kind drains the batch
    assert not j._fsync_pending
    j.close()


def test_batched_reconcile_journals_in_one_claim(
    tmp_path, monkeypatch,
):
    """TaskManager.reconcile_acked_tasks closes every lease of the
    resync history with ONE journal batch (one fsync), and the
    journaled records replay to the same sharding state as the
    per-ack flavour."""
    from dlrover_tpu_torch.common.messages import DatasetShardParams
    from dlrover_tpu_torch.master.task_manager import TaskManager

    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(
        jmod.os, "fsync",
        lambda fd: (calls.append(fd), real_fsync(fd))[1],
    )
    tm = TaskManager()
    tm.journal = StateJournal(str(tmp_path))
    tm.new_dataset(DatasetShardParams(
        dataset_name="ds", batch_size=1, dataset_size=16,
        num_minibatches_per_shard=1, storage_type="table",
    ))
    leases = [tm.get_dataset_task(0, "ds") for _ in range(16)]
    base = len(calls)
    pairs = [("ds", t.task_id) for t in leases]
    # garbage entries are ignored without burning the batch
    pairs += [("", 1), ("ds", -1), ("nope", 2), ("ds", 999)]
    assert tm.reconcile_acked_tasks(pairs) == 16
    assert len(calls) == base + 1  # one fsync for 16 reconciles
    ds = tm._datasets["ds"]
    assert ds.completed_count == 16 and not ds.doing
    # an empty / all-garbage batch journals nothing
    assert tm.reconcile_acked_tasks([("ds", 999)]) == 0
    assert len(calls) == base + 1
    tm.journal.close()
    replay = jmod.replay_dir(str(tmp_path))
    recon = [e for e in replay.entries if e[1] == "ack_reconciled"]
    assert len(recon) == 16
    # replay onto a fresh manager reproduces the closed leases
    tm2 = TaskManager()
    tm2.restore_state({})
    for _seq, kind, data in replay.entries:
        tm2.apply_journal_entry(kind, data)
    ds2 = tm2._datasets["ds"]
    assert ds2.completed_count == 16 and not ds2.doing


# -- local append group-commit (fsync window) -------------------------------


def test_fsync_window_batches_local_appends(tmp_path, monkeypatch):
    """With DLROVER_JOURNAL_FSYNC_WINDOW_S armed, routine appends
    flush to the page cache and skip the per-append fsync; the
    records are still fully replayable (a process crash loses
    nothing — only a host power cut can eat the open window)."""
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(
        jmod.os, "fsync",
        lambda fd: (calls.append(fd), real_fsync(fd))[1],
    )
    j = StateJournal(str(tmp_path), fsync_window_s=30.0)
    base = len(calls)
    for i in range(40):
        j.append("node", {"i": i})
    assert len(calls) == base  # zero fsyncs for 40 batched appends
    j.close()  # graceful stop drains the batch durably
    assert len(calls) > base
    r = replay_dir(str(tmp_path))
    assert [d["i"] for _s, k, d in r.entries if k == "node"] == list(
        range(40)
    )


def test_fsync_window_terminal_kinds_stay_durable(
    tmp_path, monkeypatch
):
    """Terminal decisions (job_exit / decision / resize) keep the
    per-append fsync even under a window: an acted-on decision must
    never be resurrectable-by-omission after a power cut."""
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(
        jmod.os, "fsync",
        lambda fd: (calls.append(fd), real_fsync(fd))[1],
    )
    j = StateJournal(str(tmp_path), fsync_window_s=30.0)
    j.append("node", {"i": 0})
    base = len(calls)
    j.append("job_exit", {"reason": "finished"})
    assert len(calls) == base + 1  # the terminal kind fsynced inline
    j.append("resize", {"target": 2})
    assert len(calls) == base + 2
    j.close()


def test_fsync_window_flusher_commits_within_window(tmp_path):
    """The background flusher fsyncs the open batch about once per
    window without any further appends."""
    j = StateJournal(str(tmp_path), fsync_window_s=0.1)
    for i in range(5):
        j.append("node", {"i": i})
    assert j._fsync_pending
    deadline = time.time() + 5.0
    while time.time() < deadline and j._fsync_pending:
        time.sleep(0.02)
    assert not j._fsync_pending
    j.close()


def test_fsync_window_default_preserves_per_append_durability(
    tmp_path, monkeypatch
):
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(
        jmod.os, "fsync",
        lambda fd: (calls.append(fd), real_fsync(fd))[1],
    )
    monkeypatch.delenv("DLROVER_JOURNAL_FSYNC_WINDOW_S", raising=False)
    j = StateJournal(str(tmp_path))
    base = len(calls)
    for i in range(5):
        j.append("node", {"i": i})
    assert len(calls) == base + 5  # one fsync per append, as before
    j.close()


def test_fsync_window_env_arms_batching(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_JOURNAL_FSYNC_WINDOW_S", "15")
    j = StateJournal(str(tmp_path))
    assert j._fsync_window_s == 15.0
    j.append("node", {"i": 1})
    assert j._fsync_pending
    j.close()


def test_fsync_window_snapshot_rotation_clears_batch(tmp_path):
    """A snapshot rotation rewrites+fsyncs the surviving log, so the
    open batch is durable afterwards and replay sees everything."""
    j = StateJournal(str(tmp_path), fsync_window_s=30.0)
    for i in range(10):
        j.append("node", {"i": i})
    assert j._fsync_pending
    j.snapshot({"state": "s"})
    assert not j._fsync_pending
    j.append("node", {"i": 10})
    j.close()
    r = replay_dir(str(tmp_path))
    assert r.snapshot == {"state": "s"}
    assert [d["i"] for _s, k, d in r.entries] == [10]
