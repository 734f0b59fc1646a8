"""Master-side rendezvous managers.

Copy of ``dlrover_tpu/master/rdzv_manager.py`` (the port imports
nothing of the JAX package).

Role of ``dlrover/python/master/elastic_training/rdzv_manager.py``:

- :class:`ElasticTrainingRendezvousManager` collects joining agents
  into a waiting pool and completes a round when every alive node has
  joined, or when ``min_nodes`` joined and the waiting timeout lapsed;
  the accepted count is rounded down to a multiple of ``node_unit``
  (reference ``join_rendezvous:198``, ``_check_rdzv_completed:129``).
  The completed world is ``{node_rank: local_world_size}`` plus the
  ``torch.distributed`` rendezvous address (``host:port`` of the
  lowest-rank node, where rank 0's TCP store listens: the workers'
  ``init_process_group(init_method="tcp://" + coordinator)``).  The
  reference hands out the same ``host:port`` as the ``jax.distributed``
  coordinator.
- :class:`NetworkCheckRendezvousManager` drives the two-round pairwise
  diagnosis (reference ``NetworkCheckRendezvousManager:349``): round 0
  pairs neighbours ``(i, i+1)``; round 1 re-pairs nodes sorted by
  elapsed time (fastest with slowest) so a faulty node lands in a group
  with a known-good partner and can be isolated.  Stragglers are nodes
  whose check elapsed exceeds ``straggler_factor ×`` median
  (reference ``_detect_stragglers:550``).
"""

import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch.common.constants import (
    NetworkCheckConstant,
    RendezvousConstant,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import tracing as trace
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

_REG = get_registry()
_JOIN_TOTAL = _REG.counter(
    "dlrover_rdzv_join_total", "Rendezvous join requests by manager"
)
_ROUND_SECONDS = _REG.histogram(
    "dlrover_rdzv_round_seconds",
    "Wall time from first join to round completion",
)
_ROUND_GAUGE = _REG.gauge(
    "dlrover_rdzv_round", "Latest completed rendezvous round"
)
_NODES_GAUGE = _REG.gauge(
    "dlrover_rdzv_nodes", "Nodes accepted into the latest round"
)


@dataclass
class NodeMeta:
    node_id: int = 0
    node_rank: int = 0
    local_world_size: int = 1
    node_ip: str = ""
    join_time: float = field(default_factory=time.time)


@dataclass
class RendezvousParameters:
    min_nodes: int = 1
    max_nodes: int = 1
    waiting_timeout: float = RendezvousConstant.WAITING_TIMEOUT
    node_unit: int = 1


class RendezvousManager:
    """Shared mechanics of both rendezvous flavours."""

    def __init__(self, name: str = ""):
        from dlrover_tpu_torch.master.net_topology import DpTopologySorter

        self._name = name
        self._lock = threading.Lock()
        self._params = RendezvousParameters()
        self._alive_nodes: Set[int] = set()
        self._waiting_nodes: Dict[int, NodeMeta] = {}  # by node_rank
        self._rdzv_nodes: Dict[int, NodeMeta] = {}
        self._latest_rdzv_nodes: List[int] = []
        self._rdzv_round = 0
        self._start_waiting_time = 0.0
        self._coordinator_port = 0
        self._topology_sorter = DpTopologySorter()
        # master crash recovery: called (under the lock) with the
        # completed round + participants so the state journal can
        # record it; a respawned master restores via restore_round()
        self.on_round_complete = None

    def set_topology_querier(self, querier):
        """Plug a fabric-coordinate source; the completed world is
        ordered by it so rank-adjacent nodes share a slice (reference:
        topology-sorted rendezvous, net_topology.py:62)."""
        from dlrover_tpu_torch.master.net_topology import DpTopologySorter

        with self._lock:
            self._topology_sorter = DpTopologySorter(querier=querier)
            if self._rdzv_nodes:
                self._rank_order = self._topology_sorter.sort(
                    self._rdzv_nodes
                )

    # -- configuration ----------------------------------------------------

    def update_rdzv_params(
        self,
        min_nodes: int,
        max_nodes: int,
        waiting_timeout: float = RendezvousConstant.WAITING_TIMEOUT,
        node_unit: int = 1,
    ):
        with self._lock:
            self._params = RendezvousParameters(
                min_nodes, max_nodes, waiting_timeout, max(1, node_unit)
            )

    def set_coordinator_port(self, port: int):
        self._coordinator_port = port

    # -- node liveness (driven by the job manager) -------------------------

    def add_alive_node(self, node_id: int):
        with self._lock:
            self._alive_nodes.add(node_id)

    def remove_alive_node(self, node_id: int):
        with self._lock:
            self._alive_nodes.discard(node_id)
            stale = [
                rank
                for rank, meta in self._waiting_nodes.items()
                if meta.node_id == node_id
            ]
            for rank in stale:
                del self._waiting_nodes[rank]

    # -- join / completion -------------------------------------------------

    def join_rendezvous(
        self,
        node_id: int,
        node_rank: int,
        local_world_size: int,
        node_ip: str = "",
    ) -> int:
        # the span's parent is the agent-side ``rdzv.join`` span whose
        # context rode the RPC frame (comm.py attach_context)
        with trace.span(
            "rdzv.join", rdzv=self._name, node_rank=node_rank
        ):
            _JOIN_TOTAL.inc(rdzv=self._name)
            with self._lock:
                meta = NodeMeta(
                    node_id=node_id,
                    node_rank=node_rank,
                    local_world_size=local_world_size,
                    node_ip=node_ip,
                )
                if self._is_inplace_rejoin(node_rank, node_id):
                    # culprit-only restart (hang diagnosis) coming
                    # back to its OWN slot of a world that is
                    # otherwise unchanged: hand the current round
                    # back instead of opening a new one — the
                    # healthy members never re-join, so a fresh
                    # round could never complete, and even showing
                    # this node as "waiting" would trip the peers'
                    # membership-change polls into restarting
                    # (surfaced by the multinode hang chaos run)
                    self._rdzv_nodes[node_rank] = meta
                    self._alive_nodes.add(node_id)
                    logger.info(
                        "%s: node %s re-joined round %d in place",
                        self._name, node_rank, self._rdzv_round,
                    )
                    return self._rdzv_round
                self._waiting_nodes[node_rank] = meta
                self._alive_nodes.add(node_id)
                if not self._start_waiting_time:
                    self._start_waiting_time = time.time()
                return self._rdzv_round

    def _is_inplace_rejoin(self, node_rank: int, node_id: int) -> bool:
        """Caller holds the lock.  True when ``node_rank`` already
        belongs to the current multi-node round under the same
        node_id, every member of that round is still alive (no
        capacity change pending — a dead member means the world MUST
        shrink through a new round), and nothing but current members
        sits in the waiting pool (a newcomer means the world is
        re-forming anyway).  Single-node rounds keep the old
        round-per-restart behaviour: there is no peer to disturb and
        the reconvergence trail stays observable."""
        members = self._rdzv_nodes
        if len(members) <= 1 or node_rank not in members:
            return False
        if members[node_rank].node_id != node_id:
            return False  # a REPLACEMENT host re-forms the world
        if any(
            m.node_id not in self._alive_nodes
            for m in members.values()
        ):
            return False
        return all(r in members for r in self._waiting_nodes)

    def _check_rdzv_completed(self) -> bool:
        """Caller holds the lock.  Mirrors reference
        ``_check_rdzv_completed:129``."""
        waiting = len(self._waiting_nodes)
        if waiting == 0:
            return False
        p = self._params
        alive = max(len(self._alive_nodes), 1)
        complete = False
        if waiting >= min(alive, p.max_nodes) and waiting >= p.min_nodes:
            # elastic jobs (min < max): the FIRST round must not
            # complete below max_nodes just because the slower agents
            # have not joined/heartbeated yet — joiner order would
            # decide the initial world.  Below-capacity initial worlds
            # form through the timeout branch; once a round exists,
            # capacity-loss reconvergence stays instant.
            complete = not (
                self._rdzv_round == 0 and waiting < p.max_nodes
            )
        if not complete and (
            waiting >= p.min_nodes
            and self._start_waiting_time
            and time.time() - self._start_waiting_time > p.waiting_timeout
        ):
            complete = True
        if not complete:
            return False
        # cap at max_nodes, then round down to a multiple of node_unit
        unit = p.node_unit
        accept = (min(waiting, p.max_nodes) // unit) * unit
        if accept < max(p.min_nodes, 1):
            return False
        ranks = sorted(self._waiting_nodes.keys())[:accept]
        wait_s = (
            time.time() - self._start_waiting_time
            if self._start_waiting_time else 0.0
        )
        self._rdzv_nodes = {r: self._waiting_nodes.pop(r) for r in ranks}
        self._latest_rdzv_nodes = ranks
        # topology order computed once per completed round; every
        # get_comm_world poll reuses it
        self._rank_order = self._topology_sorter.sort(self._rdzv_nodes)
        self._rdzv_round += 1
        self._start_waiting_time = 0.0
        _ROUND_SECONDS.observe(wait_s, rdzv=self._name)
        _ROUND_GAUGE.set(self._rdzv_round, rdzv=self._name)
        _NODES_GAUGE.set(len(ranks), rdzv=self._name)
        emit_event(
            "rendezvous_complete",
            rdzv=self._name,
            round=self._rdzv_round,
            nodes=ranks,
            wait_s=round(wait_s, 3),
        )
        if self.on_round_complete is not None:
            try:
                self.on_round_complete(
                    self._name, self._rdzv_round, self._participants()
                )
            except Exception:  # noqa: BLE001 - journal must not kill rdzv
                logger.exception("rdzv journal hook failed")
        logger.info(
            "%s rendezvous round %d completed with nodes %s",
            self._name,
            self._rdzv_round,
            ranks,
        )
        return True

    def _participants(self):
        """Caller holds the lock: JSON-safe view of the completed
        world, enough to rebuild it after a master restart."""
        return {
            str(rank): {
                "node_id": meta.node_id,
                "local_world_size": meta.local_world_size,
                "node_ip": meta.node_ip,
            }
            for rank, meta in self._rdzv_nodes.items()
        }

    def current_round(self) -> int:
        with self._lock:
            return self._rdzv_round

    def journal_state(self) -> Dict:
        """Round + completed world for the journal snapshot."""
        with self._lock:
            return {
                "round": self._rdzv_round,
                "participants": self._participants(),
            }

    def restore_round(self, round_: int, participants: Dict) -> None:
        """Master crash recovery: re-enter the journaled round with
        its completed world, so healthy agents polling
        ``get_comm_world`` keep getting the same answer and are NOT
        restarted.  Participants that died during the outage are
        pruned by the normal liveness paths (heartbeat timeout /
        failure report -> remove_alive_node)."""
        with self._lock:
            self._rdzv_round = max(self._rdzv_round, int(round_))
            self._rdzv_nodes = {}
            for rank_s, meta in (participants or {}).items():
                rank = int(rank_s)
                self._rdzv_nodes[rank] = NodeMeta(
                    node_id=int(meta.get("node_id", rank)),
                    node_rank=rank,
                    local_world_size=int(
                        meta.get("local_world_size", 1)
                    ),
                    node_ip=str(meta.get("node_ip", "")),
                )
                self._alive_nodes.add(
                    int(meta.get("node_id", rank))
                )
            self._latest_rdzv_nodes = sorted(self._rdzv_nodes)
            self._rank_order = self._topology_sorter.sort(
                self._rdzv_nodes
            )
            self._start_waiting_time = 0.0

    def num_nodes_waiting(self) -> int:
        """Agents poll this to detect pending membership changes
        (reference servicer ``num_nodes_waiting``)."""
        with self._lock:
            return len(self._waiting_nodes)

    # -- resize coordinator view -------------------------------------------

    def latest_world_size(self) -> int:
        """Nodes in the latest COMPLETED round (0 before the first)."""
        with self._lock:
            return len(self._rdzv_nodes)

    def latest_node_ids(self) -> List[int]:
        """node_ids of the latest completed round's participants."""
        with self._lock:
            return [m.node_id for m in self._rdzv_nodes.values()]

    def alive_node_ids(self) -> List[int]:
        """Current liveness view (joined or heartbeat-confirmed nodes
        minus the ones the failure/heartbeat paths removed) — the
        resize coordinator's measure of available capacity."""
        with self._lock:
            return sorted(self._alive_nodes)

    def waiting_node_ids(self) -> List[int]:
        with self._lock:
            return [m.node_id for m in self._waiting_nodes.values()]

    def _world(self) -> Dict[int, int]:
        """Iteration ORDER of the returned dict is the global rank
        order (preserved through pickle); the topology sorter places
        slice-mates adjacently so DP collectives ride ICI."""
        order = getattr(self, "_rank_order", None) or sorted(
            self._rdzv_nodes
        )
        return {
            rank: self._rdzv_nodes[rank].local_world_size
            for rank in order
        }

    def _coordinator(self) -> str:
        """The torch.distributed rendezvous address: the TCP store of
        the node holding global rank 0, i.e. the first node in topology
        order."""
        if not self._rdzv_nodes:
            return ""
        order = getattr(self, "_rank_order", None) or sorted(
            self._rdzv_nodes
        )
        first = self._rdzv_nodes[order[0]]
        host = first.node_ip or "127.0.0.1"
        return f"{host}:{self._coordinator_port or 52525}"


class ElasticTrainingRendezvousManager(RendezvousManager):
    """Reference ``ElasticTrainingRendezvousManager:291``."""

    def __init__(self):
        super().__init__(name="elastic-training")

    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int], str]:
        """Returns (round, group, {node_rank: local_world_size},
        coordinator_addr); the world is empty while the round is
        incomplete and the agent polls again.  A node that re-joined
        (elastic membership change) is in the waiting pool and only
        sees the new round once it completes."""
        with self._lock:
            if node_rank in self._waiting_nodes:
                self._check_rdzv_completed()
            if node_rank in self._waiting_nodes:
                return self._rdzv_round, 0, {}, ""
            if node_rank in self._rdzv_nodes:
                return self._rdzv_round, 0, self._world(), self._coordinator()
            return self._rdzv_round, 0, {}, ""


class NetworkCheckRendezvousManager(RendezvousManager):
    """Reference ``NetworkCheckRendezvousManager:349``."""

    def __init__(self):
        super().__init__(name="network-check")
        # per check-round status/elapsed: {round: {node_id: value}}
        self._node_status: Dict[int, Dict[int, bool]] = {}
        self._node_times: Dict[int, Dict[int, float]] = {}
        self._check_round = 0
        self._groups: List[List[int]] = []
        # master crash recovery (ROADMAP follow-on): called with each
        # reported (node_id, normal, elapsed, round) so the state
        # journal records check RESULTS, not just round membership —
        # a master crash mid-check no longer loses the reports that
        # already arrived, so fault confirmation ("abnormal in two
        # consecutive rounds") survives the restart
        self.on_status_report = None

    def _is_inplace_rejoin(self, node_rank: int, node_id: int) -> bool:
        """Never: every check ROUND is a fresh join of all members by
        design (round 0 neighbour pairs, round 1 re-paired by elapsed
        time) — resolving a join in place would stop the second round
        from ever forming."""
        return False

    def _group_nodes(self, ranks: List[int]) -> List[List[int]]:
        """Round 0: neighbour pairs; round >0: sorted by previous
        elapsed, pair fastest with slowest (reference
        ``_group_nodes:408``)."""
        if self._check_round > 0 and self._node_times.get(
            self._check_round - 1
        ):
            prev = self._node_times[self._check_round - 1]
            id_by_rank = {
                r: self._rdzv_nodes[r].node_id for r in ranks
            }
            ranks = sorted(
                ranks,
                key=lambda r: prev.get(id_by_rank[r], 0.0),
            )
            groups = []
            lo, hi = 0, len(ranks) - 1
            while lo < hi:
                groups.append([ranks[lo], ranks[hi]])
                lo += 1
                hi -= 1
            if lo == hi:
                if groups:
                    groups[-1].append(ranks[lo])
                else:
                    groups.append([ranks[lo]])
            return groups
        groups = []
        for i in range(0, len(ranks) - 1, 2):
            groups.append([ranks[i], ranks[i + 1]])
        if len(ranks) % 2 == 1:
            if groups:
                groups[-1].append(ranks[-1])
            else:
                groups.append([ranks[-1]])
        return groups

    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int], str]:
        """Returns (round, group_index, world restricted to this node's
        group, group coordinator)."""
        with self._lock:
            if node_rank in self._waiting_nodes:
                if self._check_rdzv_completed():
                    ranks = sorted(self._rdzv_nodes.keys())
                    self._groups = self._group_nodes(ranks)
                    self._check_round += 1
            if node_rank in self._waiting_nodes:
                return self._rdzv_round, 0, {}, ""
            if node_rank in self._rdzv_nodes:
                for idx, group in enumerate(self._groups):
                    if node_rank in group:
                        world = {
                            r: self._rdzv_nodes[r].local_world_size
                            for r in sorted(group)
                        }
                        first = self._rdzv_nodes[min(group)]
                        host = first.node_ip or "127.0.0.1"
                        port = (self._coordinator_port or 52525) + 1 + idx
                        return (
                            self._rdzv_round,
                            idx,
                            world,
                            f"{host}:{port}",
                        )
            return self._rdzv_round, 0, {}, ""

    def report_network_status(
        self, node_id: int, normal: bool, elapsed: float
    ):
        with self._lock:
            rnd = max(self._check_round - 1, 0)
            self._node_status.setdefault(rnd, {})[node_id] = normal
            self._node_times.setdefault(rnd, {})[node_id] = elapsed
        if self.on_status_report is not None:
            try:  # journal OUTSIDE the lock: fsync under it would
                # serialize every concurrent report on disk latency
                self.on_status_report(node_id, bool(normal),
                                      float(elapsed), rnd)
            except Exception:  # noqa: BLE001 - journal must not kill
                logger.exception("netcheck journal hook failed")

    def restore_status(
        self, round_: int, node_id: int, normal: bool, elapsed: float
    ):
        """Journal replay: re-apply one reported check result at the
        round it was recorded for (idempotent — same record twice
        lands on the same cell)."""
        with self._lock:
            rnd = int(round_)
            self._node_status.setdefault(rnd, {})[int(node_id)] = bool(
                normal
            )
            self._node_times.setdefault(rnd, {})[int(node_id)] = float(
                elapsed
            )
            self._check_round = max(self._check_round, rnd + 1)

    def journal_state(self) -> Dict:
        """Round membership PLUS the check state (statuses, elapsed
        times, grouping, check round) for the journal snapshot."""
        out = super().journal_state()
        with self._lock:
            out["check"] = {
                "check_round": self._check_round,
                "groups": [list(g) for g in self._groups],
                "node_status": {
                    str(rnd): {str(n): ok for n, ok in st.items()}
                    for rnd, st in self._node_status.items()
                },
                "node_times": {
                    str(rnd): {str(n): t for n, t in tm.items()}
                    for rnd, tm in self._node_times.items()
                },
            }
        return out

    def restore_round(self, round_: int, participants: Dict) -> None:
        """A journaled network-check round also restores its pairwise
        grouping so re-joined agents polling ``get_comm_world`` see
        the same groups, and the check-round counter advances."""
        super().restore_round(round_, participants)
        with self._lock:
            if int(round_) > 0 and self._check_round < int(round_):
                # mirror the live completion ordering exactly:
                # get_comm_world builds groups BEFORE bumping
                # _check_round, so round R's grouping reads round
                # R-2's elapsed times (replayed from the
                # netcheck_status records that precede this round
                # record in the journal).  Grouping after the bump
                # would read the not-yet-replayed round R-1 and fall
                # back to neighbour pairs — diverging from what the
                # pre-crash agents were already paired as.
                self._check_round = int(round_) - 1
                self._groups = self._group_nodes(
                    sorted(self._rdzv_nodes.keys())
                )
                self._check_round = int(round_)

    def restore_check_state(self, state: Dict) -> None:
        """Snapshot replay epilogue: load the full check state the
        snapshot captured (overrides what the round record derived)."""
        check = (state or {}).get("check") or {}
        if not check:
            return
        with self._lock:
            self._check_round = max(
                self._check_round, int(check.get("check_round", 0))
            )
            groups = check.get("groups") or []
            if groups:
                self._groups = [
                    [int(r) for r in group] for group in groups
                ]
            for rnd_s, st in (check.get("node_status") or {}).items():
                dst = self._node_status.setdefault(int(rnd_s), {})
                for node_s, ok in st.items():
                    dst[int(node_s)] = bool(ok)
            for rnd_s, tm in (check.get("node_times") or {}).items():
                dst = self._node_times.setdefault(int(rnd_s), {})
                for node_s, t in tm.items():
                    dst[int(node_s)] = float(t)

    def check_fault_node(self) -> Tuple[List[int], str]:
        """Fault = abnormal in the latest round AND in the previous
        round (if one exists); a single-round abnormal result asks for
        another round first (reference ``check_fault_node:507``)."""
        with self._lock:
            rnd = max(self._check_round - 1, 0)
            cur = self._node_status.get(rnd, {})
            expected = {m.node_id for m in self._rdzv_nodes.values()}
            if expected and not expected.issubset(cur.keys()):
                return [], "waiting-for-reports"
            abnormal = sorted(n for n, ok in cur.items() if not ok)
            if not abnormal:
                return [], "all-normal"
            if rnd == 0:
                return abnormal, "need-second-round"
            prev = self._node_status.get(rnd - 1, {})
            confirmed = sorted(
                n for n in abnormal if prev.get(n, True) is False
            )
            return confirmed, "confirmed"

    def detect_stragglers(self) -> Tuple[List[int], float]:
        """Nodes slower than ``straggler_factor ×`` median elapsed
        (reference ``_detect_stragglers:550``).  At exactly 2 nodes
        the baseline is the FASTER node (``median_low``): the
        interpolated median would average the straggler's own time
        into the baseline, so a straggler could never exceed 2x the
        "median" of itself and the healthy node and the rule would be
        a no-op.  With >=3 nodes the reference's interpolated median
        applies unchanged."""
        with self._lock:
            rnd = max(self._check_round - 1, 0)
            times = self._node_times.get(rnd, {})
            if len(times) < 2:
                return [], 0.0
            if len(times) == 2:
                med = statistics.median_low(times.values())
            else:
                med = statistics.median(times.values())
            if med <= 0:
                return [], med
            factor = NetworkCheckConstant.STRAGGLER_FACTOR
            return (
                sorted(n for n, t in times.items() if t > factor * med),
                med,
            )

    def network_check_success(self) -> bool:
        fault, reason = self.check_fault_node()
        return not fault and reason in ("all-normal",)
