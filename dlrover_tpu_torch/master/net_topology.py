"""Network-topology-aware rendezvous ordering.

Copy of ``dlrover_tpu/master/net_topology.py`` (the port imports
nothing of the JAX package).

Reference: ``DpTopologySorter`` / ``DefaultTopologyQuerier``
(``dlrover/python/master/elastic_training/net_topology.py:21,57,62``):
nodes are sorted by their access switch so DP ring traffic stays
intra-switch.  The TPU equivalent keys on (slice, host index): data
rides ICI within a pod slice and the much slower DCN across slices,
so rank-adjacent nodes must be slice-contiguous.  The querier is
pluggable — GKE exposes slice/worker identity via the
``TPU_WORKER_ID``-style metadata a deployment can forward; the default
querier parses a ``slice:host`` hint from the node's reported label
or falls back to joining order.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class NodeTopologyMeta:
    """What the sorter knows about one node (reference:
    ``NodeTopologyMeta:21``)."""

    node_rank: int = 0
    node_ip: str = ""
    slice_id: str = ""
    host_index: int = 0


class TopologyQuerier:
    """Maps a node to its fabric coordinates; pluggable (reference:
    ``DefaultTopologyQuerier:57`` is a stub too — the deployment
    wires a real querier)."""

    def query(self, node_rank: int, node_ip: str) -> Tuple[str, int]:
        """Returns (slice_id, host_index); ("", rank) when unknown."""
        raise NotImplementedError


class DefaultTopologyQuerier(TopologyQuerier):
    """No external topology source: keep numeric node-rank order."""

    def query(self, node_rank: int, node_ip: str) -> Tuple[str, int]:
        return "", node_rank


class LabelTopologyQuerier(TopologyQuerier):
    """Topology from per-node labels registered by the scheduler or
    agents (``register(node_rank, "slice0:3")``)."""

    def __init__(self, labels: Dict[int, str] = None):
        self._labels = dict(labels or {})

    def register(self, node_rank: int, label: str):
        self._labels[node_rank] = label

    def query(self, node_rank: int, node_ip: str) -> Tuple[str, int]:
        label = self._labels.get(node_rank, "")
        if ":" in label:
            slice_id, _, host = label.partition(":")
            try:
                return slice_id, int(host)
            except ValueError:
                return slice_id, node_rank
        return label, node_rank


@dataclass
class DpTopologySorter:
    """Orders rendezvous nodes so rank-adjacent nodes share a slice
    (reference: ``DpTopologySorter:62`` keeps DP rings intra-switch)."""

    querier: TopologyQuerier = field(
        default_factory=DefaultTopologyQuerier
    )

    def sort(self, nodes: Dict[int, "object"]) -> List[int]:
        """{node_rank: NodeMeta-like with .node_ip} -> rank order."""
        keyed = []
        for rank, meta in nodes.items():
            slice_id, host = self.querier.query(
                rank, getattr(meta, "node_ip", "")
            )
            keyed.append(((slice_id, host, rank), rank))
        return [rank for _, rank in sorted(keyed)]
