"""Scale-plan execution.

Copy of ``dlrover_tpu/master/scaler.py`` (the port imports nothing of
the JAX package).

Reference: ``ScalePlan`` + ``PodScaler`` (``dlrover/python/master/
scaler/pod_scaler.py:78,212,421``) and ``ElasticJobScaler``
(``scaler/elasticjob_scaler.py``): a scale plan names the target
replica counts and explicit create/remove lists; the pod scaler
executes it directly against the k8s API with a retrying create
queue, while the ElasticJob flavour writes a ScalePlan custom
resource for the operator to reconcile.
"""

import threading
import time
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeEnv, NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node, NodeGroupResource
from dlrover_tpu_torch.scheduler.kubernetes import K8sClient


@dataclass
class ScalePlan:
    """Reference: ScalePlan CRD spec (scaleplan_types.go:29-80)."""

    node_group_resources: Dict[str, NodeGroupResource] = field(
        default_factory=dict
    )
    launch_nodes: List[Node] = field(default_factory=list)
    remove_nodes: List[Node] = field(default_factory=list)

    def empty(self) -> bool:
        return not (
            self.node_group_resources
            or self.launch_nodes
            or self.remove_nodes
        )


class Scaler:
    def scale(self, plan: ScalePlan):
        raise NotImplementedError

    def start(self):
        pass

    def stop(self):
        pass


class PodScaler(Scaler):
    """Direct pod create/delete with a retrying create queue
    (reference: PodScaler:78, _periodic_create_pod:421)."""

    def __init__(self, job_name: str, client: K8sClient,
                 master_addr: str = ""):
        self._job_name = job_name
        self._client = client
        self._master_addr = master_addr
        self._create_queue: "Queue[Node]" = Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._periodic_create_pod, daemon=True,
                name="pod-creator",
            )
            self._thread.start()

    def stop(self):
        self._stop.set()

    def pod_name(self, node: Node) -> str:
        return f"{self._job_name}-{node.type}-{node.id}"

    def _pod_body(self, node: Node) -> Dict:
        res = node.config_resource
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": self.pod_name(node),
                "labels": {
                    "app": "dlrover-tpu",
                    "job": self._job_name,
                    "node-type": node.type,
                    "node-id": str(node.id),
                    "rank": str(node.rank_index),
                },
            },
            "spec": {
                "restartPolicy": "Never",
                "containers": [
                    {
                        "name": "main",
                        "env": [
                            {"name": NodeEnv.MASTER_ADDR,
                             "value": self._master_addr},
                            {"name": NodeEnv.NODE_ID,
                             "value": str(node.id)},
                            {"name": NodeEnv.NODE_RANK,
                             "value": str(node.rank_index)},
                        ],
                        "resources": {
                            "limits": {
                                "cpu": res.cpu,
                                "memory": f"{int(res.memory_mb)}Mi",
                                "nvidia.com/gpu": res.chips,
                            }
                        },
                    }
                ],
            },
        }

    def scale(self, plan: ScalePlan):
        for node in plan.launch_nodes:
            self._create_queue.put(node)
        for node in plan.remove_nodes:
            self._client.delete_pod(self.pod_name(node))

    def _periodic_create_pod(self):
        while not self._stop.is_set():
            try:
                node = self._create_queue.get(timeout=1.0)
            except Empty:
                continue
            if not self._client.create_pod(self._pod_body(node)):
                logger.warning(
                    "pod create failed for node %s; requeueing", node.id
                )
                time.sleep(3)
                self._create_queue.put(node)


class ElasticJobScaler(Scaler):
    """Writes ScalePlan CRs for the operator to reconcile (reference:
    elasticjob_scaler.py)."""

    def __init__(self, job_name: str, client: K8sClient):
        self._job_name = job_name
        self._client = client
        self._plan_index = 0

    def scale(self, plan: ScalePlan):
        body = {
            "apiVersion": "elastic.dlrover-tpu.org/v1alpha1",
            "kind": "ScalePlan",
            "metadata": {
                "name": f"{self._job_name}-scaleplan-{self._plan_index}",
                # origin=master: this plan is pod-level instructions
                # FOR the operator; the master's own ScalePlanWatcher
                # must not loop it back into the job manager
                "labels": {
                    "elasticjob-name": self._job_name,
                    "origin": "master",
                },
            },
            "spec": {
                "ownerJob": self._job_name,
                "replicaResourceSpecs": {
                    t: {
                        "replicas": g.count,
                        "resource": g.node_resource.to_dict(),
                    }
                    for t, g in plan.node_group_resources.items()
                },
                "createPods": [
                    {"name": f"{self._job_name}-{n.type}-{n.id}",
                     "type": n.type, "id": n.id, "rankIndex": n.rank_index}
                    for n in plan.launch_nodes
                ],
                "removePods": [
                    {"name": f"{self._job_name}-{n.type}-{n.id}"}
                    for n in plan.remove_nodes
                ],
            },
        }
        self._client.apply_scale_plan_cr(
            body["metadata"]["name"], body
        )
        self._plan_index += 1
