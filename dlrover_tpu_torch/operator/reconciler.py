"""ElasticJob reconciler.

Reference: ``ElasticJobReconciler.Reconcile``
(``dlrover/go/operator/pkg/controllers/elasticjob_controller.go:85``)
+ master pod factory (``pkg/controllers/master/master.go``): for every
ElasticJob CR, ensure the job-master pod exists, reflect its state
into the job's phase/conditions, and clean up on completion.  The
master then owns worker pods itself (PodScaler) or writes ScalePlans.

Copy of ``dlrover_tpu/operator/reconciler.py`` (the port imports nothing
of the JAX package); host code, as in the reference. The worker pods run
the port's launcher, ``python -m dlrover_tpu_torch.run``, where the
reference's run its ``tpurun``; the CRD group and the pod labels are the
reference's.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.scheduler.kubernetes import K8sClient


class JobPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


def master_pod_name(job_name: str) -> str:
    return f"elasticjob-{job_name}-master"


def owner_reference(job_name: str, uid: str) -> list:
    """A valid ownerReference needs the owning CR's uid (the API
    server rejects it otherwise) — emit none when the uid is unknown
    (mock / plan-driven paths); the reconciler's explicit GC covers
    cleanup there."""
    if not uid:
        return []
    return [
        {
            "apiVersion": "elastic.dlrover-tpu.org/v1alpha1",
            "kind": "ElasticJob",
            "name": job_name,
            "uid": uid,
            "controller": True,
            "blockOwnerDeletion": True,
        }
    ]


def build_master_pod(job_name: str, spec: Dict, uid: str = "") -> Dict:
    """Reference: master pod factory, pkg/controllers/master/master.go."""
    worker_spec = spec.get("replicaSpecs", {}).get("worker", {})
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": master_pod_name(job_name),
            "labels": {
                "app": "dlrover-tpu",
                "job": job_name,
                "role": "master",
                "node-id": "-1",
            },
            "ownerReferences": owner_reference(job_name, uid),
        },
        "spec": {
            "restartPolicy": "Never",
            "containers": [
                {
                    "name": "master",
                    "command": [
                        "python", "-m", "dlrover_tpu_torch.master.main",
                        "--job_name", job_name,
                        "--node_num",
                        str(worker_spec.get("replicas", 1)),
                        "--platform", "kubernetes",
                    ],
                    "env": [
                        {"name": NodeEnv.JOB_NAME, "value": job_name},
                    ],
                }
            ],
        },
    }


class ElasticJobReconciler:
    def __init__(self, client: K8sClient):
        self._client = client

    def reconcile_once(self, jobs: Dict[str, Dict]) -> Dict[str, str]:
        """Process {job_name: elasticjob_cr}; returns {name: phase}.

        Idempotent — exactly the reconcile contract of the Go
        controller (missing master pod -> create; completed master ->
        propagate phase).
        """
        phases: Dict[str, str] = {}
        existing = {
            p["metadata"]["name"]: p
            for p in self._client.list_pods("app=dlrover-tpu")
        }
        # GC: pods owned by jobs whose CR is gone (a real cluster does
        # this via ownerReferences cascade; the mock needs it explicit)
        for pod_name, pod in list(existing.items()):
            labels = pod.get("metadata", {}).get("labels", {})
            owner = labels.get("job", "")
            if owner and owner not in jobs:
                logger.info(
                    "garbage-collecting pod %s of deleted job %s",
                    pod_name, owner,
                )
                self._client.delete_pod(pod_name)
                existing.pop(pod_name, None)
        for name, cr in jobs.items():
            pod_name = master_pod_name(name)
            pod = existing.get(pod_name)
            if pod is None:
                body = build_master_pod(
                    name, cr.get("spec", {}),
                    uid=cr.get("metadata", {}).get("uid", ""),
                )
                self._client.create_pod(body)
                phases[name] = JobPhase.PENDING
                logger.info(
                    "created master pod %s for job %s", pod_name, name
                )
                continue
            phase = pod.get("status", {}).get("phase", "Pending")
            phases[name] = {
                "Pending": JobPhase.PENDING,
                "Running": JobPhase.RUNNING,
                "Succeeded": JobPhase.SUCCEEDED,
                "Failed": JobPhase.FAILED,
            }.get(phase, JobPhase.PENDING)
            cr.setdefault("status", {})["phase"] = phases[name]
            cr["status"]["masterPod"] = pod_name
        return phases

    def run(self, get_jobs, interval: float = 5.0, stop_event=None):
        """Polling controller loop (simple deployments / tests)."""
        while stop_event is None or not stop_event.is_set():
            try:
                self.reconcile_once(get_jobs())
            except Exception:  # noqa: BLE001
                logger.exception("reconcile failed")
            time.sleep(interval)

    def run_watch(
        self, get_jobs, stop_event, resync_interval: float = 30.0
    ):
        """Informer-style controller loop (the Go operator's
        controller-runtime contract): a pod watch stream triggers a
        reconcile immediately on any cluster change, and a periodic
        resync covers events the stream missed.  A dying watch
        stream degrades to resync-interval polling, never to a
        stopped controller."""
        import queue
        import threading

        wake: "queue.Queue[str]" = queue.Queue()
        _STOP = "__stop__"

        def pump():
            try:
                while not stop_event.is_set():
                    try:
                        for etype, _pod in self._client.watch_pods(
                            "app=dlrover-tpu"
                        ):
                            wake.put(etype)
                            if stop_event.is_set():
                                return
                    except Exception:  # noqa: BLE001
                        logger.exception(
                            "pod watch failed; retrying"
                        )
                    # stream ended (idle timeout / apiserver hiccup)
                    stop_event.wait(0.5)
            finally:
                # unblock the main loop so shutdown is prompt, not
                # delayed by up to resync_interval
                wake.put(_STOP)

        threading.Thread(
            target=pump, daemon=True, name="elasticjob-watch"
        ).start()
        while not stop_event.is_set():
            try:
                self.reconcile_once(get_jobs())
            except Exception:  # noqa: BLE001
                logger.exception("reconcile failed")
            try:
                if wake.get(timeout=resync_interval) == _STOP:
                    return
                while True:  # drain the burst into one reconcile
                    try:
                        if wake.get_nowait() == _STOP:
                            return
                    except queue.Empty:
                        break
            except queue.Empty:
                pass  # periodic resync


def build_worker_pod(job_name: str, item: Dict) -> Dict:
    """Worker pod body from a ScalePlan createPods entry (reference:
    pod factory in scaleplan_controller.go)."""
    node_id = int(item.get("id", 0))
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": item.get(
                "name", f"{job_name}-worker-{node_id}"
            ),
            "labels": {
                "app": "dlrover-tpu",
                "job": job_name,
                "elasticjob-name": job_name,
                "node-type": item.get("type", "worker"),
                "node-id": str(node_id),
                "rank": str(item.get("rankIndex", node_id)),
            },
            "ownerReferences": owner_reference(
                job_name, item.get("ownerUid", "")
            ),
        },
        "spec": {
            "restartPolicy": "Never",
            "containers": [
                {
                    "name": "worker",
                    "command": ["python", "-m", "dlrover_tpu_torch.run"],
                    "env": [
                        {"name": NodeEnv.JOB_NAME, "value": job_name},
                        {
                            "name": NodeEnv.NODE_ID,
                            "value": str(node_id),
                        },
                    ],
                }
            ],
        },
    }


class ScalePlanReconciler:
    """Operator side of the ScalePlan CRD: executes plans the master's
    ``ElasticJobScaler`` writes — creates/removes worker pods — and
    records the outcome in the CR status (reference:
    ``scaleplan_controller.go``; the master-side consumer of externally
    written plans is ``master.watcher.ScalePlanWatcher``)."""

    def __init__(self, client: K8sClient):
        self._client = client

    def reconcile_once(self) -> int:
        from dlrover_tpu_torch.master.watcher import (
            SCALE_PLAN_TERMINAL_PHASES,
        )

        executed = 0
        for cr in self._client.list_scale_plan_crs():
            status = cr.get("status", {})
            if status.get("phase") in SCALE_PLAN_TERMINAL_PHASES:
                continue
            spec = cr.get("spec", {})
            job_name = spec.get("ownerJob", "")
            name = cr.get("metadata", {}).get("name", "unnamed")
            created, removed = 0, 0
            try:
                for item in spec.get("createPods", []):
                    if self._client.create_pod(
                        build_worker_pod(job_name, item)
                    ):
                        created += 1
                for item in spec.get("removePods", []):
                    if self._client.delete_pod(item.get("name", "")):
                        removed += 1
                cr.setdefault("status", {})["phase"] = "Succeeded"
            except Exception as e:  # noqa: BLE001
                logger.exception("scale plan %s failed", name)
                cr.setdefault("status", {})["phase"] = "Failed"
                cr["status"]["message"] = str(e)
            cr["status"]["createdPods"] = created
            cr["status"]["removedPods"] = removed
            self._client.patch_scale_plan_status(name, cr)
            executed += 1
            logger.info(
                "scale plan %s: created %s removed %s pods",
                name, created, removed,
            )
        return executed

    def run(self, interval: float = 3.0, stop_event=None):
        while stop_event is None or not stop_event.is_set():
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001
                logger.exception("scale-plan reconcile failed")
            time.sleep(interval)
