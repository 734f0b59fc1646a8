"""Kubernetes client wrapper.

Copy of ``dlrover_tpu/scheduler/kubernetes.py`` (the port imports
nothing of the JAX package).

Reference: ``k8sClient`` (``dlrover/python/scheduler/kubernetes.py:121``)
— a thin facade over the official client (create/get/delete pods,
patch CRs, watch) that the scaler/watcher layers consume.  The real
``kubernetes`` package is optional (absent on TPU-VM test images);
tests inject :class:`MockK8sApi`, mirroring the reference's
``mock_k8s_client`` fixture (test_utils.py:268).

Pods here are plain dicts shaped like V1Pod manifests — the TPU
deployment story runs the agent per TPU-VM host in a GKE pod.
"""

import threading
import time
from queue import Empty, Queue
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.log import default_logger as logger

_POD_STATUS_MAP = {
    "Pending": NodeStatus.PENDING,
    "Running": NodeStatus.RUNNING,
    "Succeeded": NodeStatus.SUCCEEDED,
    "Failed": NodeStatus.FAILED,
    "Unknown": NodeStatus.UNKNOWN,
}


def pod_status_to_node_status(phase: str) -> str:
    return _POD_STATUS_MAP.get(phase, NodeStatus.UNKNOWN)


class K8sApi:
    """Interface the real/mock API objects implement."""

    def create_pod(self, namespace: str, body: Dict) -> bool:
        raise NotImplementedError

    def delete_pod(self, namespace: str, name: str) -> bool:
        raise NotImplementedError

    def list_pods(self, namespace: str, label_selector: str) -> List[Dict]:
        raise NotImplementedError

    def patch_custom_resource(
        self, group: str, version: str, namespace: str, plural: str,
        name: str, body: Dict,
    ) -> bool:
        raise NotImplementedError

    def create_custom_resource(
        self, group: str, version: str, namespace: str, plural: str,
        body: Dict,
    ) -> bool:
        raise NotImplementedError

    def list_custom_resources(
        self, group: str, version: str, namespace: str, plural: str,
    ) -> List[Dict]:
        raise NotImplementedError

    def watch_pods(self, namespace: str, label_selector: str):
        """Yield (event_type, pod_dict) tuples; blocks."""
        raise NotImplementedError


class RealK8sApi(K8sApi):  # pragma: no cover - needs a cluster
    """Official-client backing; only importable inside a cluster."""

    def __init__(self):
        from kubernetes import client, config, watch

        try:
            config.load_incluster_config()
        except Exception:  # noqa: BLE001
            config.load_kube_config()
        self._core = client.CoreV1Api()
        self._custom = client.CustomObjectsApi()
        self._watch_mod = watch

    def create_pod(self, namespace, body):
        self._core.create_namespaced_pod(namespace, body)
        return True

    def delete_pod(self, namespace, name):
        self._core.delete_namespaced_pod(name, namespace)
        return True

    def list_pods(self, namespace, label_selector):
        pods = self._core.list_namespaced_pod(
            namespace, label_selector=label_selector
        )
        return [p.to_dict() for p in pods.items]

    def patch_custom_resource(self, group, version, namespace, plural,
                              name, body):
        self._custom.patch_namespaced_custom_object(
            group, version, namespace, plural, name, body
        )
        return True

    def list_custom_resources(self, group, version, namespace, plural):
        out = self._custom.list_namespaced_custom_object(
            group, version, namespace, plural
        )
        return list(out.get("items", []))

    def create_custom_resource(self, group, version, namespace, plural,
                               body):
        self._custom.create_namespaced_custom_object(
            group, version, namespace, plural, body
        )
        return True

    def watch_pods(self, namespace, label_selector):
        w = self._watch_mod.Watch()
        for event in w.stream(
            self._core.list_namespaced_pod, namespace,
            label_selector=label_selector,
        ):
            yield event["type"].lower(), event["object"].to_dict()


class MockK8sApi(K8sApi):
    """In-memory cluster for tests (reference: mock_k8s_client)."""

    def __init__(self):
        self.pods: Dict[str, Dict] = {}
        self.custom_resources: Dict[str, Dict] = {}
        # one queue PER WATCH STREAM — real Kubernetes delivers each
        # event to every open watch, so two streams (even on the same
        # label selector) must both see every event (a shared
        # per-selector queue would split events between them
        # nondeterministically, ADVICE r2); a stream's queue is
        # discarded when its generator exits, so departed consumers
        # never accumulate events.  Replay follows resourceVersion
        # semantics keyed by consumer thread (every real watch
        # consumer — PodWatcher, the reconciler pump — owns a
        # dedicated thread): a thread's FIRST subscribe replays
        # buffered history (list+watch from rv 0), its re-subscribes
        # resume after the last event it was delivered, so the 1s
        # idle-return/re-subscribe cycle never re-delivers the whole
        # history forever.
        self._streams: List["Queue[tuple]"] = []
        self._watch_lock = threading.Lock()
        self._history: List[tuple] = []  # (seq, event)
        self._seq = 0
        # consumer identity is a THREAD-LOCAL token, not
        # threading.get_ident(): CPython recycles idents, so a new
        # watcher thread could inherit a dead thread's cursor and
        # silently skip its first history replay; thread-local data
        # dies with its thread, so a fresh thread always gets a fresh
        # token (and replays history, like list+watch from rv 0)
        self._tls = threading.local()
        self._next_token = 0
        self._cursors: Dict[int, int] = {}  # consumer token -> next seq
        self.create_calls = 0
        self.delete_calls = 0

    def _consumer_token(self) -> int:
        tok = getattr(self._tls, "token", None)
        if tok is None:
            with self._watch_lock:
                tok = self._next_token
                self._next_token += 1
            self._tls.token = tok
        return tok

    def _emit(self, event: tuple):
        import copy

        # deep-copy the payload: emitters pass dict(pod), but the
        # nested status dict stays SHARED with the live pod object —
        # a later set_pod_phase/delete_pod would rewrite the phase
        # inside events still sitting in consumer queues
        event = (event[0], copy.deepcopy(event[1]))
        with self._watch_lock:
            item = (self._seq, event)
            self._seq += 1
            self._history.append(item)
            del self._history[:-1000]
            streams = list(self._streams)
        for q in streams:
            q.put(item)

    def _register_stream(self) -> "Queue[tuple]":
        tok = self._consumer_token()
        with self._watch_lock:
            q = Queue()
            start = self._cursors.get(tok, 0)
            for seq, event in self._history:
                if seq >= start:
                    q.put((seq, event))
            self._streams.append(q)
            return q

    def _unregister_stream(self, q):
        with self._watch_lock:
            try:
                self._streams.remove(q)
            except ValueError:
                pass

    def create_pod(self, namespace, body):
        name = body["metadata"]["name"]
        body.setdefault("status", {})["phase"] = "Pending"
        self.pods[name] = body
        self.create_calls += 1
        self._emit(("added", dict(body)))
        return True

    def delete_pod(self, namespace, name):
        pod = self.pods.pop(name, None)
        self.delete_calls += 1
        if pod is not None:
            pod.setdefault("status", {})["phase"] = "Failed"
            pod["status"]["reason"] = "Deleted"
            self._emit(("deleted", dict(pod)))
        return True

    def set_pod_phase(self, name: str, phase: str, reason: str = "",
                      exit_code: int = 0):
        pod = self.pods.get(name)
        if pod is None:
            return
        pod.setdefault("status", {})["phase"] = phase
        if reason:
            pod["status"]["reason"] = reason
        if exit_code:
            pod["status"]["container_exit_code"] = exit_code
        self._emit(("modified", dict(pod)))

    def list_pods(self, namespace, label_selector):
        return list(self.pods.values())

    def patch_custom_resource(self, group, version, namespace, plural,
                              name, body):
        self.custom_resources[f"{plural}/{name}"] = body
        return True

    def create_custom_resource(self, group, version, namespace, plural,
                               body):
        name = body.get("metadata", {}).get("name", "unnamed")
        self.custom_resources[f"{plural}/{name}"] = body
        return True

    def list_custom_resources(self, group, version, namespace, plural):
        prefix = f"{plural}/"
        return [
            body for key, body in self.custom_resources.items()
            if key.startswith(prefix)
        ]

    def watch_pods(self, namespace, label_selector):
        q = self._register_stream()
        tok = self._consumer_token()
        try:
            while True:
                try:
                    seq, event = q.get(timeout=1.0)
                except Empty:
                    return
                with self._watch_lock:
                    self._cursors[tok] = max(
                        self._cursors.get(tok, 0), seq + 1
                    )
                yield event
        finally:
            self._unregister_stream(q)


class K8sClient:
    """Facade used by scalers/watchers (reference: k8sClient:121)."""

    _singleton: Optional["K8sClient"] = None

    def __init__(self, namespace: str = "default",
                 api: Optional[K8sApi] = None):
        self.namespace = namespace
        self.api = api or RealK8sApi()

    @classmethod
    def singleton(cls, namespace: str = "default",
                  api: Optional[K8sApi] = None) -> "K8sClient":
        if cls._singleton is None:
            cls._singleton = cls(namespace, api)
        return cls._singleton

    @classmethod
    def reset(cls):
        cls._singleton = None

    def create_pod(self, body: Dict) -> bool:
        try:
            return self.api.create_pod(self.namespace, body)
        except Exception as e:  # noqa: BLE001
            logger.error("create_pod failed: %s", e)
            return False

    def delete_pod(self, name: str) -> bool:
        try:
            return self.api.delete_pod(self.namespace, name)
        except Exception as e:  # noqa: BLE001
            logger.error("delete_pod failed: %s", e)
            return False

    def list_pods(self, label_selector: str = "") -> List[Dict]:
        return self.api.list_pods(self.namespace, label_selector)

    def watch_pods(self, label_selector: str = ""):
        return self.api.watch_pods(self.namespace, label_selector)

    def apply_scale_plan_cr(self, name: str, body: Dict) -> bool:
        """Write a ScalePlan custom resource for the operator
        (reference: ElasticJobScaler -> ScalePlan CRD)."""
        return self.api.create_custom_resource(
            "elastic.dlrover-tpu.org", "v1alpha1", self.namespace,
            "scaleplans", body,
        )

    def list_scale_plan_crs(self) -> List[Dict]:
        try:
            return self.api.list_custom_resources(
                "elastic.dlrover-tpu.org", "v1alpha1", self.namespace,
                "scaleplans",
            )
        except Exception as e:  # noqa: BLE001
            logger.error("list_scale_plan_crs failed: %s", e)
            return []

    def patch_scale_plan_status(self, name: str, body: Dict) -> bool:
        try:
            return self.api.patch_custom_resource(
                "elastic.dlrover-tpu.org", "v1alpha1", self.namespace,
                "scaleplans", name, body,
            )
        except Exception as e:  # noqa: BLE001
            logger.error("patch_scale_plan_status failed: %s", e)
            return False
