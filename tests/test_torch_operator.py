"""Twins of ``tests/test_operator.py`` for the port's operator
(``dlrover_tpu_torch/operator/``), with the two operator-side cases of
``tests/test_node_manager.py`` (``test_scaleplan_operator_roundtrip``,
``test_scaleplan_watcher_skips_master_origin_plans``), which waited for
this package.

Each case runs the same reconcile sequence through both packages over
their own fake ``K8sClient`` (``MockK8sApi``) and holds the port's pods,
phases and call counts equal to the reference's; the pods differ only in
the launcher command, which names each package's own.  The CRD manifests
are the reference's byte for byte and parse alike.
"""

import json
import os
import threading
import time

import pytest

from dlrover_tpu.operator import reconciler as j_rec
from dlrover_tpu.scheduler import kubernetes as j_k8s
from dlrover_tpu_torch.operator import ElasticJobReconciler, JobPhase
from dlrover_tpu_torch.operator import reconciler as p_rec
from dlrover_tpu_torch.operator.reconciler import master_pod_name
from dlrover_tpu_torch.scheduler import kubernetes as p_k8s
from dlrover_tpu_torch.scheduler.kubernetes import K8sClient, MockK8sApi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRD_DIR = os.path.join(ROOT, "dlrover_tpu_torch", "operator", "crds")
J_CRD_DIR = os.path.join(ROOT, "dlrover_tpu", "operator", "crds")
PACKAGES = {"port": (p_rec, p_k8s), "ref": (j_rec, j_k8s)}


def _job_cr(name="j1", replicas=2):
    return {
        "apiVersion": "elastic.dlrover-tpu.org/v1alpha1",
        "kind": "ElasticJob",
        "metadata": {"name": name},
        "spec": {
            "distributionStrategy": "AllreduceStrategy",
            "replicaSpecs": {"worker": {"replicas": replicas}},
        },
    }


def _neutral(pods):
    """The pods with each package's own name taken out of their
    command lines (``dlrover_tpu_torch.x`` / ``dlrover_tpu.x``, the
    launcher ``python -m dlrover_tpu_torch.run`` / ``tpurun``)."""
    text = json.dumps(pods, sort_keys=True)
    text = text.replace('"python", "-m", "dlrover_tpu_torch.run"',
                        '"tpurun"').replace("dlrover_tpu_torch.",
                                            "dlrover_tpu.")
    return json.loads(text)


def _both(fn):
    """``fn(rec_module, k8s_module) -> result`` for both packages."""
    return {name: fn(*mods) for name, mods in PACKAGES.items()}


def test_reconcile_creates_master_pod_once():
    api = MockK8sApi()
    client = K8sClient(namespace="test", api=api)
    rec = ElasticJobReconciler(client)
    jobs = {"j1": _job_cr()}
    phases = rec.reconcile_once(jobs)
    assert phases == {"j1": JobPhase.PENDING}
    assert master_pod_name("j1") in api.pods
    cmd = api.pods[master_pod_name("j1")]["spec"]["containers"][0][
        "command"
    ]
    assert "--node_num" in cmd and "2" in cmd
    assert cmd[:3] == ["python", "-m", "dlrover_tpu_torch.master.main"]
    rec.reconcile_once(jobs)
    assert api.create_calls == 1

    def run(rec_mod, k8s_mod):
        api = k8s_mod.MockK8sApi()
        r = rec_mod.ElasticJobReconciler(
            k8s_mod.K8sClient(namespace="test", api=api))
        out = [r.reconcile_once({"j1": _job_cr()}) for _ in range(2)]
        return out, _neutral(api.pods), api.create_calls

    both = _both(run)
    assert both["port"] == both["ref"]


def test_reconcile_tracks_phase():
    def run(rec_mod, k8s_mod):
        api = k8s_mod.MockK8sApi()
        rec = rec_mod.ElasticJobReconciler(
            k8s_mod.K8sClient(namespace="test", api=api))
        jobs = {"j2": _job_cr("j2")}
        seen = [rec.reconcile_once(jobs)]
        api.set_pod_phase(rec_mod.master_pod_name("j2"), "Running")
        seen.append(rec.reconcile_once(jobs))
        status = dict(jobs["j2"]["status"])
        api.set_pod_phase(rec_mod.master_pod_name("j2"), "Succeeded")
        seen.append(rec.reconcile_once(jobs))
        return seen, status

    both = _both(run)
    seen, status = both["port"]
    assert [s["j2"] for s in seen] == [
        JobPhase.PENDING, JobPhase.RUNNING, JobPhase.SUCCEEDED]
    assert status["phase"] == JobPhase.RUNNING
    assert both["port"] == both["ref"]


def test_crd_manifests_parse():
    yaml = pytest.importorskip("yaml")
    for fname in ("elasticjob.yaml", "scaleplan.yaml"):
        with open(os.path.join(CRD_DIR, fname)) as f:
            text = f.read()
        with open(os.path.join(J_CRD_DIR, fname)) as f:
            assert text == f.read()
        doc = yaml.safe_load(text)
        assert doc["kind"] == "CustomResourceDefinition"
        assert doc["spec"]["group"] == "elastic.dlrover-tpu.org"
    with open(os.path.join(CRD_DIR, "elasticjob.yaml")) as f:
        text = f.read()
    for fieldname in (
        "distributionStrategy", "enableElasticScheduling",
        "enableDynamicSharding", "replicaSpecs", "restartCount",
    ):
        assert fieldname in text


def test_reconciler_gc_deletes_orphaned_pods():
    def run(rec_mod, k8s_mod):
        api = k8s_mod.MockK8sApi()
        rec = rec_mod.ElasticJobReconciler(
            k8s_mod.K8sClient(namespace="t", api=api))
        jobs = {
            "j1": {"spec": {}, "metadata": {"uid": "uid-1"}},
            "j2": {"spec": {}, "metadata": {"uid": "uid-2"}},
        }
        rec.reconcile_once(jobs)
        before = _neutral(api.pods)
        rec.reconcile_once({"j1": jobs["j1"]})
        return before, list(api.pods)

    both = _both(run)
    before, after = both["port"]
    assert len(before) == 2
    ref = before["elasticjob-j1-master"]["metadata"]["ownerReferences"][0]
    assert ref["kind"] == "ElasticJob" and ref["uid"] == "uid-1"
    assert after == ["elasticjob-j1-master"]
    assert both["port"] == both["ref"]


def test_watch_driven_reconcile_recreates_master_promptly():
    """run_watch reacts to pod events: a dead master pod is recreated
    well within the (long) resync interval — event-driven, not
    polling."""
    api = MockK8sApi()
    client = K8sClient(namespace="test", api=api)
    rec = ElasticJobReconciler(client)
    jobs = {
        "wjob": {
            "metadata": {"name": "wjob", "uid": "u1"},
            "spec": {"replicaSpecs": {"worker": {"replicas": 2}}},
        }
    }
    stop = threading.Event()
    t = threading.Thread(
        target=rec.run_watch,
        args=(lambda: jobs, stop),
        kwargs={"resync_interval": 30.0},
        daemon=True,
    )
    t.start()
    try:
        deadline = time.time() + 5
        name = master_pod_name("wjob")
        while time.time() < deadline and name not in api.pods:
            time.sleep(0.05)
        assert name in api.pods
        api.delete_pod("test", name)
        deadline = time.time() + 5
        while time.time() < deadline and name not in api.pods:
            time.sleep(0.05)
        assert name in api.pods, "master pod not recreated by event"
        assert api.create_calls == 2
    finally:
        stop.set()
        t.join(timeout=3)


def test_scaleplan_operator_roundtrip():
    """ElasticJobScaler writes a ScalePlan CR -> the operator-side
    ScalePlanReconciler executes it into pod creates/removes and marks
    the CR Succeeded; re-reconciling is a no-op."""
    from dlrover_tpu.common.node import new_worker as j_worker
    from dlrover_tpu.master.scaler import ElasticJobScaler as JScaler
    from dlrover_tpu.master.scaler import ScalePlan as JPlan
    from dlrover_tpu_torch.common.node import new_worker
    from dlrover_tpu_torch.master.scaler import ElasticJobScaler, ScalePlan

    mods = {"port": (ElasticJobScaler, ScalePlan, new_worker),
            "ref": (JScaler, JPlan, j_worker)}

    def run(name):
        rec_mod, k8s_mod = PACKAGES[name]
        scaler_cls, plan_cls, worker = mods[name]
        api = k8s_mod.MockK8sApi()
        client = k8s_mod.K8sClient(namespace="test", api=api)
        scaler = scaler_cls("tj", client)
        scaler.scale(plan_cls(
            launch_nodes=[worker(0, rank=0), worker(1, rank=1)]))
        rec = rec_mod.ScalePlanReconciler(client)
        seen = [rec.reconcile_once(), len(api.pods)]
        pods = _neutral(api.pods)
        seen += [rec.reconcile_once(), api.create_calls]
        scaler.scale(plan_cls(remove_nodes=[worker(1, rank=1)]))
        seen += [rec.reconcile_once(), sorted(api.pods)]
        return seen, pods

    got, want = run("port"), run("ref")
    seen, pods = got
    assert seen == [1, 2, 0, 2, 1, ["tj-worker-0"]]
    assert pods["tj-worker-0"]["metadata"]["labels"]["node-id"] == "0"
    assert got == want


def test_scaleplan_watcher_skips_master_origin_plans():
    """Plans the master wrote for the operator (origin=master) must not
    be looped back into the job manager, and both consumers share the
    terminal-phase vocabulary (no ping-pong) — as in the reference."""
    from dlrover_tpu.common.node import new_worker as j_worker
    from dlrover_tpu.master import scaler as j_scaler
    from dlrover_tpu.master.watcher import ScalePlanWatcher as JWatcher
    from dlrover_tpu_torch.common.node import new_worker
    from dlrover_tpu_torch.master import scaler as p_scaler
    from dlrover_tpu_torch.master.watcher import ScalePlanWatcher

    class Boom:
        def all_nodes(self):
            raise AssertionError("watcher must not execute this plan")

        adjust_worker_count = all_nodes

    def run(rec_mod, k8s_mod, scaler_mod, watcher_cls, worker):
        api = k8s_mod.MockK8sApi()
        client = k8s_mod.K8sClient(namespace="test", api=api)
        scaler_mod.ElasticJobScaler("tj", client).scale(
            scaler_mod.ScalePlan(launch_nodes=[worker(0, rank=0)]))
        watcher = watcher_cls("tj", client, Boom())
        rec = rec_mod.ScalePlanReconciler(client)
        return [watcher.reconcile_once(), rec.reconcile_once(),
                rec.reconcile_once(), watcher.reconcile_once()]

    got = run(p_rec, p_k8s, p_scaler, ScalePlanWatcher, new_worker)
    # the watcher skips it, the operator executes it once, and it stays
    # terminal for both
    assert got == [0, 1, 0, 0]
    assert got == run(j_rec, j_k8s, j_scaler, JWatcher, j_worker)
