"""Twin of ``tests/test_sync_tuning.py`` for the port: the sync
service, elastic PS versioning, the strategy generator and the
auto-tuning loop (master ``ParallelConfig`` -> the agent's
``ParalConfigTuner`` file -> the trainer's read, and the loader's batch
size set from it between steps).  The tuner's file is also held
against the JAX package's: the same config from each package's master
gives the same JSON, key for key.  Every check is exact."""

import json
import threading

import numpy as np

from dlrover_tpu_torch.agent.config_tuner import (
    ParalConfigTuner,
    read_parallel_config,
)
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.messages import (
    ModelInfo,
    NodeResourceStats,
    ParallelConfig,
)
from dlrover_tpu_torch.master.hyperparams import SimpleStrategyGenerator
from dlrover_tpu_torch.master.master import JobMaster
from dlrover_tpu_torch.master.sync_service import ElasticPsService, SyncService


def test_sync_service_barrier():
    svc = SyncService()
    world = {0, 1}
    results = {}

    def worker(nid):
        results[nid] = svc.barrier("phase1", nid, world, timeout=10)

    threads = [threading.Thread(target=worker, args=(i,)) for i in world]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == {0: True, 1: True}


def test_sync_service_dead_node_removed():
    svc = SyncService()
    world = {0, 1}
    svc.join_sync("p", 0, world)
    svc.remove_node(0)
    assert not svc.join_sync("p", 1, world)  # 0 gone, not complete


def test_elastic_ps_versioning():
    svc = ElasticPsService()
    assert svc.version == 0
    assert svc.bump_version() == 1
    assert not svc.report_ready(0, 0)  # stale version rejected
    assert svc.report_ready(0, 1)
    assert svc.report_ready(1, 1)
    assert svc.all_ready({0, 1})
    svc.bump_version()
    assert not svc.all_ready({0, 1})  # readiness reset on resize


def test_strategy_generator_fills_global_batch():
    gen = SimpleStrategyGenerator(global_batch_size=512)
    cfg = gen.generate(
        {0: NodeResourceStats(cpu_percent=50.0)},
        ModelInfo(num_params=124_000_000),
        dp_size=4,
    )
    assert cfg.micro_batch_size >= 1
    assert cfg.micro_batch_size * 4 * cfg.gradient_accumulation <= 512
    assert cfg.version == 1
    cfg2 = gen.generate({}, ModelInfo(), dp_size=4)
    assert cfg2.version == 2


def _tuned_file(pkg, path):
    """The tuner file one package writes for the same tuned config."""
    if pkg == "jax":
        from dlrover_tpu.agent.config_tuner import ParalConfigTuner as T
        from dlrover_tpu.agent.master_client import MasterClient as MC
        from dlrover_tpu.common.messages import ParallelConfig as PC
        from dlrover_tpu.master.master import JobMaster as JM
    else:
        T, MC, PC, JM = (ParalConfigTuner, MasterClient, ParallelConfig,
                         JobMaster)
    master = JM(port=0, node_num=1, job_name=f"tune-{pkg}")
    master.prepare()
    client = MC(f"127.0.0.1:{master.port}", node_id=0, node_type="worker")
    try:
        # the master tunes the config (the report path stores it)
        client._client.report(PC(dataloader_workers=3, micro_batch_size=2,
                                 gradient_accumulation=2, version=7))
        tuner = T(path=path, client=client)
        tuner.poll_once()
        with open(path) as f:
            return f.read()
    finally:
        client.close()
        master.stop()


def test_auto_tuning_loop(tmp_path):
    """The tuned file, the same as the JAX package's; the trainer reads
    it and the elastic loader takes its micro-batch between steps."""
    from dlrover_tpu_torch.agent.sharding_client import IndexShardingClient
    from dlrover_tpu_torch.trainer.dataset import (
        ElasticDataLoader,
        ElasticDataset,
    )

    path = str(tmp_path / "paral.json")
    text = _tuned_file("torch", path)
    assert json.loads(text) == json.loads(
        _tuned_file("jax", str(tmp_path / "jax.json")))
    cfg = read_parallel_config(path)
    assert cfg["micro_batch_size"] == 2 and cfg["version"] == 7

    master = JobMaster(port=0, node_num=1, job_name="tune-loader")
    master.prepare()
    client = MasterClient(f"127.0.0.1:{master.port}", node_id=0,
                          node_type="worker")
    try:
        isc = IndexShardingClient(dataset_name="tuned", batch_size=4,
                                  num_epochs=1, dataset_size=16,
                                  master_client=client)
        loader = ElasticDataLoader(
            ElasticDataset("tuned", 16, 4, read_fn=lambda i: np.int64(i),
                           sharding_client=isc),
            device="cpu", prefetch=1)
        seen = []
        for step, batch in enumerate(loader):
            seen += batch.tolist()
            if step == 0:
                loader.set_batch_size(read_parallel_config(path)[
                    "micro_batch_size"])
        assert sorted(seen) == list(range(16))
        assert len(batch) == 2
        isc.stop()
    finally:
        client.close()
        master.stop()
