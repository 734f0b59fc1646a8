"""Twins of ``tests/test_coworker.py`` for the port's coworker data
plane: a data-host process builds batches and streams them over the
port's comm layer into trainer-side loaders, which place them on the
device they are given (``"cpu"`` here).  Held against the JAX package:
the port's loader reads the same batches, byte for byte, from the JAX
package's service as from the port's (the frames are the same
pickles of numpy arrays).  Every check is exact."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.trainer.coworker import (
    CoworkerDataLoader,
    CoworkerDataService,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATA_HOST_SCRIPT = r'''
import sys, time
import numpy as np
sys.path.insert(0, %(repo)r)
from dlrover_tpu_torch.trainer.coworker import CoworkerDataService

def read_sample(i):
    rng = np.random.default_rng(i)
    return {"x": rng.standard_normal(8).astype(np.float32),
            "y": np.int32(i)}

svc = CoworkerDataService(
    read_fn=read_sample, batch_size=4, index_iter=range(32),
    num_workers=2, port=0, host="127.0.0.1",
).start()
print(f"PORT {svc.port}", flush=True)
while True:
    time.sleep(0.5)
'''


def _expected_x(i):
    return np.random.default_rng(i).standard_normal(8).astype(np.float32)


def _read(i):
    rng = np.random.default_rng(i)
    return {"x": rng.standard_normal(8).astype(np.float32),
            "tokens": rng.integers(0, 50257, 17).astype(np.int32),
            "y": np.int32(i)}


def test_coworker_two_process_e2e():
    """Real data-host process, real TCP: every sample arrives exactly
    once with correct content, as tensors on the loader's device;
    input-wait accounting works."""
    proc = subprocess.Popen(
        [sys.executable, "-c", DATA_HOST_SCRIPT % {"repo": REPO}],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=REPO,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("PORT"), line
        port = int(line.split()[1])
        loader = CoworkerDataLoader(f"127.0.0.1:{port}", device="cpu")
        seen = {}
        for batch in loader:
            assert set(batch) == {"x", "y"}
            assert isinstance(batch["x"], torch.Tensor)
            for row in range(batch["y"].shape[0]):
                i = int(batch["y"][row])
                assert i not in seen, "duplicate sample"
                seen[i] = batch["x"][row].numpy().copy()
        assert sorted(seen) == list(range(32))
        for i, x in seen.items():
            np.testing.assert_array_equal(x, _expected_x(i))
        stats = loader.stats()
        assert stats["batches"] == 8
        assert stats["input_wait_s"] >= 0.0
    finally:
        proc.kill()
        proc.wait()


def test_coworker_dynamic_sharding_two_consumers():
    """One service, two consumers: batches are disjoint and together
    cover the dataset exactly once."""
    svc = CoworkerDataService(
        read_fn=lambda i: {"y": np.int32(i)}, batch_size=2,
        index_iter=range(20), num_workers=2, host="127.0.0.1",
    ).start()
    try:
        addr = f"127.0.0.1:{svc.port}"
        a = CoworkerDataLoader(addr, node_id=0, device="cpu")
        b = CoworkerDataLoader(addr, node_id=1, device="cpu")
        got_a, got_b = [], []
        it_a, it_b = iter(a), iter(b)
        done_a = done_b = False
        while not (done_a and done_b):
            if not done_a:
                try:
                    got_a.extend(int(v) for v in next(it_a)["y"])
                except StopIteration:
                    done_a = True
            if not done_b:
                try:
                    got_b.extend(int(v) for v in next(it_b)["y"])
                except StopIteration:
                    done_b = True
        assert not (set(got_a) & set(got_b))
        assert sorted(got_a + got_b) == list(range(20))
        assert svc.stats()["served"] == 10
    finally:
        svc.stop()


def test_coworker_input_bound_fraction_with_train_loop():
    """With service-side prefetch, a consumer that does real work
    between batches waits a SMALL fraction of wall time on input."""
    svc = CoworkerDataService(
        read_fn=lambda i: {"x": np.full((64, 64), float(i), np.float32)},
        batch_size=4, index_iter=range(40), num_workers=2,
        queue_depth=8, host="127.0.0.1",
    ).start()
    try:
        loader = CoworkerDataLoader(f"127.0.0.1:{svc.port}", device="cpu")
        t0 = time.perf_counter()
        n = 0
        for _batch in loader:
            time.sleep(0.02)  # stand-in for the device step
            n += 1
        wall = time.perf_counter() - t0
        frac = loader.stats()["input_wait_s"] / wall
        assert n == 10
        assert frac < 0.5, frac
    finally:
        svc.stop()


def test_coworker_service_error_surfaces():
    def bad_read(i):
        raise IOError("disk on fire")

    svc = CoworkerDataService(
        read_fn=bad_read, batch_size=2, index_iter=range(4),
        host="127.0.0.1",
    ).start()
    try:
        loader = CoworkerDataLoader(f"127.0.0.1:{svc.port}", device="cpu")
        with pytest.raises(RuntimeError, match="disk on fire"):
            list(loader)
    finally:
        svc.stop()


def test_coworker_request_before_start_waits_for_batches():
    """A next_batch landing before start() (the socket exists from
    __init__) must wait for the workers, not answer end-of-data."""
    svc = CoworkerDataService(
        read_fn=lambda i: np.full(4, i, np.float32),
        batch_size=2, index_iter=range(4), host="127.0.0.1",
    )
    got = {}

    def early_request():
        got["item"] = svc.get(0, "consumer", "next_batch")

    t = threading.Thread(target=early_request, daemon=True)
    t.start()
    time.sleep(0.3)  # the request is in flight against an un-started service
    assert "item" not in got
    svc.start()
    try:
        t.join(timeout=10)
        assert got["item"][0] == "batch", got["item"]
    finally:
        svc.stop()


def test_coworker_error_latched_for_every_consumer():
    """One failed batch build poisons the stream for ALL consumers."""
    def bad_read(i):
        raise IOError("disk on fire")

    svc = CoworkerDataService(
        read_fn=bad_read, batch_size=2, index_iter=range(8),
        num_workers=2, host="127.0.0.1",
    ).start()
    try:
        deadline = time.time() + 10
        answers = []
        while len(answers) < 3 and time.time() < deadline:
            item = svc.get(len(answers), "consumer", "next_batch")
            if item[0] == "error":
                answers.append(item)
        assert len(answers) == 3
        for item in answers:
            assert "disk on fire" in item[1]
    finally:
        svc.stop()


def test_port_loader_reads_the_jax_service_byte_for_byte():
    """One worker a service so batches come in index order: the JAX
    package's service and the port's give the port's loader the same
    batches, byte for byte."""
    from dlrover_tpu.trainer.coworker import (
        CoworkerDataService as JaxService,
    )

    streams = []
    for cls in (JaxService, CoworkerDataService):
        svc = cls(read_fn=_read, batch_size=4, index_iter=range(24),
                  num_workers=1, host="127.0.0.1").start()
        try:
            loader = CoworkerDataLoader(f"127.0.0.1:{svc.port}",
                                        device="cpu")
            streams.append([{k: v.numpy() for k, v in b.items()}
                            for b in loader])
        finally:
            svc.stop()
    want, got = streams
    assert len(got) == len(want) == 6
    for w, g in zip(want, got):
        assert set(w) == set(g) == {"x", "tokens", "y"}
        for k in w:
            assert w[k].dtype == g[k].dtype and w[k].shape == g[k].shape
            assert w[k].tobytes() == g[k].tobytes()
    assert [int(v) for b in got for v in b["y"]] == list(range(24))


def test_coworker_loader_refuses_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CoworkerDataLoader("127.0.0.1:1")
