"""Spawn a test file's ``--worker`` on gloo ranks of this machine.

Shared by the port's tests that run a process group of their own: each
rank runs ``python <file> --worker RANK WORLD PORT IN OUT`` (gloo over
``tcp://127.0.0.1:PORT``), reads its job from the pickle ``IN``, and
rank 0 pickles its results into ``OUT``.
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job, worker_file: str, world: int = 4, timeout: float = 300):
    """Run ``worker_file --worker`` on ``world`` gloo ranks with ``job``
    and return rank 0's pickled results."""
    tmp = tempfile.mkdtemp(prefix="gloo_")
    in_path, out_path = (os.path.join(tmp, n) for n in ("in.pkl", "out.pkl"))
    with open(in_path, "wb") as f:
        pickle.dump(job, f)
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1",
           "DLROVER_LOG_LEVEL": "ERROR"}
    procs = [subprocess.Popen(
        [sys.executable, worker_file, "--worker", str(rank), str(world),
         str(port), in_path, out_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)
