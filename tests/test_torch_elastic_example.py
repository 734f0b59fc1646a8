"""The port's twin of ``examples/train_gpt_elastic.py`` on the CPU.

``dlrover_tpu_torch/examples/train_gpt_elastic.py`` runs at ``--tiny``
width (the tiny GPT in fp32 under FSDP2, a global batch of 32) through
``python -m dlrover_tpu_torch.run``, as its docstring launches it:

- an uninterrupted control at ``--nproc_per_node=1``, whose losses are
  also held to the JAX example's loop at the same init, seed and batch
  (``optax.adamw(3e-4, weight_decay=0.1)``, fp32) at rtol 1e-4;
- at ``--nproc_per_node=1`` and ``2`` (gloo, FSDP2 over two ranks), a
  seeded SIGKILL of a worker at step 7, after a committed save: the
  agent restarts its whole local group, every rank restores params and
  AdamW moments of one step (step 6 from shm, or the last commit from
  storage where a snapshot of step 6 was mid-write) through
  ``load_checkpoint(target_state=...)``,
  and every reported loss equals the control's (rtol 1e-3, atol 1e-5,
  PERF.md §2's replay tolerance), with at least one step replayed.

Each launcher run has a timeout of its own.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from dlrover_tpu_torch.chaos import harness
from dlrover_tpu_torch.chaos.schedule import Scenario
from dlrover_tpu_torch.checkpoint.saver import read_last_checkpoint
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "dlrover_tpu_torch", "examples",
                       "train_gpt_elastic.py")
STEPS, SAVE_EVERY, KILL_AT = 8, 2, 7
RUN_TIMEOUT_S = 240

pytestmark = pytest.mark.chaos


@pytest.fixture(scope="module")
def root():
    """A short work root (a unix socket path holds at most 107 bytes);
    each run's shm segments are unlinked at the end."""
    path = tempfile.mkdtemp(prefix="dlex")
    yield path
    for name in os.listdir(path):
        sock = os.path.join(path, name, "sock")
        if os.path.isdir(sock):
            with harness._patched_env({"DLROVER_SHARED_DIR": sock}):
                for local_rank in range(2):
                    SharedMemoryHandler(local_rank).unlink()
    shutil.rmtree(path, ignore_errors=True)


def _run(root, name, nproc, kill):
    rules = []
    if kill:
        rule = {"name": "kill-after-save", "point": "trainer.step",
                "action": "kill", "at_step": KILL_AT,
                "only_first_incarnation": True}
        if nproc > 1:
            # one worker of the node dies; the agent restarts them all
            rule["env_equals"] = {"DLROVER_LOCAL_RANK": "1"}
        rules.append(rule)
    scenario = Scenario.from_dict({"name": f"example-{name}", "seed": 0,
                                   "rules": rules})
    workdir = os.path.join(root, name)
    env, event_log = harness.scenario_env(scenario, workdir, STEPS,
                                          SAVE_EVERY)
    env = {**os.environ, **env, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "DLROVER_JOB_NAME": f"dlex-{os.getpid()}-{name}"}
    ckpt = os.path.join(workdir, "ckpt")
    out = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.run",
         f"--nproc_per_node={nproc}", "--max_restarts=2",
         "--monitor_interval=0.3", EXAMPLE, "--tiny", "--device", "cpu",
         "--steps", str(STEPS), "--save-every", str(SAVE_EVERY),
         "--orbax-every", "2", "--ckpt-dir", ckpt],
        cwd=workdir, env=env, capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    assert out.returncode == 0, (out.stdout + out.stderr)[-6000:]
    report = harness._build_report(scenario, out.returncode, workdir,
                                   event_log)
    report.ckpt = ckpt
    return report


def _losses(report):
    by_step = {}
    for e in report.events:
        if e.get("type") == "train_step":
            by_step.setdefault(int(e["step"]), e["loss"])
    return [by_step[s] for s in range(1, STEPS + 1)]


@pytest.fixture(scope="module")
def control(root):
    return _run(root, "control", 1, kill=False)


def test_control_matches_the_jax_example_loop(control):
    """The example's loop in the JAX package, from the port's init,
    on the same draws of default_rng(0): the sample batch first, step k
    on draw k."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from dlrover_tpu.models import gpt as jax_gpt
    from dlrover_tpu.trainer import elastic_trainer as jax_et
    from dlrover_tpu_torch.examples import train_gpt_elastic as ex
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.utils.convert import params_to_jax

    cfg = GPTConfig.tiny(max_seq_len=ex.TINY_SEQ, dtype=torch.float32)
    params = params_to_jax(GPT(cfg, device="cpu", seed=0).state_dict())
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig.tiny(max_seq_len=ex.TINY_SEQ,
                                                dtype=jnp.float32))

    def loss_fn(p, batch):
        return jax_gpt.cross_entropy_loss(
            jmodel.apply({"params": p}, batch["x"]), batch["y"])

    optimizer = optax.adamw(3e-4, weight_decay=0.1)
    step = jax_et.make_train_step(loss_fn, optimizer)
    state = jax_et.TrainState.create(jax.tree.map(jnp.asarray, params),
                                     optimizer)
    data = ex.batches(cfg.vocab_size, ex.TINY_SEQ, np.random.default_rng(0))
    next(data)  # the sample batch
    want = []
    for _ in range(STEPS):
        state, metrics = step(state, jax.tree.map(jnp.asarray, next(data)))
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(_losses(control), want, rtol=1e-4)
    assert read_last_checkpoint(control.ckpt)[0] == STEPS


@pytest.mark.parametrize("nproc", [1, 2])
def test_example_recovers_from_a_sigkill_after_a_committed_save(
        root, control, nproc):
    report = _run(root, f"kill{nproc}", nproc, kill=True)
    checks = [
        harness.WorkerRestarted(),
        harness.RestoredFromTier("shm"),
        harness.FinalStepCommitted(),
        harness.LossTrajectoryMatches(_losses(control)),
    ]
    harness.check_invariants(report, checks)
    assert report.ok, report.summary()
    kills = [e for e in report.events
             if e.get("type") == harness.CHAOS_EVENT]
    assert len(kills) == 1 and kills[0]["step"] == KILL_AT
    commits = [e for e in report.events
               if e.get("type") == "checkpoint_commit"
               and e["ts"] < kills[0]["ts"]]
    assert commits, "no save was committed before the kill"
    restores = [e for e in report.events
                if e.get("type") == "checkpoint_restore"]
    # every rank of the respawned group restored one step, resharded
    # onto its DTensors through the target state: step 6 from shm, or,
    # when the kill caught a snapshot of it mid-write, the last commit
    # from storage
    assert len(restores) == nproc and all(e.get("sharded")
                                          for e in restores)
    assert len({(e["tier"], e["step"]) for e in restores}) == 1
    assert restores[0]["step"] in (KILL_AT - 3, KILL_AT - 1)
    restarts = [e for e in report.events
                if e.get("type") == "worker_restart"]
    assert len(restarts) == 1
    assert read_last_checkpoint(report.ckpt)[0] == STEPS
    # the orbax tier took every 2nd storage save (the 1st, the 3rd, ...)
    assert any(name.startswith("step_")
               for name in os.listdir(report.ckpt + "_durable"))
