"""High-throughput input: cross-process shm dataloader + warm restarts.

Reference: ``examples/train_with_shm_loader.py``, the JAX package's
recipe over ``dlrover_tpu/trainer/shm_loader.py``: GPT-2 small with
flash attention, seq 1024, batch 16, AdamW(3e-4, weight decay 0.1), two
shm workers that read and collate ``read_sample(i)`` into shared memory
while the card trains, and 200 steps.  Here each batch reaches the card
as a copy out of its page-locked shm slot on a side stream
(:class:`~dlrover_tpu_torch.trainer.shm_loader.ShmDataLoader`).

Launch with warm-fork restarts (a killed trainer is re-forked from a
pre-imported template, so a respawn skips the interpreter and the
torch import):

    python -m dlrover_tpu_torch.run --nproc_per_node=1 --max_restarts=10 \\
        --warm-restart dlrover_tpu_torch/examples/train_with_shm_loader.py

Smoke test on the CPU:
``python -m dlrover_tpu_torch.examples.train_with_shm_loader --smoke``.

Options the reference lacks, for tests and the chip check:
``--loader plain`` feeds the same indices through
:class:`~dlrover_tpu_torch.trainer.dataset.ElasticDataLoader` over the
master's dynamic sharding (no worker processes); ``--loader sharded``
feeds the shm loader from the master's sharding
(:class:`~dlrover_tpu_torch.agent.sharding_client.IndexShardingClient`)
and, with ``--ckpt-dir``, saves the whole train state and the dataset
position to the flash checkpoint's shm tier every ``--save-every``
steps.  A sharded run acks its shards to the master at each save, just
before the position is taken, so a killed worker restored from its last
save re-reads exactly the shards it had not saved: no sample is trained
twice into the saved state and none is skipped.  ``--steps``,
``--device`` and ``--record`` (a JSON record of each incarnation: each
step's loss, seconds, input wait and flash launches) are the others.
The batch of a step is a pure function of its sample indices, so every
loader gives the same losses.
"""

import argparse
import functools
import itertools
import json
import os
import time

import numpy as np
import torch

from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer,
    TrainState,
    init_torch_distributed,
    make_train_step,
    restore_train_state,
    train_state_tree,
)

SEQ, BATCH, STEPS = 1024, 16, 200
DATASET = "shm-example"


def read_sample(i: int, vocab: int = 50257, seq: int = SEQ):
    """Per-index sample read — in production this opens your corpus
    shard; must be picklable (spawned workers re-import this module)."""
    rng = np.random.default_rng(i)
    return rng.integers(0, vocab, seq + 1).astype(np.int32)


def loss_fn(module, batch):
    tokens = batch["tokens"]
    return cross_entropy_loss(module(tokens[:, :-1]), tokens[:, 1:])


def committed_step(ckpt_dir: str) -> int:
    tracker = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")
    try:
        with open(tracker) as f:
            return int(f.read().strip() or -1)
    except (OSError, ValueError):
        return -1


class Record:
    """``--record DIR``: ``incarnation_<restart>.json``, rewritten after
    every step."""

    def __init__(self, out_dir: str, loader: str, prof):
        from dlrover_tpu_torch.ops import flash_attention as fa

        self._fa = fa
        self._prof = prof
        restart = int(os.environ.get("DLROVER_RESTART_COUNT", "0") or 0)
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"incarnation_{restart}.json")
        self.data = {"restart_count": restart, "pid": os.getpid(),
                     "loader": loader, "start_step": 0, "restore": {},
                     "steps": [], "done": False}

    def begin_step(self):
        self._fa.reset_launch_counts()

    def end_step(self, step, loss, wait_s, seconds):
        self.data["steps"].append({
            "step": step, "loss": loss, "wait_s": wait_s,
            "seconds": seconds, "launches": dict(self._fa.LAUNCHES)})
        self.write()

    def write(self):
        self.data["phases"] = dict(self._prof.phases)
        with open(self.path + ".tmp", "w") as f:
            json.dump(self.data, f)
        os.replace(self.path + ".tmp", self.path)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    from dlrover_tpu_torch.trainer.recovery import RecoveryProfiler

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny GPT, seq 128, batch 4, 5 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--loader", choices=("shm", "plain", "sharded"),
                    default="shm")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the GPU)")
    ap.add_argument("--record", default=None)
    args = ap.parse_args(argv)
    if args.ckpt_dir and args.loader != "sharded":
        raise SystemExit("--ckpt-dir saves the dataset position of "
                         "--loader sharded only")

    prof = RecoveryProfiler()
    # a world of one needs no process group
    init_torch_distributed(device=args.device)
    seq, batch, steps = (128, 4, 5) if args.smoke else (SEQ, BATCH, STEPS)
    steps = args.steps or steps
    with prof.phase("model_build"):
        cfg = (
            GPTConfig.tiny(max_seq_len=seq) if args.smoke
            else GPTConfig.gpt2_small(max_seq_len=seq,
                                      attention_impl="flash")
        )
        model = GPT(cfg, device=args.device, seed=0)
        device = next(model.parameters()).device
        # optax.adamw(3e-4, weight_decay=0.1): b1 0.9, b2 0.999, eps 1e-8
        optimizer = torch.optim.AdamW(
            model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=0.1)
        step_fn = make_train_step(loss_fn, optimizer, device=device)
        state = TrainState.create(model, optimizer)
    trainer = ElasticTrainer(global_batch_size=batch,
                             micro_batch_size=batch, dp_size=1)
    record = Record(args.record, args.loader, prof) if args.record else None

    ckpt, start, position = None, 0, ""
    if args.ckpt_dir:
        from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer

        with prof.phase("ckpt_init"):
            ckpt = Checkpointer(args.ckpt_dir)
        step0, restored = ckpt.load_checkpoint()
        prof.record_restore(ckpt.last_restore_phases)
        if step0 is not None:
            with prof.phase("state_build"):
                restore_train_state(state, restored["state"])
                _sync(device)
            start, position = int(step0), restored["dataset"]
    trainer.global_step = start
    if record:
        record.data.update(start_step=start,
                           restore=ckpt.last_restore_phases if start else {})

    read_fn = functools.partial(read_sample, vocab=cfg.vocab_size, seq=seq)
    isc = None
    if args.loader in ("plain", "sharded"):
        from dlrover_tpu_torch.agent.master_client import MasterClient
        from dlrover_tpu_torch.agent.sharding_client import (
            IndexShardingClient,
        )

        if position:
            # back to the saved position BEFORE the prefetch starts
            MasterClient.singleton().restore_dataset_checkpoint(
                DATASET, position)
        isc = IndexShardingClient(
            dataset_name=DATASET, batch_size=batch, num_epochs=1,
            dataset_size=batch * steps, shuffle=False,
            num_minibatches_per_shard=1)
    if args.loader == "plain":
        from dlrover_tpu_torch.trainer.dataset import (
            ElasticDataLoader,
            ElasticDataset,
        )

        loader = ElasticDataLoader(
            ElasticDataset(DATASET, batch * steps, batch, read_fn=read_fn,
                           sharding_client=isc),
            device=device)
    else:
        from dlrover_tpu_torch.trainer.shm_loader import ShmDataLoader

        if isc is None:
            indices = range(batch * start, batch * steps)
        else:
            # the master's index stream, cut where this run's steps end
            # (a WAIT for un-acked shards must not block the last batch)
            indices = itertools.islice(
                iter(isc.fetch_sample_index, None),
                batch * (steps - start))
        loader = ShmDataLoader(read_fn=read_fn, batch_size=batch,
                               index_iter=indices, num_workers=2,
                               device=device)

    def save(storage_type):
        # the shards of the saved steps are done: ack them, then take
        # the position the master will hand back after a restore
        if trainer.global_step > acked[0]:
            isc.report_batch_done(batch * (trainer.global_step - acked[0]))
            acked[0] = trainer.global_step
        ckpt.save_checkpoint(
            trainer.global_step,
            {"state": train_state_tree(state),
             "trainer": trainer.state_dict(),
             "dataset": isc.get_checkpoint()},
            storage_type=storage_type)

    acked = [start]
    it = iter(loader)
    first = True
    try:
        while trainer.global_step < steps:
            if record:
                record.begin_step()
            t0 = time.perf_counter()
            try:
                host_batch = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter()
            state, metrics = step_fn(state, {"tokens": host_batch})
            loss = float(metrics["loss"])
            t2 = time.perf_counter()
            if first:
                first = False
                prof.record_first_step()
            if record:
                record.end_step(trainer.global_step + 1, loss, t1 - t0,
                                t2 - t0)
            # the train_step event and the trainer.step chaos hook: a
            # kill rule ends the process here
            trainer.report_step(metrics)
            if (trainer.global_step % 20 == 0 or args.smoke) and not record:
                print(f"step {trainer.global_step} loss {loss:.3f} "
                      f"input_wait {t1 - t0:.4f}s", flush=True)
            if ckpt and trainer.global_step % args.save_every == 0:
                from dlrover_tpu_torch.checkpoint.checkpointer import (
                    StorageType,
                )

                save(StorageType.MEMORY)
        if ckpt:
            _final_save(ckpt, save, args.ckpt_dir, trainer.global_step)
    finally:
        if args.loader != "plain":
            loader.shutdown()
        if isc is not None:
            isc.stop()
    stats = loader.stats() if args.loader != "plain" else {}
    if record:
        record.data.update(done=True, loader_stats=stats)
        record.write()
    print("done:", stats, flush=True)


def _final_save(ckpt, save, ckpt_dir: str, final: int):
    """The last step to storage, saved again until its commit lands (a
    persist round can be lost to a restart of the agent's saver)."""
    from dlrover_tpu_torch.checkpoint.checkpointer import StorageType

    deadline = time.time() + 300
    while committed_step(ckpt_dir) < final:
        if time.time() > deadline:
            raise RuntimeError(f"step {final} was not committed")
        save(StorageType.DISK)
        ckpt.wait()
        poll_end = time.time() + 30
        while time.time() < poll_end and committed_step(ckpt_dir) < final:
            time.sleep(0.05)
    ckpt.close()


if __name__ == "__main__":
    main()
