"""Elastic GPT-2 pretraining with flash checkpoints, under FSDP2.

Reference: ``examples/train_gpt_elastic.py``, the JAX package's recipe
over ``dlrover_tpu/accel/accelerate.py`` and
``dlrover_tpu/checkpoint/checkpointer.py``, step for step: form the
process group from the agent's env, build GPT-2 small with flash
attention, ``auto_accelerate`` it under ``fsdp`` + ``amp_native`` +
``checkpoint`` (and ``module_replace``, which keeps the flash attention
that a plan's default would replace) with AdamW(3e-4, weight decay
0.1), restore
``{"params", "opt_state"}`` and the step counter through the
target-state restore (onto this run's DTensors, resharded if the world
changed), and save to storage every 10 steps with an orbax-tier copy
every 10th of those saves.

Launch (one node, every GPU):

    python -m dlrover_tpu_torch.run --nproc_per_node=auto --max_restarts=3 \\
        dlrover_tpu_torch/examples/train_gpt_elastic.py

Multi-node: run the same command on every node with
``DLROVER_MASTER_ADDR`` pointing at node 0's master.  One process is
one GPU (``cuda:LOCAL_RANK``); a world of one forms a one-rank group,
so the fsdp plan runs FSDP2 at every size.

Where the reference draws each batch from one random stream and labels
a save with the loop index, here the batch of step k is the k-th draw
after the sample batch (a restored run skips the draws of the steps it
restored) and a save carries the count of steps taken, so a restored
run replays an uninterrupted run's losses exactly; the last step is
saved and committed before the process exits.  ``--tiny`` (a tiny
GPT in fp32), ``--steps``, ``--save-every``, ``--orbax-every``,
``--ckpt-dir``, ``--device`` and ``--record`` are for tests and the
chip check; the defaults are the reference's.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from dlrover_tpu_torch.accel import Strategy, auto_accelerate
from dlrover_tpu_torch.checkpoint.checkpointer import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer,
    init_torch_distributed,
)
from dlrover_tpu_torch.utils.convert import (
    adamw_state_from_tree,
    adamw_state_tree,
    params_tree,
)

SEQ, GLOBAL_BATCH, STEPS = 1024, 32, 1000
TINY_SEQ = 32


def batches(vocab, seq, rng):
    while True:
        data = rng.integers(0, vocab, (GLOBAL_BATCH, seq + 1),
                            dtype=np.int32)
        yield {"x": data[:, :-1], "y": data[:, 1:]}


def loss_fn(module, batch):
    return cross_entropy_loss(module(batch["x"]), batch["y"])


def optimizer(params):
    # optax.adamw(3e-4, weight_decay=0.1): b1 0.9, b2 0.999, eps 1e-8
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.1)


def init_group(device):
    """The agent's process group, or a one-rank one for a single
    process (nccl on the card, gloo on the CPU)."""
    import torch.distributed as dist

    from dlrover_tpu_torch.common.comm import find_free_port

    if init_torch_distributed(device=device):
        return
    backend = "gloo" if device == "cpu" else "nccl"
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{find_free_port()}",
        rank=0, world_size=1)


def strategy(tiny: bool) -> Strategy:
    """fsdp + bf16 + remat, as the reference's; ``module_replace`` keeps
    the config's flash attention, which a plan (the reference's too)
    would otherwise reset to its default, "xla"."""
    amp = {"dtype": "float32"} if tiny else {}
    return Strategy(opts=[("fsdp", {}), ("amp_native", amp),
                          ("checkpoint", {}),
                          ("module_replace", {"attention": "flash"})])


def state_tree(result):
    return {"params": params_tree(result.model),
            "opt_state": adamw_state_tree(result.state.optimizer,
                                          result.model)}


def committed_step(ckpt_dir: str) -> int:
    tracker = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")
    try:
        with open(tracker) as f:
            return int(f.read().strip() or -1)
    except (OSError, ValueError):
        return -1


class Record:
    """``--record DIR``: ``incarnation_<restart>_rank<r>.json``, rewritten
    after every step, with the step's loss and seconds, the flash
    kernels' launches during it, the restore's tier and phases and each
    save's phases."""

    def __init__(self, out_dir: str):
        from dlrover_tpu_torch.ops import flash_attention as fa

        self._fa = fa
        restart = os.environ.get("DLROVER_RESTART_COUNT", "0") or "0"
        rank = os.environ.get("DLROVER_RANK", "0") or "0"
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir,
                                 f"incarnation_{restart}_rank{rank}.json")
        self.data = {"restart": int(restart), "rank": int(rank),
                     "steps": [], "restore": {}, "saves": []}

    def restore(self, start, phases):
        self.data["restore"] = {"step": start, **phases}
        self._write()

    def begin_step(self):
        self._fa.reset_launch_counts()
        self._t0 = time.perf_counter()

    def end_step(self, step, loss, device):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.data["steps"].append({
            "step": step, "loss": loss,
            "seconds": time.perf_counter() - self._t0,
            "launches": dict(self._fa.LAUNCHES)})
        self._write()

    def save(self, step, ok, t, engine):
        """A save issued at ``t`` (skipped when not ``ok``: the previous
        snapshot was still writing): its host stall now; its card time
        and shm write phases once the writer is done (:meth:`complete`,
        called before the next save and at the end)."""
        entry = {"step": step, "ok": ok, "t": t}
        if ok:
            entry.update(engine.last_snapshot_phases)
        self.data["saves"].append(entry)
        self._write()

    def complete(self, engine):
        """Fill in the last written save's card time and shm phases, once
        the writer is idle (else at a later call)."""
        done = [sv for sv in self.data["saves"] if sv["ok"]]
        if (done and "write" not in done[-1]
                and engine.wait_async(timeout=0)):
            done[-1]["device_s"] = engine.last_snapshot_phases.get(
                "device_s")
            done[-1]["write"] = dict(engine.last_save_phases)

    def _write(self):
        with open(self.path + ".tmp", "w") as f:
            json.dump(self.data, f)
        os.replace(self.path + ".tmp", self.path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--orbax-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="/tmp/gpt_ckpt")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the GPU)")
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny GPT in fp32 (tests)")
    ap.add_argument("--record", default=None,
                    help="directory for a JSON record of each incarnation")
    args = ap.parse_args(argv)

    init_group(args.device)
    if args.tiny:
        cfg = GPTConfig.tiny(max_seq_len=TINY_SEQ, attention_impl="flash",
                             dtype=torch.float32)
        seq = TINY_SEQ
    else:
        cfg = GPTConfig.gpt2_small(max_seq_len=SEQ, attention_impl="flash")
        seq = SEQ
    model = GPT(cfg, device=args.device, seed=0)

    rng = np.random.default_rng(0)
    data = batches(cfg.vocab_size, seq, rng)
    sample = next(data)

    # semi-auto: fsdp + bf16 + remat; drop strategy= for the full
    # search (plans over the process group's ranks, ranked by dry runs)
    result = auto_accelerate(model, optimizer, loss_fn, sample,
                             strategy=strategy(args.tiny),
                             device=args.device)
    device = resolve_device(args.device)

    trainer = ElasticTrainer(
        global_batch_size=GLOBAL_BATCH, micro_batch_size=GLOBAL_BATCH,
        dp_size=max(1, result.mesh.shape["data"]),
    )
    # every rank persists its own shard of the DTensor state
    ckpt = Checkpointer(args.ckpt_dir, replicated=False,
                        orbax_dir=args.ckpt_dir + "_durable",
                        orbax_every=args.orbax_every)
    record = Record(args.record) if args.record else None
    # target-state restore: every leaf comes back in place on this
    # run's DTensors, resharded if the world size changed
    state = result.state
    start, restored = ckpt.load_checkpoint(target_state=state_tree(result))
    if start is not None:
        adamw_state_from_tree(restored["opt_state"], state.optimizer,
                              result.model)
        state.step = start
        trainer.global_step = start
        for _ in range(start):
            next(data)
    if record:
        record.restore(start, ckpt.last_restore_phases if start else {})

    for _ in range(trainer.global_step, args.steps):
        if record:
            record.begin_step()
        state, metrics = result.train_step(
            state, result.place_batch(next(data)))
        loss = float(metrics["loss"])
        if record:
            record.end_step(trainer.global_step + 1, loss, device)
        trainer.report_step(metrics)
        if trainer.global_step % args.save_every == 0:
            if record:
                record.complete(ckpt.engine)
            t = time.time()
            # the stall: one on-card copy of the local shards; the
            # device->host copy and the persist run in the background
            ok = ckpt.save_checkpoint(trainer.global_step,
                                      state_tree(result),
                                      storage_type=StorageType.DISK)
            if record:
                record.save(trainer.global_step, ok, t, ckpt.engine)
    ckpt.wait()
    if record:
        record.complete(ckpt.engine)
    # the job's last step is durable once node 0's saver has committed
    # it: the lead rank saves it again until the commit lands (a persist
    # round can be lost to a restart of the agent's saver), the others
    # persist their shards once more
    final = trainer.global_step
    if int(os.environ.get("DLROVER_RANK", "0") or 0) == 0:
        deadline = time.time() + 120
        while committed_step(args.ckpt_dir) < final:
            if time.time() > deadline:
                raise RuntimeError(f"step {final} was not committed")
            ckpt.save_checkpoint(final, state_tree(result),
                                 storage_type=StorageType.DISK)
            ckpt.wait()
            poll_end = time.time() + 10
            while (time.time() < poll_end
                   and committed_step(args.ckpt_dir) < final):
                time.sleep(0.1)
    elif final % args.save_every:
        ckpt.save_checkpoint(final, state_tree(result),
                             storage_type=StorageType.DISK)
        ckpt.wait()
    ckpt.close()
    if record:
        record.data["done"] = trainer.global_step
        record._write()


if __name__ == "__main__":
    main()
