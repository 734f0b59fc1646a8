#!/usr/bin/env python3
"""Drive the PyTorch port (``dlrover_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the CUDA kernels of ``dlrover_tpu_torch/csrc`` with nvcc
   (one process per source, all started together); print each
   kernel's registers and spills, and the wgmma (HGMMA) and TMA
   (UTMALDG, UBLKCP) instructions in the SASS of the wgmma kernels;
2. hold each flash-attention kernel (fwd, bwd_dq, bwd_dkv) against its
   plain PyTorch version on the card, at the training shapes of GPT-2
   small (b=8, s=1024, h=12, d=64, bf16, causal), GPT-2 XL (b=4, h=25)
   and Llama-3-8B (b=1, s=8192, 32 q heads over 8 kv heads, d=128) and
   at small non-causal, GQA, ragged, head_dim-128, fp16 and fp32
   cases (bf16 and fp16 also by the norm of the error relative to the
   plain version's, which a V fault planted in two kv tiles past key
   4096 at Llama's shape must fail), and hold the bf16 and fp16 dK/dV
   kernels to fp32 p and dS and the dQ kernels to dS rounded to the
   input type (each closer
   to the plain version at the TPU kernel's rounding point than to one
   at the other); time each at the three training shapes, on the device
   alone and per call with the host's launch path inside, beside its
   bound, its plain version and scaled_dot_product_attention (with
   ``enable_gqa`` at Llama's; a yardstick that the port never calls),
   and the backward pair beside SDPA's backward;
   then the wrapper's repairs: head_dim 16, 32, 80, 96 (padded to 64
   or 128), 256, and 320 and 512 (the wide kernels, head_dim walked in
   chunks of 64), bf16 and fp16, causal and not, at a ragged GQA
   shape, forward and backward through autograd against the plain
   version, one launch of each kernel a case; fp16 timed against bf16
   at GPT-2 small's shape, and head_dim 80 against 128, 256, 320 and
   512 through the wrapper, beside their bounds; each kernel at 320
   and 512 alone beside its bound, its plain version and SDPA where
   SDPA takes the head_dim;
3. hold each quantization kernel (quantize, dequantize, the fused
   q-AdamW step) against its plain version on the card at GPT-2 XL's
   leaves (``wte`` as [39300, 2048], an ``fc_in`` weight as
   [5000, 2048]; bf16 and fp32), a ragged leaf, blocks 64 and 128,
   blocks 16384 and 65536 (the two-pass kernels), qmax 7, an all-zero
   row and a row of exact .5 ties; time each at ``wte`` beside its
   bound, its plain version and, for dequantize, ``torch.mul(q,
   scales)`` (a yardstick the port never calls), and the long blocks
   beside their bounds; then quantize (checked, zero mismatches) and
   dequantize at Llama-3-8B's ``lm_head`` ([128256, 4096] in rows of
   2048, fp32 zeros: q-AdamW's init input) beside their bounds and plain
   versions, and dequantize's ``torch.mul(q, scales)`` there;
4. check a small GPT on the card: the flash model against the plain
   attention model, logits and gradients, elementwise (fp32 atol 1e-4;
   bf16 atol 3e-2, for the bf16 logits reported only) and by the norm
   of the error relative to the plain model's (``MODEL_REL_NORM``);
   the flash model with one head of its first layer zeroed must fail
   the logits' norm;
5. train through ``Trainer.train()``, each run with every launch count
   set to 0 just before it and read just after, and check that the
   loss is finite and falls and that every kernel launched exactly as
   often as the run needs:
   a. GPT-2 small (seq 1024, global batch 32, micro-batch 8), AdamW;
   b. GPT-2 XL at full width and depth (48 layers, d 1600, seq 1024,
      bf16 params, flash attention, remat, batch 4) with int8 q-AdamW
      moments, the twin of ``examples/train_xl_lowmem.py``; hold the
      optimizer's one q-AdamW launch over all 580 leaves against the
      plain step of each leaf and against 580 per-leaf launches;
      report peak memory and the moments' share of it, the
      optimizer's host, wall and device time per step beside the fused
      step's summed bound, and a profiled step by kernel family;
   c. GPT-2 small with 4-bit q-AdamW moments, the path that runs the
      dequantize kernel;
   each run writes the Trainer's final checkpoint into
   ``chip_smoke_out/ckpt_*``, waits for its commit, and removes it;
6. flash checkpoint, each check fatal:
   a. GPT-2 small AdamW (seq 1024, global batch 32, micro-batch 8),
      crash and resume through ``Trainer``: this process hosts the
      agent's ``AsyncCheckpointSaver``; the three children fork from a
      warm template (the launcher's ``WorkerForkServer`` with the
      trainer modules, started right after the build, so its imports
      overlap phases 2-5), each a fresh process that makes its own CUDA
      context, its output in ``chip_smoke_out/ckpt_child_<role>.log``;
      child 1 trains 4 steps
      (``save_steps`` 2) over the real unix sockets, writes a digest of
      every parameter and SIGKILLs itself; child 2
      (``DLROVER_RESTART_COUNT=1``) resumes from shm at step 4 with
      bit-equal params, then trains 2 more steps with finite losses and
      exact flash launch counts; the segment is unlinked and child 3
      resumes from storage with child 2's final params;
   b. GPT-2 XL with int8 q-AdamW, the state the flash checkpoint exists
      for (``{"params", "opt_state"}``, ~6.2 GB): 2 steps, then, on a
      stream of high priority held by a ~1 s sleep kernel while the
      host queues it all, a third B6 update on step 2's gradients, a
      reference copy of the state in stream order, ``save_checkpoint``
      to disk and a fourth B6 update at once (B6 rewrites params and
      moments in place); the save must hold update 3 and not update 4:
      restores from shm and from storage, each bit-equal to the
      reference.  It fails if the sleep ended before the host had
      queued the race.
      Prints the save's stall (host, and the card's time in the
      snapshot copy) beside its byte bound, the D2H rate beside a
      pinned 256 MB copy, the shm write rate, the persist time to the
      tracker's commit and each restore stage by tier, ``h2d`` beside
      the pinned copy the other way.
7. the control plane: ``python -m dlrover_tpu_torch.master.main`` as a
   child for one node, its journal and logs under ``chip_smoke_out``;
   a port ``MasterClient`` here joins its rendezvous (the world's
   coordinator then serves as the ``torch.distributed`` rendezvous
   address) and ``TrainingMonitor`` + ``HeartbeatReporter`` report
   while GPT-2 small trains 8 steps through ``Trainer`` with flash
   attention (exact launch counts); the master's global step and
   running speed, read from its own ``/metrics``, must equal the
   trainer's last step and be within 10% of the trainer's speed over
   the steps the master saw; the master is SIGKILLed and restarted on
   the same journal, which must replay the round and world, and the
   client's next report must go through and give it back the step;
   neither master may hold a CUDA context (``nvidia-smi
   --query-compute-apps`` and the libraries mapped into its process),
   and no child may be left.  Prints the master's time to serve, the
   round trip of ``report_global_step``, the restart's time to serve,
   the client's reconnect and the tokens/s beside 5a's.
8. the launcher, the agent and worker recovery: ``python -m
   dlrover_tpu_torch.run`` (its ``main``, in a child process of its
   own that never touches CUDA: ``chip_smoke.py --launcher-child``)
   supervises a GPT-2 small worker (seq 1024, global batch 32,
   micro-batch 8, AdamW, flash attention, the whole train state to shm
   every 2 steps, 8 steps, the final step to storage) that it writes
   into the run's directory.  The control is the worker's training in
   this process (its model, seed, batch, AdamW and step, 8 steps, no
   launcher: a launcher run under no scenario was cut to keep the
   script inside its limit; its loss must fall, its launches are the
   path ``launcher_control_inprocess``); then,
   under ``kill_worker_midstep(seed=42)`` with step window [3, 6],
   a: cold restarts, b: ``--warm-restart`` (the worker forked from the
   forkserver template), one run each.
   Each kill run must pass ``default_invariants(8, 2, workdir)``, a
   restore from shm and ``LossTrajectoryMatches`` against the control
   (rtol 1e-3, atol 1e-5): one kill, one restart, step 8 committed,
   48 launches of each flash kernel a step in every incarnation,
   finite losses; the agent and the master load no torch and map no
   CUDA library, the forkserver template (it imports torch, which maps
   the libraries) opens no ``/dev/nvidia*`` file, and each worker holds
   the card; no process or shm segment of the run is left.  Prints the seconds from
   the kill to the respawned worker's first step by recovery phase,
   the steps lost, the goodput and the steady steps' tokens/s beside
   5a's.
   The run uses a socket directory and ``DLROVER_JOB_NAME`` of its own
   and unlinks its shm segments and removes its checkpoint directories
   at the end, on failure too.
9. ``auto_accelerate`` and its strategy search:
   a. GPT-2 XL at full width and depth (48 layers, d 1600, seq 1024,
      batch 4, fp32 params, flash attention) with the int8-optimizer
      opt-in and the hybrid search (every candidate counted on the
      ``meta`` device, the best two profiled on the card): one line a
      candidate (pruned or kept, its estimate, its profiled step and
      peak; a failed profile must be out of memory), then 6 steps of
      the chosen plan: finite losses that fall, B1-B3 launched as
      phase 5 counts them for its remat and grad accumulation, B4 only
      at its build and B6 once a step when it is low-bit, and neither
      otherwise; its tokens/s;
   b. GPT-2 small (phase 5a's config, seed and batch) under ``fsdp`` +
      ``amp_native`` + ``checkpoint`` on a one-rank NCCL group from a
      ``FileStore`` (FSDP2's hooks, DTensor parameters and the kernels
      together), 6 steps with AdamW and again with int8 q-AdamW (B6
      over the DTensors' local tiles), each against an unwrapped remat
      run: losses within rtol 1e-3 and atol 1e-5, exact launches;
   c. ``offload_opt`` at GPT-2 XL with remat: AdamW's fp32 moments in
      pinned host memory against the same plan on the card: peak at
      least 10 GiB lower, losses within rtol 1e-3, both step times;
   d. ``Trainer(strategy=...)`` on GPT-2 small for 4 steps (the plan
      rebuilds the model with remat), with phase 5's checks, one
      ``step_phases`` event a step and the phases in the metrics file.
   Every phase prints its seconds.
10. the elastic example, ``dlrover_tpu_torch/examples/train_gpt_elastic.py``
   (the twin of ``examples/train_gpt_elastic.py``), at GPT-2 small's
   full width (124,475,904 params, seq 1024, global batch 32 in one
   micro-batch) under ``fsdp`` + ``amp_native`` + ``checkpoint``
   (FSDP2, bf16, remat) on a one-rank NCCL group, depth cut to 13 and
   12 steps (the host phases' depth keeps the whole script inside its
   limit), a storage save every 4 steps with an orbax (DCP) copy of
   every 2nd:
   a. an uninterrupted control of 13 steps, the example's ``main`` in
      this process with an in-process saver (its launches reported
      under the path ``example_control_inprocess``), then a run of 12
      through ``python -m dlrover_tpu_torch.run --nproc_per_node=1
      --max_restarts=3 --warm-restart`` (path ``example_kill``),
      SIGKILLed once its
      snapshot of step 8 is in shm (after a committed save), whose
      respawned worker
      restores params and AdamW moments from shm through
      ``load_checkpoint(target_state=...)``: every loss of every
      incarnation within rtol 1e-3 / atol 1e-5 of the control's (bit
      equality reported), exactly 24 B1 and 12 B2 and B3 launches in
      every step, step 12 committed;
   b. the killed run's committed step 12, saved under FSDP2 (DTensors),
      restores from storage bit-equal into an unwrapped data plan and
      into a one-rank tensor plan (DTensor Dense layers); each then
      takes step 13 with the control's loss (rtol 1e-3 / atol 1e-5);
      with the flash storage removed, the orbax tier alone restores
      step 12 (the respawned worker's first storage save) bit-equal;
   c. prints the sharded save's stall on the host and on the card, the
      seconds to shm and to commit, each storage save's persist (ok,
      seconds, committed) in the control and in the kill run, each
      restore's read / assemble / h2d by tier and its rate, and the
      example's tokens/s beside phase 9b's FSDP2 step.
   On a failure the runs' launcher and event logs are copied into
   ``chiprun_out/phase10``.

11. the Llama family and the chunked loss (slice 5.1):
   a. a narrow Llama (4 q heads over 1 kv head, head_dim 128, seq 256),
      the flash model against the plain-attention one from the same
      weights in fp32 (logits and gradients within 1e-4) and bf16
      (logits within 5e-2 absolute and relative, the reference's own
      Llama tolerance; gradients within 3e-2), one launch of each kernel
      a layer;
   b. Llama-3-8B at full width and depth (32 layers, d 4096, 32 heads
      over 8 kv heads, intermediate 14336, vocab 128256, rope theta
      5e5, 8,030,261,248 params in 291 tensors), seq 8192, batch 1, bf16
      params built on the card, through ``Trainer(strategy=[half,
      checkpoint, module_replace(flash), low_bit_opt(int8)])`` (the plan
      rebuilds the model with remat and flash) and
      ``chunked_loss_fn(num_chunks=8)``, q-AdamW lr 3e-4 and weight
      decay 0.1, 6 steps on one fixed batch with no checkpoint (the
      Trainer's saves write nothing here: the final one would copy 16 GB
      of params to shm and disk):
      finite falling losses; exactly 64 B1, 32 B2, 32 B3 and 1 B6 a
      step, B4 582 times at the optimizer's init only, B5 never; peak
      memory and the moments' share, tokens/s and MFU (``lm_head``
      counted, the ``wte`` lookup not), a profiled step by kernel
      family, the chunked loss against the full logits -> cross entropy
      loss on the same params, each a later micro-batch's forward and
      backward over allocated gradients (the full one must peak higher,
      the losses agree within 1e-3), and B6 alone (host, wall, device)
      beside its bound;
   c. the count tier (``meta``, no profiling) over the Llama-3-8B
      candidates for this card with the int8-optimizer opt-in: the
      memory model's verdict on every precision level (every fp32-AdamW
      plan pruned), each kept candidate's estimate, and the chosen
      plan's state within the card's memory.

12. the data side of the agent and the node check (slice 8.1): the
   twin of ``examples/train_with_shm_loader.py``
   (``dlrover_tpu_torch/examples/train_with_shm_loader.py``) at GPT-2
   small's full width (flash, seq 1024, batch 16: 12 launches of each
   flash kernel a step; AdamW(3e-4, 0.1); depth cut to 20 steps from
   200) through ``python -m dlrover_tpu_torch.run --warm-restart`` (its
   ``main`` in a child of its own that never touches CUDA:
   ``chip_smoke.py --data-child``), each check fatal:
   a. the plain ``ElasticDataLoader`` over the master's sharding, then
      the ``ShmDataLoader`` (two workers, page-locked slots) on the same
      indices: losses equal bit for bit, exactly 12 of each flash
      kernel a step, each loader's input wait and its share of the
      steps, the median step;
   b. the shm loader fed by ``IndexShardingClient`` (shuffle off) with
      its dataset position in the flash checkpoint (every 2 steps),
      SIGKILLed at step 4 by ``kill_worker_midstep``, respawned from
      the template, restored from shm at step 2: every sample index
      acked once (``NoDuplicateShards``), every loss equal to 12a's shm
      run's bit for bit, the kill -> first step time by recovery phase;
   c. ``--network-check`` before 12a's plain run: one round, the node
      normal, training after it; ``bm_chip_matmul``'s time and TFLOP/s
      beside the bf16 peak; the collective probe None on one GPU.
   The agent loads no torch, the shm workers open no ``/dev/nvidia*``
   file, and no process or shm segment of a run is left.

13. sequence and expert parallelism (slice 5.2), each check fatal:
   a. the ring's blocks at Llama-3-8B's attention (b 1, s 8192, 32 q
      heads over 8 kv heads, d 128, bf16) cut into 4 shards driven in one
      process (``ring_forward_shards``, ``ring_backward_shards``), causal
      and not: O, lse, dQ, dK and dV by ||got - want|| / ||want|| against
      the whole sequence through B1-B3 and against the plain ring in fp32
      (``RING_REL_NORM``), a planted fault (one block merged without its
      lse correction) that must fail, exactly 10 launches of each of B1-B3
      causal (4 diagonal blocks, 6 full, 6 skipped) and 16 not; the ring's
      forward and backward timed against the whole sequence's;
   b. the twin of ``examples/train_mixtral.py``
      (``dlrover_tpu_torch/examples/train_mixtral.py``) at
      ``mixtral_8x7b``'s full width cut to 2 layers, batch 8 x 1024, the
      reference's strategy at expert 1 plus ``module_replace(flash)``,
      AdamW 3e-4, 6 steps: a finite falling loss, the aux loss, the
      median step, tokens/s, MFU over the active weights, the peak,
      exactly 4 B1, 2 B2 and 2 B3 a step, a profiled step; then the
      twin's ``--smoke`` on the card.

14. the rest of scale-out (slice 4.3), each check fatal:
   a. Llama-3-8B at full width and depth (11b's model and batch) with
      4-bit q-AdamW under FSDP2 on a one-rank NCCL group (the split-block
      B4/B5 launches), 6 steps, against the same plan without ``fsdp``
      over 3: losses within rtol 1e-3, exact launches, the median step,
      tokens/s, MFU and peak;
   b. ``mixtral_8x7b`` at full width cut to 1 layer under FSDP2 (its
      experts DTensors): a snapshot of params and AdamW moments to shm at
      step 2, 2 control steps, then a fresh plan restored from shm
      replays them: losses within rtol 1e-3 / atol 1e-5, exact launches,
      the save's and the restore's seconds;
   c. GPT-2 XL ``offload_opt`` under FSDP2 (DTensor states by shard in
      pinned host memory) against the same without it: losses, launches,
      peaks and steps;
   d. DiLoCo's outer step over GPT-2 small's tree stacked 4 times on the
      card, each reduce method against the CPU;
   e. GPT-2 small as a one-rank tensor plan (the vocab-parallel table,
      column-parallel weights ``Shard(1)``) with int8 q-AdamW against the
      same model unwrapped: the split-block B6 launches, losses within
      rtol 1e-3.
   Phase 3 also holds the split-block mode of B4, B5 and B6 against its
   plain versions at one tensor-4 rank's shard of Llama-3-8B's leaves
   and times it at ``lm_head``'s.
15. pipeline parallelism and fp8 (slice 5.3), each check fatal:
   a. ``PipelinedGPT`` at GPT-2 XL's full width and depth (bf16 over
      fp32 params, flash), 4 stages in this process, 8 microbatches of
      1: one GPipe step (remat) and one 1F1B step from the weights of an
      unpipelined XL step on the same batch; loss and every gradient
      within ``MODEL_REL_NORM`` of it by the relative norm; B1-B3
      launches exact (768, 384, 384 a step); step times (one process:
      the stages run one after another, no speed claim);
   b. ``fp8_dot``'s ``torch._scaled_mm`` against its plain version at
      XL's MLP products ([8192, 1600]·[1600, 6400] and
      [8192, 6400]·[6400, 1600]) within ``FP8_REL_NORM``, each timed
      beside bf16 ``torch.matmul``; then GPT-2 XL through
      ``auto_accelerate`` with phase 5b's plan plus ``fp8``, 6 steps of
      int8 q-AdamW: a falling loss, exact launches, the step against
      5b's in the same run.
16. the RL engine with KV-cache decode (slice 7), each check fatal:
   a. PPO at GPT-2 small's full width (124,475,904 params, 12 layers,
      max_seq_len 1024): an actor (``module_replace(flash)``, bf16 amp),
      a value-head critic that searches its plan (cost model), a frozen
      bf16 ref; 32 prompts of 128 tokens, 128 new tokens at temperature
      1, the example's reward; 4 ``ppo_iteration`` s and one
      ``PPOTrainer`` epoch, each iteration's phase seconds, tokens/s
      and peak memory; B1-B3 launches exact (from the roles' plans) for
      the run, one experience phase and one PPO step; greedy decode
      through the cache against the full forward's logits at every
      generated position, and one PPO step's actor and critic gradients
      through B1-B3 against the plain attention's, by the relative norm
      (``RL_REL_NORM``, 8 * 2^-8);
   b. Llama-3-8B decode at full width and depth (bf16 params, a cache
      of the preset's 8192 positions): batch 8, prompts of 1024, 256
      greedy tokens through ``generate``; the median decode step beside
      its bound (weights + the whole cache at 3.35 TB/s), tokens/s,
      the cache's size and the peak; the first 16 greedy tokens'
      logits against one full forward through B1;
   c. the RL chaos loop (``rl_rollout_worker_kill``) through the port's
      launcher (the respawn forked from the warm template), its models
      on the card at GPT-2 small's width cut to 2 layers, 8 leases, a
      SIGKILL at lease 2: the losses equal the
      uninterrupted control's (computed here on the card), every lease
      acked exactly once, and the kill -> first PPO step seconds.
17. sparse training (slice 6), each check fatal; no CUDA kernel of the
   port runs here (the tower is ATen, the tables host C++):
   a. ``DeepFM(DeepFMConfig())`` (26 fields of 16, tower 429-128-64-1)
      with its tower on the card, batch 4096 of each field's ids drawn
      Zipf(1.05) over its Criteo Kaggle vocabulary (33,762,577 keys in
      all), 350 strict steps (the table past 2 M rows), then the
      pipelined and auto modes over the first 100 of those batches,
      each on a fresh model: samples/s, the median step, its gather,
      H2D, device, D2H and update shares, the card's busy share (CUDA
      events), rows and host GiB; losses finite and falling, the
      pipelined last-10 mean within 0.05 of the strict one;
   b. the strict table's sparse flash checkpoint: a paged shm base, a
      delta after 8 more steps, a fresh engine and fresh tables
      restoring it from shm; two durable saves with delta checkpoints
      restored from storage (the chain, base + delta) with the segment
      gone; digests of rows, frequencies and slots equal the saves';
      bytes, ratio, stalls, restore seconds and GB/s by tier;
   c. ``sparse_kill_restore`` through the port's launcher (a child
      that never touches CUDA; the respawn forked from the warm
      template), the tower on the card, the spill tier
      armed: the losses equal the uninterrupted control's (run here on
      the card), ``KvStateRoundTrip`` holds, kill -> first step seconds;
   d. the serving plane (slice 9.1) on the host, fed by b's strict table
      (about 2.04 M rows): a serving adapter on the table publishes a
      base, 12 more strict steps on new batches publish a delta every
      4; a ``ReplicaPool`` of 2 ``python -m dlrover_tpu_torch.serving``
      processes behind a ``python -m dlrover_tpu_torch.serving.router``
      process ingests the chain while ``LookupLoadHarness`` (4 streams
      of 256) drives routed lookups of the fields' Zipf keys: every
      ingest digest equals its publish's, both replicas reach the last
      generation, a lookup of 100,000 seeded keys (some absent) on each
      equals ``model.table.gather_or_zeros`` bit for bit, no routed
      lookup fails, neither the replicas nor the router map a CUDA
      library; the base's rows, bytes and seconds, each delta's rows,
      bytes and publish stall, the ingest seconds, freshness, routed
      lookups/s with p50/p99 and the phase's seconds.  Runs after b,
      before c.
18. BERT and GPT's save_attn remat (slice 5.4), each check fatal:
   a. a narrow BERT in fp32 on the card against the CPU (logits within
      1e-4); then ``Bert(BertConfig())`` at full width (vocab 30528, 12
      layers, 12 heads, hidden 768, seq 512) through ``auto_accelerate``
      with ``[half, checkpoint]`` and AdamW, 8 steps on one MLM batch
      of 32 x 512 (two segments, 15% of positions masked, the last 32
      positions of half the rows padded): a finite loss that falls, no
      hand kernel launched (BERT's attention is ATen, as the
      reference's is jnp), the median step, tokens/s, MFU (6 FLOPs per
      weight per token plus 12 L s d of non-causal attention), the peak
      and the top ops of one step from ``utils/profiler``;
   b. inside phase 5b, on its GPT-2 XL and int8 q-AdamW state (no
      second XL model): one step under full remat and one under
      ``remat_policy="save_attn"`` from the same state: losses and
      updated parameters within rtol 1e-3 / atol 1e-5, exactly 96 B1,
      48 B2, 48 B3 and 1 B6 in the save_attn step; then 4 steps of
      each policy, interleaved, median and peak beside 5b's.
19. the step caches and the fleet (slices 8.2 and 9.2), each fatal:
   a. warm recovery with the step caches: phase 8's GPT-2 small worker
      (its model, batch, AdamW and flash) under ``python -m
      dlrover_tpu_torch.run --warm-restart`` with ``DLROVER_AOT_PRETRACE``
      and a fresh ``DLROVER_COMPILE_CACHE_DIR`` under the run's
      directory, so the first incarnation builds the flash library there
      (its ``nvcc`` seconds printed: what a replacement host pays without
      the cache) and writes its step's AOT entry; SIGKILLed at step 4 of
      8, it is respawned from the warm template, which preloaded the
      entry and its library: the respawn's ``compile_cache`` event says
      ``aot-hit`` with no new library, its ``aot_cache`` event a hit
      whose library the template loaded, the template opened no
      ``/dev/nvidia*`` file and maps no ``libnvidia*`` library (its
      ``import torch`` maps ``libcuda.so`` and ``libcudart``, as phase 8
      notes) but maps the flash library, and every loss equals phase
      8's in-process control bit for bit (``launcher_control_inprocess``,
      reused; computed here under ``--only 19``); retrace seconds and
      kill -> first step printed;
   b. the fleet: ``FleetRunner`` with 200 synthetic agents (the profile
      of ``tests/test_fleet.py``'s ramp, in packs of 50) against one
      journal-backed master, in a child process that never imports
      torch, held 8 s SLO-green with no agent-side error; then a
      capacity search from 300 agents, capped at 30 s; the per-verb
      p99s, the sustained agents, and that the master's process maps no
      CUDA library.

Prints the card, a ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  ``--only 2,11`` runs the build
and the named phases alone (2, 3, 4, 5b, 9b, 10, 11, 12, 13, 13a, 13b,
14, 14a-14e, 15, 15a, 15b, 16, 16a-16c, 17, 17a-17d, 18 (18a, then 5b
with 18b), 18a and 18b (5b with 18b), 19, 19a and 19b so far; 5lr,
which the full run leaves out: phase 5a's model at lr 1e-3 with the
flash kernels and with the plain attention math, and at SMALL_LR; and
11d, which the full run leaves out too: 11b's Llama-3-8B for 12 steps
with its int8 q-AdamW and with torch's AdamW, each step's loss and
gradient norm, the four B6 rows with the largest update at each of
q-AdamW's steps 8 and 9 written to ``chip_smoke_out/qadam_rows_11d.json``
for ``tests/test_torch_qadam_rows.py``, and six q-AdamW steps followed
by B6's six timing steps on one gradient) and prints no result lines.
Exits non-zero with no result when there is no CUDA device or no
package beside the script.
"""

import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chip_smoke_out")

# H100 SXM data-sheet peaks (dense): HBM bytes/s, FLOP/s by input type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

SOURCES = ("flash_attention", "quantization")
_FLASH = "dlrover_tpu_torch/csrc/flash_attention.cu"
_QUANT = "dlrover_tpu_torch/csrc/quantization.cu"
# kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "flash_attention.fwd": (
        _FLASH, "dlrover_tpu/ops/flash_attention.py:70 (_fwd_kernel, via _fwd :137)"),
    "flash_attention.bwd_dq": (
        _FLASH, "dlrover_tpu/ops/flash_attention.py:195 (_bwd_dq_kernel, via _bwd :318)"),
    "flash_attention.bwd_dkv": (
        _FLASH, "dlrover_tpu/ops/flash_attention.py:252 (_bwd_dkv_kernel, via _bwd :318)"),
    "quantization.quantize": (
        _QUANT, "dlrover_tpu/ops/quantization.py:39 (_quant_kernel, via _quantize_tiles :61)"),
    "quantization.dequantize": (
        _QUANT, "dlrover_tpu/ops/quantization.py:48 (_dequant_kernel, via _dequantize_tiles :166)"),
    "quantization.qadam": (
        _QUANT, "dlrover_tpu/ops/quantization.py:195 (_qadam_kernel, via fused_qadam_step :245)"),
    # the split-block mode (a shard whose global blocks other ranks
    # share): B4 and B6 in two launches around a max all-reduce, B5 in one
    "quantization.absmax_pieces": (
        _QUANT, "dlrover_tpu/ops/quantization.py:39 (_quant_kernel's absmax, via _quantize_tiles :61), split-block pass 1"),
    "quantization.quantize_pieces": (
        _QUANT, "dlrover_tpu/ops/quantization.py:39 (_quant_kernel's codes, via _quantize_tiles :61), split-block pass 2"),
    "quantization.dequantize_pieces": (
        _QUANT, "dlrover_tpu/ops/quantization.py:48 (_dequant_kernel, via _dequantize_tiles :166), split-block"),
    "quantization.qadam_split_absmax": (
        _QUANT, "dlrover_tpu/ops/quantization.py:195 (_qadam_kernel's moment maxima, via fused_qadam_step :245), split-block pass 1"),
    "quantization.qadam_split_apply": (
        _QUANT, "dlrover_tpu/ops/quantization.py:195 (_qadam_kernel's codes and update, via fused_qadam_step :245), split-block pass 2"),
}
# the split-block kernels, checked and timed by _check_split_kernels
SPLIT_KERNELS = tuple(k for k in KERNELS if k.endswith(
    ("_pieces", "_split_absmax", "_split_apply")))

# (b, s, h, kv_heads, d, dtype, causal): the training shapes first, GPT-2
# small's (the one in the kernels line), GPT-2 XL's and Llama-3-8B's
# (seq 8192, 32 q heads over 8 kv heads: GQA group 4, head_dim 128),
# then Mixtral's in phase 13b (batch 8 x 1024, the same heads)
CASES = [
    (8, 1024, 12, 12, 64, "bfloat16", True),
    (4, 1024, 25, 25, 64, "bfloat16", True),
    (1, 8192, 32, 8, 128, "bfloat16", True),
    (8, 1024, 32, 8, 128, "bfloat16", True),
    (2, 200, 4, 4, 64, "bfloat16", False),    # ragged last tile
    (2, 328, 8, 4, 64, "bfloat16", True),     # GQA group 2, ragged
    (2, 384, 4, 4, 128, "bfloat16", True),
    (1, 136, 4, 2, 128, "bfloat16", True),    # d 128, GQA, ragged
    (4, 255, 12, 12, 64, "bfloat16", True),   # a seq 4 does not divide
    (8, 1024, 12, 12, 64, "float16", True),   # fp16 at GPT-2 small's shape
    (2, 328, 8, 4, 64, "float16", False),     # fp16, GQA, ragged
    (1, 136, 4, 2, 128, "float16", True),     # fp16, d 128, GQA, ragged
    (2, 512, 4, 4, 64, "float32", True),
    (2, 320, 8, 2, 128, "float32", False),
    (1, 100, 2, 2, 64, "float32", True),
]
TIMED_CASES = 3
# the plain version's tile at the Llama shape (fewer Python iterations;
# the kernels use their own tiles), and one tile at seq 255, which
# _fit_block (the reference's rule) would cut into tiles of one row
PLAIN_BLOCK = {8192: 512, 255: 255}
# dtype -> tolerance on (out, dq, dk, dv), lse, delta: bf16 and fp16
# outputs are rounded once more than the fp32 math inside, fp16 keeping
# 3 more bits than bf16; fp32 differs only by the order of the sums
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2, lse=1e-3, delta=1e-3),
       "float16": dict(atol=4e-3, rtol=4e-3, lse=1e-3, delta=1e-3),
       "float32": dict(atol=1e-4, rtol=0.0, lse=1e-4, delta=1e-4)}
# bf16 and fp16 (out, dq, dk, dv): the largest ||got - want|| / ||want||
# against the plain version, a few of the type's unit roundoff (2^-8,
# 2^-11).  TOL's atol alone stops failing a wrong output as the keys grow:
# at s 8192 a typical |out| (and |dv| of most keys) is ~sqrt(e / s) ~
# 0.02, TOL's bf16 atol; the norm is held to the values' own size
REL_NORM = {"bfloat16": 1e-2, "float16": 3e-3}
# the fault planted at the long case to show the norm check fails it:
# two kv tiles of 128 keys past the first 1024 swapped on the V path
PLANTED_TILES = (4096, 4224, 4352)
# bf16 and fp16 dK/dV and dQ: the largest ratio of mean errors to the
# plain version at the TPU kernel's rounding point and to the one at the
# other point (_check_dkv_rounding, _check_dq_rounding)
ROUNDING_RATIO = 0.8
# the flash wrapper's repairs: head dims it pads (16-96, to 64 or 128),
# 256, and 320 and 512 on the wide kernels, in bf16 and fp16, causal and
# not, at a ragged GQA shape (b, s, h, kv_heads), through the autograd
# wrapper; held to TOL
PAD_DIMS = (16, 32, 80, 96, 256, 320, 512)
WIDE_DIMS = (320, 512)
PAD_SHAPE = (2, 200, 4, 2)

# (leaf, numel, block, dtype, qmax): GPT-2 XL's wte first, the timed case
QUANT_CASES = [
    ("wte", 50304 * 1600, 2048, "bfloat16", 127.0),
    ("fc_in", 1600 * 6400, 2048, "bfloat16", 127.0),
    ("wte", 50304 * 1600, 2048, "float32", 127.0),
    ("fc_in", 1600 * 6400, 2048, "float32", 127.0),
    ("qkv bias, ragged", 3 * 1600, 2048, "bfloat16", 127.0),
    ("ragged, block 64", 37 * 64 + 5, 64, "float32", 127.0),
    ("ragged, block 128", 333 * 128 + 5, 128, "bfloat16", 127.0),
    ("4-bit", 1000 * 2048 + 77, 2048, "float32", 7.0),
    ("4-bit, block 64", 999 * 64 + 3, 64, "bfloat16", 7.0),
    # blocks past the 8192 a CTA holds in registers: the two-pass kernels
    ("block 16384", 2048 * 16384 + 777, 16384, "bfloat16", 127.0),
    ("block 65536", 512 * 65536 + 5, 65536, "bfloat16", 127.0),
    ("block 65536", 512 * 65536 + 5, 65536, "float32", 127.0),
]
# the longest row the quantization kernels hold in registers; longer
# rows take the two-pass kernels, whose bf16 cases are timed too
REG_BLOCK = 8192
# The quantization kernels and their plain versions do the same IEEE
# operations in the same order, one rounding each (no FMA contraction,
# IEEE division and square root, rint), so codes, scales and the new
# parameter must be identical: the tolerance is 0 mismatches.
QUANT_TOL = 0
QADAM_HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, lr=3e-4, wd=0.1)
TIE_SCALE = 2.0 ** -10

# ~1 ms of the card's clock: longer than any launch path on the host
SLEEP_CYCLES = 2_000_000
# ~20 ms: longer than the q-AdamW step's host path over GPT-2 XL's leaves
OPT_SLEEP_CYCLES = 40_000_000

SMALL_SEQ = 1024
# GPT-2 small's learning rate in phases 5-9, the reference examples'
# 3e-4: with the embeddings drawn as flax draws them (ROADMAP C 5), the
# Trainer's default of 1e-3 (the reference's default too) overshoots the
# one fixed batch at step 6, through the flash kernels and through the
# plain attention math alike (``--only 5lr``), and so does the JAX
# package in fp32 on the CPU (tests/torch_gpt2_small_lr_witness.py)
SMALL_LR = 3e-4
XL_BATCH, XL_STEPS = 4, 6
# ~1 s at 1.98 GHz: phase 6b's host queues its race inside it
RACE_SLEEP_CYCLES = 2_000_000_000
# phase 6a: steps before the kill, and in all
CKPT_KILL_STEP, CKPT_STEPS = 4, 6
# time for the agent side to commit a step to storage
COMMIT_TIMEOUT_S = 300.0


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, reps: int, warmup: int = 2, device_only=True,
              sleep_cycles=SLEEP_CYCLES) -> float:
    """Median time of one call of ``fn``, between CUDA events.  With
    ``device_only``, a sleep kernel queued before each start event holds
    the card while the host enqueues the call, so a kernel shorter than
    its own launch path on the host is timed on the device alone;
    without it, the time is the longer of the device's and the host's
    path from one event to the other: what one call costs a caller that
    issues calls back to back."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def reset_launch_counts():
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantization as qz

    fa.reset_launch_counts()
    qz.reset_launch_counts()


def launch_counts() -> dict:
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantization as qz

    return {**{f"flash_attention.{k}": v for k, v in fa.LAUNCHES.items()},
            **{f"quantization.{k}": v for k, v in qz.LAUNCHES.items()},
            **{f"quantization.{k}": v
               for k, v in qz.SPLIT_LAUNCHES.items()}}


# the kernels that must issue wgmma and TMA copies
WGMMA_KERNELS = ("fwd_tma_kernel", "dkv_tma_kernel", "dq_tma_kernel")


_MANGLED_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}


def _kernel_name(mangled: str) -> str:
    """``fwd_tma_kernel<64,bf16>`` from an Itanium-mangled template name."""
    import re

    m = re.search(r"\d+([a-z_]+kernel)(?:I((?:Li\d+E)*)(13__nv_bfloat16|"
                  r"6__half|f)?)?", mangled)
    if not m:
        return mangled[:60]
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    if m.group(3):
        args.append(_MANGLED_TYPES[m.group(3)])
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def sass_counts(lib_path) -> dict:
    """``{kernel: {"HGMMA": n, "UTMALDG": n, "UBLKCP": n}}`` from
    ``cuobjdump -sass``, or ``None`` when the toolkit has no cuobjdump."""
    import re
    import shutil

    from dlrover_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        return None
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
            counts[name] = {"HGMMA": 0, "UTMALDG": 0, "UBLKCP": 0}
        elif name:
            for op in counts[name]:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


def phase_build():
    import re

    from dlrover_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    seconds = cuda_build.build(SOURCES)
    log(f"build: {json.dumps(seconds)} (wall {time.perf_counter() - t0:.1f} s)")
    for name in SOURCES:
        ptxas = cuda_build.library_path(name).with_suffix(".log")
        if not ptxas.exists():
            continue
        kernel = "?"
        for line in ptxas.read_text().splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = _kernel_name(m.group(1))
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {kernel}: {line.strip()[:240]}")
    counts = sass_counts(cuda_build.library_path("flash_attention"))
    if counts is None:
        log("sass: no cuobjdump in the CUDA toolkit, instruction counts "
            "not taken")
        return
    for kernel, c in counts.items():
        if kernel.split("<")[0] in WGMMA_KERNELS:
            log(f"sass flash_attention {kernel}: {json.dumps(c)}")
            if not c["HGMMA"] or not (c["UTMALDG"] or c["UBLKCP"]):
                raise AssertionError(f"{kernel} issues no wgmma or no TMA "
                                     f"copy: {c}")


def _pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def _bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bounds_ms(b, s, h, kvh, d, dtype, causal):
    """Least time per kernel: each input read once, each output written
    once, over HBM; the products the kernel must do over the peak of
    the input type; the larger of the two."""
    esz = 4 if dtype == "float32" else 2
    qo = b * s * h * d * esz          # q, out, dout, dq: [b, s, h, d]
    kv = b * s * kvh * d * esz        # k, v, dk, dv
    rows = b * h * s * 4              # lse, delta: fp32 [b, h, s]
    pairs = b * h * _pairs(s, causal)
    work = {
        # bytes moved, FLOPs (2 d per pair per product)
        "flash_attention.fwd": (qo + 2 * kv + qo + rows, 2 * 2 * d * pairs),
        "flash_attention.bwd_dq": (qo + 2 * kv + 2 * qo + rows + qo + rows,
                                   3 * 2 * d * pairs),
        "flash_attention.bwd_dkv": (qo + 2 * kv + qo + 2 * rows + 2 * kv,
                                    4 * 2 * d * pairs),
    }
    return {name: _bound(nbytes, flops, dtype)
            for name, (nbytes, flops) in work.items()}


# fp32 operations per element, counted from each kernel's arithmetic
QUANT_OPS = {"quantization.quantize": 6, "quantization.dequantize": 1,
             "quantization.qadam": 31}


def qadam_bytes(numel, block, esz):
    """Bytes the fused q-AdamW step must move for one parameter: g and
    p read, p written; both code arrays and both scale columns read
    and written."""
    rows = -(-numel // block)
    return 3 * numel * esz + 4 * rows * block + 4 * rows * 4


def quant_bounds_ms(numel, rows, block, dtype):
    """Least time per quantization kernel on ``numel`` elements in
    ``rows`` rows of ``block``: every input read once, every output
    written once (int8 codes, fp32 scales, g/p in ``dtype``)."""
    esz = 2 if dtype == "bfloat16" else 4
    codes, scales, tiles = rows * block, rows * 4, rows * block
    work = {
        "quantization.quantize": numel * esz + codes + scales,
        "quantization.dequantize": codes + scales + numel * 4,
        "quantization.qadam": qadam_bytes(numel, block, esz),
    }
    return {name: _bound(nbytes, QUANT_OPS[name] * tiles, "float32")
            for name, nbytes in work.items()}


def _check(name, got, want, atol, rtol, failures, case):
    import torch

    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (err <= atol + rtol * want.float().abs()).all()
    )
    if not ok:
        failures.append(f"{case} {name}: max_abs_err {err.max().item():.3e}")
    return err.max().item()


def _rel_norm(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _check_norm(name, got, want, rel, failures, case):
    err = _rel_norm(got, want)
    if not err <= rel:
        failures.append(f"{case} {name}: ||got - want|| / ||want|| "
                        f"{err:.3e} > {rel}")
    return err


def _check_planted_fault(q, k, v, dout, lse, delta, scale, causal, want,
                         tol, rel, failures, case):
    """The checks against a fault on the V path past the first 1024
    keys, planted through the kernels' inputs and outputs: the kv tiles
    ``PLANTED_TILES`` swapped in V (a kernel reading the wrong V tile
    coordinates: the forward's out and the backward's dK), and in dV's
    rows (a kernel writing dV to the wrong tile).  The norm check must
    fail each of out, dk and dv; logs whether TOL's elementwise check
    alone would (``want``: the plain out, dk, dv)."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    lo, mid, hi = PLANTED_TILES
    perm = torch.arange(q.shape[1], device=q.device)
    perm[lo:hi] = torch.cat([perm[mid:hi], perm[lo:mid]])
    v_bad = v[:, perm]
    out_bad, _ = fa.fwd_cuda(q, k, v_bad, scale, causal)
    dk_bad, dv = fa.bwd_dkv_cuda(q, k, v_bad, dout, lse, delta, scale,
                                 causal)
    report = []
    for name, got, w in zip(("out", "dk", "dv"),
                            (out_bad, dk_bad, dv[:, perm]), want):
        err = _rel_norm(got, w)
        elementwise = []
        _check(name, got, w, tol["atol"], tol["rtol"], elementwise, case)
        report.append(f"{name} norm {err:.3e} "
                      f"({'fails' if err > rel else 'PASSES'}), TOL "
                      f"{'fails' if elementwise else 'passes'}")
        if not err > rel:
            failures.append(f"{case} planted V fault in keys {lo}-{hi - 1}: "
                            f"{name} passes the norm check ({err:.3e})")
    log(f"planted V fault {case}, kv tiles {lo}-{mid - 1} and {mid}-"
        f"{hi - 1} swapped: " + "; ".join(report))


def _check_dkv_rounding(q, k, v, dout, lse, delta, scale, causal, blocks,
                        dk, dv, failures, case):
    """The bf16 and fp16 dK/dV kernels keep p and dS at fp32 precision
    (the TPU kernel's rounding point, by a hi+lo split in the input
    type), which TOL cannot tell from rounding them to the input type.
    The mean error to the plain version with fp32 p and dS must be well
    under the mean error to one that rounds them: ~0.63 of it for a
    kernel that keeps fp32, ~1.6 for one that rounds (both outputs
    rounded once).  Returns the two ratios (dk, dv)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    f32 = [x.float() for x in (q, k, v, dout)]
    fine = fa.bwd_dkv_plain(*f32, lse, delta, scale, causal, *blocks)
    coarse = fa.bwd_dkv_plain(*f32, lse, delta, scale, causal, *blocks,
                              operand_dtype=q.dtype)
    ratios = []
    for name, got, a, b in zip(("dk", "dv"), (dk, dv), fine, coarse):
        got = got.float()
        ratio = ((got - a).abs().mean() / (got - b).abs().mean()).item()
        ratios.append(ratio)
        if not ratio <= ROUNDING_RATIO:
            failures.append(f"{case} {name}: closer to {q.dtype} p and dS "
                            f"than to fp32 (error ratio {ratio:.4f})")
    return ratios


def _check_dq_rounding(q, k, v, dout, lse, delta, scale, causal, blocks, dq,
                       failures, case):
    """The bf16 and fp16 dQ kernels round dS to the input type before
    dS K, as the TPU kernel does (``ds.astype(k.dtype)``), which TOL
    cannot tell from keeping it fp32.  The mean error to the plain
    version with dS rounded (fp32 out) must be well under the mean error
    to one that keeps dS fp32: ~0.63 of it for a kernel that rounds,
    ~1.6 for one that does not (the output rounded once either way).
    Returns the ratio."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    fine = fa.bwd_dq_plain(qf, kf, vf, dof, lse, delta, scale, causal,
                           *blocks)
    # k in its type rounds dS to it (ds.to(k.dtype)); q in fp32 keeps dq
    # fp32
    coarse = fa.bwd_dq_plain(qf, k, vf, dof, lse, delta, scale, causal,
                             *blocks)
    got = dq.float()
    ratio = ((got - coarse).abs().mean() / (got - fine).abs().mean()).item()
    if not ratio <= ROUNDING_RATIO:
        failures.append(f"{case} dq: closer to fp32 dS than to {k.dtype} "
                        f"dS (error ratio {ratio:.4f})")
    return ratio


def phase_kernels(card: str):
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    failures = []
    results = {}
    for case in CASES:
        b, s, h, kvh, d, dtype_name, causal = case
        dtype = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        scale = d ** -0.5

        def rnd(heads):
            return torch.randn(b, s, heads, d, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)

        q, k, v, dout = rnd(h), rnd(kvh), rnd(kvh), rnd(h)
        tile = PLAIN_BLOCK.get(s, 128)
        blocks = (fa._fit_block(s, tile), fa._fit_block(s, tile))
        out_p, lse_p = fa.fwd_plain(q, k, v, scale, causal, *blocks)
        delta_p = fa.delta_plain(out_p, dout)
        dq_p = fa.bwd_dq_plain(q, k, v, dout, lse_p, delta_p, scale,
                               causal, *blocks)
        dk_p, dv_p = fa.bwd_dkv_plain(q, k, v, dout, lse_p, delta_p, scale,
                                      causal, *blocks)
        out_c, lse_c = fa.fwd_cuda(q, k, v, scale, causal)
        dq_c, delta_c = fa.bwd_dq_cuda(q, k, v, out_p, dout, lse_p, scale,
                                       causal)
        dk_c, dv_c = fa.bwd_dkv_cuda(q, k, v, dout, lse_p, delta_p, scale,
                                     causal)
        torch.cuda.synchronize()
        at, rt = tol["atol"], tol["rtol"]
        errs = {
            "flash_attention.fwd": max(
                _check("out", out_c, out_p, at, rt, failures, case),
                _check("lse", lse_c, lse_p, tol["lse"], 0.0, failures, case)),
            "flash_attention.bwd_dq": max(
                _check("dq", dq_c, dq_p, at, rt, failures, case),
                _check("delta", delta_c, delta_p, tol["delta"], 0.0,
                       failures, case)),
            "flash_attention.bwd_dkv": max(
                _check("dk", dk_c, dk_p, at, rt, failures, case),
                _check("dv", dv_c, dv_p, at, rt, failures, case)),
        }
        log(f"kernel check {case}: " + ", ".join(
            f"{n} max_abs_err {e:.3e}" for n, e in errs.items())
            + f" (tolerance {tol})")
        if dtype is not torch.float32:
            rel = REL_NORM[dtype_name]
            norms = [_check_norm(n, got, want, rel, failures, case)
                     for n, got, want in (("out", out_c, out_p),
                                          ("dq", dq_c, dq_p),
                                          ("dk", dk_c, dk_p),
                                          ("dv", dv_c, dv_p))]
            log(f"kernel norm check {case}: ||got - want|| / ||want|| out "
                f"{norms[0]:.3e}, dq {norms[1]:.3e}, dk {norms[2]:.3e}, dv "
                f"{norms[3]:.3e} (must be <= {rel})")
            if s >= PLANTED_TILES[-1]:
                _check_planted_fault(q, k, v, dout, lse_p, delta_p, scale,
                                     causal, (out_p, dk_p, dv_p), tol, rel,
                                     failures, case)
            ratios = _check_dkv_rounding(q, k, v, dout, lse_p, delta_p, scale,
                                         causal, blocks, dk_c, dv_c,
                                         failures, case)
            log(f"dkv rounding point {case}: mean error to the fp32-p/dS "
                f"version over that to the {dtype_name}-p/dS one, dk "
                f"{ratios[0]:.4f}, dv {ratios[1]:.4f} (must be <= "
                f"{ROUNDING_RATIO})")
            dq_ratio = _check_dq_rounding(q, k, v, dout, lse_p, delta_p, scale,
                                          causal, blocks, dq_c, failures,
                                          case)
            log(f"dq rounding point {case}: mean error to the {dtype_name}-dS "
                f"version over that to the fp32-dS one {dq_ratio:.4f} (must "
                f"be <= {ROUNDING_RATIO})")
        if CASES.index(case) < TIMED_CASES:
            timed = _time_main_case(case, q, k, v, dout, out_p, lse_p,
                                    delta_p, blocks, errs, card)
            results = results or timed
    if failures:
        raise AssertionError("kernel check failed:\n" + "\n".join(failures))
    return results


def _time_main_case(case, q, k, v, dout, out, lse, delta, blocks, errs,
                    card):
    import torch
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import flash_attention as fa

    b, s, h, kvh, d, dtype_name, causal = case
    scale = d ** -0.5
    kernel_fns = {
        "flash_attention.fwd": lambda: fa.fwd_cuda(q, k, v, scale, causal),
        "flash_attention.bwd_dq": lambda: fa.bwd_dq_cuda(
            q, k, v, out, dout, lse, scale, causal),
        "flash_attention.bwd_dkv": lambda: fa.bwd_dkv_cuda(
            q, k, v, dout, lse, delta, scale, causal),
    }
    plain_fns = {
        "flash_attention.fwd": lambda: fa.fwd_plain(q, k, v, scale, causal,
                                                    *blocks),
        "flash_attention.bwd_dq": lambda: fa.bwd_dq_plain(
            q, k, v, dout, lse, delta, scale, causal, *blocks),
        "flash_attention.bwd_dkv": lambda: fa.bwd_dkv_plain(
            q, k, v, dout, lse, delta, scale, causal, *blocks),
    }
    # the yardstick: one library call on the same inputs, [b, h, s, d]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in
                  (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=kvh != h)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dt)

    # each time twice: on the device alone, and per call with the
    # host's launch path inside (median_ms's two readings)
    sdpa_fwd = median_ms(sdpa, 20)
    sdpa_both = median_ms(sdpa_fwd_bwd, 20)
    sdpa_bwd = sdpa_both - sdpa_fwd
    sdpa_fwd_call = median_ms(sdpa, 20, device_only=False)
    sdpa_bwd_call = median_ms(sdpa_fwd_bwd, 20,
                              device_only=False) - sdpa_fwd_call
    log(f"sdpa yardstick {case}: fwd {sdpa_fwd:.4f} ms, fwd+bwd "
        f"{sdpa_both:.4f} ms, bwd {sdpa_bwd:.4f} ms on the device; per "
        f"call fwd {sdpa_fwd_call:.4f} ms, bwd {sdpa_bwd_call:.4f} ms "
        f"[{card}]")
    bounds = bounds_ms(*case)
    results = {}
    for name in kernel_fns:
        ms = median_ms(kernel_fns[name], 20)
        call = median_ms(kernel_fns[name], 20, device_only=False)
        plain = median_ms(plain_fns[name], 3, warmup=1)
        bound, bound_by = bounds[name]
        fwd = name == "flash_attention.fwd"
        results[name] = dict(
            max_abs_err=errs[name], ms=ms, call_ms=call, plain_ms=plain,
            bound_ms=bound, bound_by=bound_by,
            library_ms=sdpa_fwd if fwd else None,
            library_call_ms=sdpa_fwd_call if fwd else None,
        )
        log(f"kernel {name} {case}: {ms:.4f} ms on the device, {call:.4f} "
            f"ms per call, bound {bound:.4f} ms ({bound_by}), plain "
            f"{plain:.4f} ms"
            + (f", sdpa fwd {sdpa_fwd:.4f} ms on the device, "
               f"{sdpa_fwd_call:.4f} ms per call" if fwd else "")
            + f" [{card}]")
    pair = (results["flash_attention.bwd_dq"]["ms"]
            + results["flash_attention.bwd_dkv"]["ms"])
    pair_bound = (bounds["flash_attention.bwd_dq"][0]
                  + bounds["flash_attention.bwd_dkv"][0])
    pair_call = (results["flash_attention.bwd_dq"]["call_ms"]
                 + results["flash_attention.bwd_dkv"]["call_ms"])
    log(f"backward pair {case}: dQ + dK/dV {pair:.4f} ms on the device, "
        f"{pair_call:.4f} ms per call, bound {pair_bound:.4f} ms, sdpa bwd "
        f"(fwd+bwd - fwd) {sdpa_bwd:.4f} ms on the device, "
        f"{sdpa_bwd_call:.4f} ms per call; (dQ + dK/dV) / sdpa bwd "
        f"{pair / sdpa_bwd:.4f} on the device, {pair_call / sdpa_bwd_call:.4f} "
        f"per call [{card}]")
    return results


def phase_flash_repairs(card: str):
    """The wrapper's repairs on the card: every head_dim and fp16
    through the kernels (padded to 64, 128 or 256 on the way in; 320
    and 512 on the wide kernels), forward and backward through
    autograd, held to the plain version at TOL with one launch of each
    kernel a case.  Then times, beside their bounds: fp16 against bf16
    at GPT-2 small's training shape (the kernels alone), head_dim 80
    (padded to 128) against 128, 256 (the FMA kernels) and 320 and 512
    (the wide kernels) through the wrapper, forward and forward +
    backward; and each kernel at 320 and 512 alone (``time_wide``)."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    failures = []
    b, s, h, kvh = PAD_SHAPE
    for d in PAD_DIMS:
        for dtype_name in ("bfloat16", "float16"):
            for causal in (True, False):
                case = (b, s, h, kvh, d, dtype_name, causal)
                dtype = getattr(torch, dtype_name)
                tol = TOL[dtype_name]
                q, k, v, dout = (
                    torch.randn(b, s, n, d, generator=gen, device="cuda")
                    .to(dtype) for n in (h, kvh, kvh, h))
                xs = [x.clone().requires_grad_() for x in (q, k, v)]
                fa.reset_launch_counts()
                out = fa.flash_attention(*xs, causal=causal)
                out.backward(dout)
                torch.cuda.synchronize()
                if fa.LAUNCHES != {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}:
                    failures.append(f"{case}: launches {fa.LAUNCHES}")
                scale, blk = d ** -0.5, fa._fit_block(s, 128)
                out_p, lse = fa.fwd_plain(q, k, v, scale, causal, blk, blk)
                delta = fa.delta_plain(out_p, dout)
                want = [out_p, fa.bwd_dq_plain(q, k, v, dout, lse, delta,
                                               scale, causal, blk, blk)]
                want += fa.bwd_dkv_plain(q, k, v, dout, lse, delta, scale,
                                         causal, blk, blk)
                errs = [_check(n, g, w, tol["atol"], tol["rtol"], failures,
                               case)
                        for n, g, w in zip(("out", "dq", "dk", "dv"),
                                           [out] + [x.grad for x in xs],
                                           want)]
                log(f"flash repair {case} (kernel head_dim "
                    f"{fa.kernel_head_dim(d)}): max_abs_err out "
                    f"{errs[0]:.3e}, dq {errs[1]:.3e}, dk {errs[2]:.3e}, dv "
                    f"{errs[3]:.3e} (tolerance {tol['atol']})")
    if failures:
        raise AssertionError("flash repair check failed:\n"
                             + "\n".join(failures))

    # fp16 against bf16 at GPT-2 small's training shape, kernels alone
    b, s, h, d = 8, SMALL_SEQ, 12, 64
    for dtype_name in ("bfloat16", "float16"):
        dtype = getattr(torch, dtype_name)
        q, k, v, dout = (torch.randn(b, s, h, d, generator=gen,
                                     device="cuda").to(dtype)
                         for _ in range(4))
        scale = d ** -0.5
        out, lse = fa.fwd_cuda(q, k, v, scale, True)
        _, delta = fa.bwd_dq_cuda(q, k, v, out, dout, lse, scale, True)
        bounds = bounds_ms(b, s, h, h, d, dtype_name, True)
        times = {
            "flash_attention.fwd": median_ms(
                lambda: fa.fwd_cuda(q, k, v, scale, True), 20),
            "flash_attention.bwd_dq": median_ms(
                lambda: fa.bwd_dq_cuda(q, k, v, out, dout, lse, scale,
                                       True), 20),
            "flash_attention.bwd_dkv": median_ms(
                lambda: fa.bwd_dkv_cuda(q, k, v, dout, lse, delta, scale,
                                        True), 20),
        }
        log(f"flash {dtype_name} at {(b, s, h, d)} causal: " + ", ".join(
            f"{n} {t:.4f} ms (bound {bounds[n][0]:.4f} ms)"
            for n, t in times.items()) + f" on the device [{card}]")

    # head_dim 80 (padded to 128) against 128, through the wrapper, 256
    # on the FMA kernels, and 320 and 512 on the wide kernels
    for d in (80, 128, 256) + WIDE_DIMS:
        q, k, v, dout = (torch.randn(b, s, h, d, generator=gen,
                                     device="cuda").to(torch.bfloat16)
                         for _ in range(4))
        xs = [x.requires_grad_() for x in (q, k, v)]

        def fwd():
            return fa.flash_attention(*xs)

        def fwd_bwd():
            torch.autograd.grad(fa.flash_attention(*xs), xs, dout)

        bounds = bounds_ms(b, s, h, h, d, "bfloat16", True)
        fb_bound = sum(t for t, _ in bounds.values())
        log(f"flash wrapper bf16 head_dim {d} (kernel "
            f"{fa.kernel_head_dim(d)}) at {(b, s, h)} causal: forward "
            f"{median_ms(fwd, 20):.4f} ms (bound "
            f"{bounds['flash_attention.fwd'][0]:.4f} ms at the true d), "
            f"forward + backward {median_ms(fwd_bwd, 20):.4f} ms (bound "
            f"{fb_bound:.4f} ms) on the device [{card}]")


def time_wide(card: str) -> dict:
    """The wide kernels (head_dim 320 and 512, bf16, causal) at GPT-2
    small's training shape (b 8, s 1024, h 12), each alone on the device
    beside its bound, its plain version and SDPA's call (forward, and
    forward + backward less forward, where SDPA takes the head_dim);
    ``{d: {kernel: {"ms", "bound_ms", "plain_ms"}, "sdpa_fwd_ms",
    "sdpa_bwd_ms"}}``."""
    import torch
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, s, h = 8, SMALL_SEQ, 12
    out_all = {}
    for d in WIDE_DIMS:
        q, k, v, dout = (torch.randn(b, s, h, d, generator=gen,
                                     device="cuda").to(torch.bfloat16)
                         for _ in range(4))
        scale = d ** -0.5
        out, lse = fa.fwd_cuda(q, k, v, scale, True)
        _, delta = fa.bwd_dq_cuda(q, k, v, out, dout, lse, scale, True)
        bounds = bounds_ms(b, s, h, h, d, "bfloat16", True)
        blk = fa._fit_block(s, 128)
        rec = {
            "flash_attention.fwd": (
                lambda: fa.fwd_cuda(q, k, v, scale, True),
                lambda: fa.fwd_plain(q, k, v, scale, True, blk, blk)),
            "flash_attention.bwd_dq": (
                lambda: fa.bwd_dq_cuda(q, k, v, out, dout, lse, scale, True),
                lambda: fa.bwd_dq_plain(q, k, v, dout, lse, delta, scale,
                                        True, blk, blk)),
            "flash_attention.bwd_dkv": (
                lambda: fa.bwd_dkv_cuda(q, k, v, dout, lse, delta, scale,
                                        True),
                lambda: fa.bwd_dkv_plain(q, k, v, dout, lse, delta, scale,
                                         True, blk, blk)),
        }
        res = {}
        for name, (kern, plain) in rec.items():
            res[name] = {"ms": median_ms(kern, 10),
                         "bound_ms": bounds[name][0],
                         "bound_by": bounds[name][1],
                         "plain_ms": median_ms(plain, 2, warmup=1)}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        try:
            sd_f = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 10)
            xs = [x.detach().requires_grad_() for x in (qt, kt, vt)]
            do_t = dout.transpose(1, 2)
            sd_fb = median_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*xs, is_causal=True), xs,
                do_t), 10)
            res["sdpa_fwd_ms"], res["sdpa_bwd_ms"] = sd_f, sd_fb - sd_f
        except RuntimeError as e:  # no SDPA backend takes this head_dim
            res["sdpa_fwd_ms"] = res["sdpa_bwd_ms"] = None
            log(f"sdpa at head_dim {d}: {str(e).splitlines()[0]}")
        out_all[d] = res
        log(f"flash wide head_dim {d} at {(b, s, h)} bf16 causal: " + ", ".join(
            f"{n} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms)"
            for n, r in res.items() if isinstance(r, dict))
            + f"; sdpa fwd {res['sdpa_fwd_ms']} ms, bwd {res['sdpa_bwd_ms']} "
            f"ms on the device [{card}]")
    return out_all


def _quant_inputs(gen, numel, block, dtype, qmax):
    """A leaf of ``numel`` elements in ``dtype`` with row 1 all zero and
    row 2 of exact .5 ties (absmax qmax * 2^-10 gives the scale 2^-10;
    the other elements are odd multiples of half of it)."""
    import torch

    x = torch.randn(numel, generator=gen, device="cuda") * 0.01
    if numel >= 3 * block:
        x[block:2 * block] = 0.0
        k = torch.arange(block, device="cuda") % int(qmax)
        sign = torch.where(torch.arange(block, device="cuda") % 3 == 0,
                           -1.0, 1.0)
        x[2 * block:3 * block] = sign * (k + 0.5) * TIE_SCALE
        x[2 * block] = qmax * TIE_SCALE
    return x.to(dtype)


def _mismatch(name, got, want, failures, case):
    """Count of differing elements and their largest difference; the
    tolerance is QUANT_TOL mismatches."""
    diff = got.float() != want.float()
    n = int(diff.sum())
    err = (got.float() - want.float()).abs().max().item() if n else 0.0
    if n > QUANT_TOL:
        failures.append(f"{case} {name}: {n} of {got.numel()} differ, "
                        f"largest by {err:.3e}")
    return n, err


def phase_quant_kernels(card: str):
    import torch

    from dlrover_tpu_torch.ops import quantization as qz

    gen = torch.Generator(device="cuda").manual_seed(1)
    failures = []
    results = {}
    bc1, bc2 = qz.bias_corrections(QADAM_HYPER["b1"], QADAM_HYPER["b2"], 3)
    for case in QUANT_CASES:
        leaf, numel, block, dtype_name, qmax = case
        dtype = getattr(torch, dtype_name)
        x = _quant_inputs(gen, numel, block, dtype, qmax)
        errs = {}
        codes, scales = qz.quantize_cuda(x, block, qmax)
        want = qz.quantize_plain(qz.to_block_tiles(x, block), qmax)
        n1, e1 = _mismatch("codes", codes, want[0], failures, case)
        n2, e2 = _mismatch("scales", scales, want[1], failures, case)
        if numel >= 3 * block and scales[2, 0].item() != TIE_SCALE:
            failures.append(f"{case}: the tie row's scale is "
                            f"{scales[2, 0].item()}, not 2^-10")
        errs["quantization.quantize"] = (n1 + n2, max(e1, e2))
        deq = qz.dequantize_cuda(codes, scales, (numel,))
        errs["quantization.dequantize"] = _mismatch(
            "dequantized", deq,
            qz.dequantize_plain(codes, scales).reshape(-1)[:numel],
            failures, case)
        rows = codes.shape[0]
        if qmax == 127.0:
            g = (torch.randn(numel, generator=gen, device="cuda")
                 * 1e-3).to(dtype)
            p = (torch.randn(numel, generator=gen, device="cuda")
                 * 0.02).to(dtype)
            if numel >= 2 * block:
                g[block:2 * block] = 0.0
                p[block:2 * block] = 0.0
            qm, ms = qz.quantize_plain(torch.randn(
                rows, block, generator=gen, device="cuda") * 1e-4)
            qn, ns = qz.quantize_plain(torch.randn(
                rows, block, generator=gen, device="cuda").abs() * 1e-3)
            qm[1:2], qn[1:2] = 0, 0
            upd, *new = qz.fused_qadam_step_plain(
                qz.to_block_tiles(g, block), qz.to_block_tiles(p, block), qm,
                ms, qn, ns, bc1, bc2, out_dtype=dtype, **QADAM_HYPER)
            want_p = p + upd.reshape(-1)[:numel]
            state = [t.clone() for t in (qm, ms, qn, ns)]
            got_p = p.clone()
            qz.qadam_step_cuda(got_p, g, *state, bc1=bc1, bc2=bc2,
                               **QADAM_HYPER)
            outs = [_mismatch("p", got_p, want_p, failures, case)]
            outs += [_mismatch(n, s, w, failures, case) for n, s, w in zip(
                ("mu codes", "mu scales", "nu codes", "nu scales"), state,
                new)]
            errs["quantization.qadam"] = (sum(o[0] for o in outs),
                                          max(o[1] for o in outs))
        torch.cuda.synchronize()
        log(f"quant kernel check {case}: " + ", ".join(
            f"{n} {m} mismatches (largest {e:.3e})"
            for n, (m, e) in errs.items())
            + f" (tolerance {QUANT_TOL} mismatches)")
        if case is QUANT_CASES[0]:
            results = _time_quant_case(case, x, codes, scales, g, p, qm, ms,
                                       qn, ns, bc1, bc2, errs, card)
        elif block > REG_BLOCK and dtype_name == "bfloat16":
            # the two-pass kernels beside their bounds
            _time_quant_case(case, x, codes, scales, g, p, qm, ms, qn, ns,
                             bc1, bc2, errs, card)
        elif leaf == QUANT_CASES[0][0]:
            # the same leaf in fp32: 1.6x the bytes of the bf16 step, and
            # the same arithmetic; the two times say which one binds
            state = [t.clone() for t in (qm, ms, qn, ns)]
            pc = p.clone()
            ms_k = median_ms(lambda: qz.qadam_step_cuda(
                pc, g, *state, bc1=bc1, bc2=bc2, **QADAM_HYPER), 20)
            bound, _ = quant_bounds_ms(numel, rows, block,
                                       dtype_name)["quantization.qadam"]
            log(f"kernel quantization.qadam {leaf} [{rows}, {block}] "
                f"{dtype_name}: {ms_k:.4f} ms on the device, bound "
                f"{bound:.4f} ms (bytes) [{card}]")
    if failures:
        raise AssertionError("quantization kernel check failed:\n"
                             + "\n".join(failures))
    _time_quant_8b(card)
    results.update(_check_split_kernels(card))
    return results


# Llama-3-8B's largest leaf, ``lm_head`` [128256, 4096], in the optimizer's
# rows of DEFAULT_BLOCK: the shape of q-AdamW's init launches of B4 (each
# moment starts as fp32 zeros and is quantized once), and of B5 where a
# 4-bit plan would dequantize it
LM_HEAD_8B = 128256 * 4096


def _time_quant_8b(card: str):
    """B4 on fp32 zeros of the 8B ``lm_head`` (the init's input, checked
    against the plain version with zero mismatches), then B5 on its
    codes, each beside its bound and its plain version; B5's yardstick
    ``torch.mul(q, scales)`` on the same codes."""
    import torch

    from dlrover_tpu_torch.ops import quantization as qz

    block = qz.DEFAULT_BLOCK
    x = torch.zeros(LM_HEAD_8B, dtype=torch.float32, device="cuda")
    codes, scales = qz.quantize_cuda(x, block, 127.0)
    want = qz.quantize_plain(qz.to_block_tiles(x, block), 127.0)
    failures = []
    _mismatch("codes", codes, want[0], failures, "8B lm_head")
    _mismatch("scales", scales, want[1], failures, "8B lm_head")
    del want
    if failures:
        raise AssertionError("; ".join(failures))
    rows = codes.shape[0]
    bounds = quant_bounds_ms(LM_HEAD_8B, rows, block, "float32")
    tiles = qz.to_block_tiles(x, block)
    for name, fn, plain in (
            ("quantization.quantize",
             lambda: qz.quantize_cuda(x, block, 127.0),
             lambda: qz.quantize_plain(tiles, 127.0)),
            ("quantization.dequantize",
             lambda: qz.dequantize_cuda(codes, scales, (LM_HEAD_8B,)),
             lambda: qz.dequantize_plain(codes, scales))):
        ms_k = median_ms(fn, 10)
        call = median_ms(fn, 10, device_only=False)
        plain_ms = median_ms(plain, 5)
        bound, bound_by = bounds[name]
        log(f"kernel {name} Llama-3-8B lm_head [{rows}, {block}] fp32 "
            f"(the optimizer's init input): {ms_k:.4f} ms on the device, "
            f"{call:.4f} ms per call, bound {bound:.4f} ms ({bound_by}), "
            f"plain {plain_ms:.4f} ms [{card}]")
    # B5's yardstick, a PyTorch call the port never makes
    lib = median_ms(lambda: torch.mul(codes, scales), 10)
    lib_call = median_ms(lambda: torch.mul(codes, scales), 10,
                         device_only=False)
    log(f"library quantization.dequantize torch.mul(q, scales) Llama-3-8B "
        f"lm_head [{rows}, {block}]: {lib:.4f} ms on the device, "
        f"{lib_call:.4f} ms per call [{card}]")
    del x, codes, scales, tiles


# the split-block mode: (case, global shape, the rank's box, dtype of p
# and g, block); Llama-3-8B's leaves under tensor 4 first (a column-
# parallel rank's columns of each row are a run of pieces, 1024 of 4096
# columns a half block, lm_head's 32064 of 128256 ~16 blocks), the timed
# case its lm_head; an fsdp 2 x tensor 2 box at a ragged shape; 14a's
# case, a one-rank FSDP2 shard (the whole tensor, pieces = blocks)
SPLIT_CASES = [
    ("8B lm_head, tensor 4, rank 1", (4096, 128256), ((0, 4096),
                                                     (32064, 64128)),
     "bfloat16", 2048),
    ("8B q_proj, tensor 4, rank 1", (4096, 4096), ((0, 4096), (1024, 2048)),
     "bfloat16", 2048),
    ("ragged, fsdp 2 x tensor 2, rank 3", (1000, 777),
     ((500, 1000), (389, 777)), "float32", 64),
    ("8B down, FSDP2 on one rank", (14336, 4096), ((0, 14336), (0, 4096)),
     "bfloat16", 2048),
]
# fp32 operations per element of each split-block launch
SPLIT_OPS = {"quantization.absmax_pieces": 2,
             "quantization.quantize_pieces": 6,
             "quantization.dequantize_pieces": 1,
             "quantization.qadam_split_absmax": 25,
             "quantization.qadam_split_apply": 31}


def split_bounds_ms(numel, rows, esz):
    """Least time of each split-block launch on a shard of ``numel``
    elements touching ``rows`` global blocks: every input read once and
    every output written once (x, p and g in ``esz`` bytes, the 4-bit
    path's moments in fp32; int8 codes; fp32 scales and maxima)."""
    work = {
        "quantization.absmax_pieces": numel * 4 + rows * 4,
        "quantization.quantize_pieces": numel * 4 + rows * 4 + numel
        + rows * 4,
        "quantization.dequantize_pieces": numel + rows * 4 + numel * 4,
        "quantization.qadam_split_absmax": numel * (2 * esz + 2)
        + rows * 8 + rows * 8,
        "quantization.qadam_split_apply": numel * (3 * esz + 4) + rows * 24,
    }
    return {name: _bound(nbytes, SPLIT_OPS[name] * numel, "float32")
            for name, nbytes in work.items()}


def _check_split_kernels(card: str) -> dict:
    """The split-block mode of B4, B5 and B6 against its plain versions
    on one rank's shard of each ``SPLIT_CASES`` leaf (the rank's partial
    maxima, as a rank computes them before the max all-reduce): codes,
    scales, maxima, dequantized values and the new parameter, zero
    mismatches; each launch timed at the first case beside its bound
    and its plain version (no library call computes them)."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.ops import quantization as qz
    from dlrover_tpu_torch.optim.low_bit import box_pieces

    gen = torch.Generator(device="cuda").manual_seed(2)
    bc1, bc2 = qz.bias_corrections(QADAM_HYPER["b1"], QADAM_HYPER["b2"], 3)
    failures, results = [], {}
    for case in SPLIT_CASES:
        label, shape, box, dtype_name, block = case
        dtype = getattr(torch, dtype_name)
        table, blocks, starts = box_pieces(shape, box, block)
        numel = int(np.prod([b - a for a, b in box]))
        layout = qz.PieceLayout(table, numel, len(blocks))
        rows = layout.elem_rows().cuda()
        n_rows = layout.rows
        p = (torch.randn(numel, generator=gen, device="cuda")
             * 0.02).to(dtype)
        g = (torch.randn(numel, generator=gen, device="cuda")
             * 1e-3).to(dtype)
        m = torch.randn(numel, generator=gen, device="cuda") * 1e-4
        v = torch.randn(numel, generator=gen, device="cuda").abs() * 1e-3
        errs = {}
        # B4 split: the partial absmax, then codes and scales from it
        amax = qz.absmax_pieces(m, layout)
        want_amax = qz.piece_absmax_plain(m, rows, n_rows)
        errs["quantization.absmax_pieces"] = _mismatch(
            "absmax", amax, want_amax, failures, label)
        q_mu, s_mu = qz.quantize_pieces(m, layout, amax)
        want = qz.piece_quantize_plain(m, rows, want_amax)
        n1, e1 = _mismatch("codes", q_mu, want[0], failures, label)
        n2, e2 = _mismatch("scales", s_mu, want[1], failures, label)
        errs["quantization.quantize_pieces"] = (n1 + n2, max(e1, e2))
        nu_amax = qz.absmax_pieces(v, layout)
        q_nu, s_nu = qz.quantize_pieces(v, layout, nu_amax)
        # B5 split
        errs["quantization.dequantize_pieces"] = _mismatch(
            "dequantized", qz.dequantize_pieces(q_mu, s_mu, layout),
            qz.piece_dequantize_plain(q_mu, s_mu, rows), failures, label)
        # B6 split: both launches against the plain arithmetic
        state = [q_mu.clone(), s_mu.clone(), q_nu.clone(), s_nu.clone()]
        moments = qz.qadam_split_absmax(p, g, *state, layout, bc1, bc2,
                                        **QADAM_HYPER)
        mu, nsq, upd = qz.qadam_split_plain(p, g, q_mu, s_mu, q_nu, s_nu,
                                            rows, bc1, bc2, **QADAM_HYPER)
        want_m = torch.stack([qz.piece_absmax_plain(mu, rows, n_rows),
                              qz.piece_absmax_plain(nsq, rows, n_rows)], 1)
        errs["quantization.qadam_split_absmax"] = _mismatch(
            "moment maxima", moments, want_m, failures, label)
        got_p = p.clone()
        new_mu, new_nu = qz.qadam_split_apply(got_p, g, *state, layout,
                                              moments, bc1, bc2,
                                              **QADAM_HYPER)
        want_qm, want_sm = qz.piece_quantize_plain(mu, rows, want_m[:, 0])
        want_qn, want_sn = qz.piece_quantize_plain(nsq, rows, want_m[:, 1])
        outs = [_mismatch(n, a, b, failures, label) for n, a, b in (
            ("p", got_p, p + upd), ("mu codes", state[0], want_qm),
            ("mu scales", new_mu, want_sm), ("nu codes", state[2], want_qn),
            ("nu scales", new_nu, want_sn))]
        errs["quantization.qadam_split_apply"] = (
            sum(o[0] for o in outs), max(o[1] for o in outs))
        torch.cuda.synchronize()
        log(f"split-block kernel check {label} {shape} box {box} "
            f"{dtype_name} block {block} ({len(table)} pieces, {n_rows} "
            "rows): " + ", ".join(f"{n} {k} mismatches (largest {e:.3e})"
                                  for n, (k, e) in errs.items())
            + f" (tolerance {QUANT_TOL} mismatches)")
        if case is not SPLIT_CASES[0]:
            continue
        esz = 2 if dtype_name == "bfloat16" else 4
        bounds = split_bounds_ms(numel, n_rows, esz)
        st2 = [t.clone() for t in state]
        pc = p.clone()
        fns = {
            "quantization.absmax_pieces": (
                lambda: qz.absmax_pieces(m, layout),
                lambda: qz.piece_absmax_plain(m, rows, n_rows)),
            "quantization.quantize_pieces": (
                lambda: qz.quantize_pieces(m, layout, amax),
                lambda: qz.piece_quantize_plain(m, rows, amax)),
            "quantization.dequantize_pieces": (
                lambda: qz.dequantize_pieces(q_mu, s_mu, layout),
                lambda: qz.piece_dequantize_plain(q_mu, s_mu, rows)),
            "quantization.qadam_split_absmax": (
                lambda: qz.qadam_split_absmax(pc, g, *st2, layout, bc1, bc2,
                                              **QADAM_HYPER),
                lambda: qz.qadam_split_plain(pc, g, *st2, rows, bc1, bc2,
                                             **QADAM_HYPER)),
            # the codes it rewrites change the next call's input, not
            # its work
            "quantization.qadam_split_apply": (
                lambda: qz.qadam_split_apply(pc, g, *st2, layout, moments,
                                             bc1, bc2, **QADAM_HYPER),
                lambda: qz.qadam_split_plain(pc, g, *st2, rows, bc1, bc2,
                                             **QADAM_HYPER)),
        }
        for name, (fn, plain) in fns.items():
            ms_k = median_ms(fn, 20)
            call = median_ms(fn, 20, device_only=False)
            plain_ms = median_ms(plain, 5, warmup=1)
            bound, bound_by = bounds[name]
            results[name] = dict(
                max_abs_err=errs[name][1], ms=ms_k, call_ms=call,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None, library_call_ms=None)
            log(f"kernel {name} {label} {shape} box {box} {dtype_name}: "
                f"{ms_k:.4f} ms on the device, {call:.4f} ms per call, "
                f"bound {bound:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms"
                f" [{card}]")
    if failures:
        raise AssertionError("split-block kernel check failed:\n"
                             + "\n".join(failures))
    return results


def _time_quant_case(case, x, codes, scales, g, p, qm, ms, qn, ns, bc1, bc2,
                     errs, card):
    import torch

    from dlrover_tpu_torch.ops import quantization as qz

    leaf, numel, block, dtype_name, qmax = case
    rows = codes.shape[0]
    state = [t.clone() for t in (qm, ms, qn, ns)]
    pc = p.clone()
    kernel_fns = {
        "quantization.quantize": lambda: qz.quantize_cuda(x, block, qmax),
        "quantization.dequantize": lambda: qz.dequantize_cuda(
            codes, scales, (numel,)),
        "quantization.qadam": lambda: qz.qadam_step_cuda(
            pc, g, *state, bc1=bc1, bc2=bc2, **QADAM_HYPER),
    }

    def plain_qadam():
        upd, *_ = qz.fused_qadam_step_plain(
            qz.to_block_tiles(g, block), qz.to_block_tiles(p, block), qm, ms,
            qn, ns, bc1, bc2, out_dtype=p.dtype, **QADAM_HYPER)
        return p + upd.reshape(-1)[:numel]

    plain_fns = {
        "quantization.quantize": lambda: qz.quantize_plain(
            qz.to_block_tiles(x, block), qmax),
        "quantization.dequantize": lambda: qz.dequantize_plain(
            codes, scales).reshape(-1)[:numel],
        "quantization.qadam": plain_qadam,
    }
    # the yardstick for dequantize: int8 x fp32 promotes in one kernel
    library = median_ms(lambda: torch.mul(codes, scales), 20)
    library_call = median_ms(lambda: torch.mul(codes, scales), 20,
                             device_only=False)
    bounds = quant_bounds_ms(numel, rows, block, dtype_name)
    results = {}
    for name in kernel_fns:
        ms_k = median_ms(kernel_fns[name], 20)
        call = median_ms(kernel_fns[name], 20, device_only=False)
        plain = median_ms(plain_fns[name], 5, warmup=1)
        bound, bound_by = bounds[name]
        deq = name == "quantization.dequantize"
        results[name] = dict(
            max_abs_err=errs[name][1], ms=ms_k, call_ms=call, plain_ms=plain,
            bound_ms=bound, bound_by=bound_by,
            library_ms=library if deq else None,
            library_call_ms=library_call if deq else None,
        )
        log(f"kernel {name} {leaf} [{rows}, {block}] {dtype_name}: "
            f"{ms_k:.4f} ms on the device, {call:.4f} ms per call, bound "
            f"{bound:.4f} ms ({bound_by}), plain {plain:.4f} ms"
            + (f", torch.mul {library:.4f} ms on the device, "
               f"{library_call:.4f} ms per call" if deq else "")
            + f" [{card}]")
    return results


# phase 4: ||got - plain|| / ||plain|| of the flash model's logits and of
# each gradient against the plain-attention model's.  bf16: in each of
# the two layers the paths round differently four times (P before the
# PV product, the attention output, dS before dQ and dK, the dQ/dK/dV
# outputs), each by at most bf16's unit roundoff 2^-8: 8 * 2^-8 if they
# all added up.  fp32 differs only by the order of the sums.
MODEL_REL_NORM = {"float32": 1e-5, "bfloat16": 8 * 2.0 ** -8}
# the elementwise check's atol (unchanged since slice 1), fatal for fp32
# and for the bf16 gradients.  The bf16 logits are reported against it
# and held by the norm: with the embeddings drawn as flax draws them
# (ROADMAP C 5) the logits are larger, and their bf16 error with them
MODEL_ATOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _zero_head(attn_fn, head: int):
    """``attn_fn`` with one head's output ([b, s, h, d]) zeroed: the
    fault planted in phase 4's flash model."""
    import torch

    def faulty(q, k, v, **kw):
        out = attn_fn(q, k, v, **kw)
        keep = torch.ones(out.shape[2], dtype=out.dtype, device=out.device)
        keep[head] = 0
        return out * keep.view(1, 1, -1, 1)
    return faulty


def phase_model_check():
    """A small GPT with head_dim 64 on the card: the flash model
    against the plain-attention model from the same weights, logits and
    every gradient, elementwise and by the norm of the error; a flash
    model with one head of its first layer zeroed must fail the norm."""
    import torch

    from dlrover_tpu_torch.models.gpt import (
        GPT,
        GPTConfig,
        cross_entropy_loss,
    )

    tokens = torch.randint(0, 512, (2, 201), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    x, y = tokens[:, :-1], tokens[:, 1:]

    def run(impl, dtype, planted=False):
        cfg = GPTConfig.tiny(vocab_size=512, max_seq_len=200,
                             num_heads=2, hidden_dim=128,
                             attention_impl=impl, dtype=dtype)
        model = GPT(cfg, device="cuda", seed=3)
        if planted:
            attn = model.blocks[0].attn
            attn._attn = _zero_head(attn._attn, 0)
        logits = model(x)
        cross_entropy_loss(logits, y).backward()
        return logits, {n: p.grad for n, p in model.named_parameters()}

    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        atol, rel = MODEL_ATOL[name], MODEL_REL_NORM[name]
        (lx, gx), (lf, gf) = run("xla", dtype), run("flash", dtype)
        if lf.shape != (2, 200, 512) or not bool(torch.isfinite(lf).all()):
            raise AssertionError(f"flash GPT logits {lf.shape} not finite")
        pairs = [("logits", lf, lx)] + [(n, gf[n], gx[n]) for n in gx]
        err = max((g.float() - w.float()).abs().max().item()
                  for _, g, w in pairs[:1])
        gerr = max((g.float() - w.float()).abs().max().item()
                   for _, g, w in pairs[1:])
        norms = {n: _rel_norm(g, w) for n, g, w in pairs}
        worst = max(norms, key=norms.get)
        beyond = [n for n, g, w in pairs
                  if not bool(((g.float() - w.float()).abs() <= atol).all())]
        log(f"model check {name}: logits max_abs_err {err:.3e}, grads "
            f"max_abs_err {gerr:.3e} (atol {atol}); ||got - plain|| / "
            f"||plain|| logits {norms['logits']:.3e}, largest {worst} "
            f"{norms[worst]:.3e} (limit {rel:.4e}); beyond the atol: "
            f"{beyond}")
        for n, got, want in pairs:
            _check_norm(n, got, want, rel, failures, f"model {name}")
        held_by_norm = ["logits"] if dtype == torch.bfloat16 else []
        for n in beyond:
            if n not in held_by_norm:
                failures.append(f"model {name} {n}: beyond the atol {atol}")
        if dtype == torch.bfloat16:
            lp, gp = run("flash", dtype, planted=True)
            planted = {"logits": _rel_norm(lp, lx)}
            planted.update({n: _rel_norm(gp[n], gx[n]) for n in gx})
            caught = [n for n, v in planted.items() if v > rel]
            log(f"model check bf16, head 0 of layer 0 zeroed in the flash "
                f"model: logits {planted['logits']:.3e}, largest "
                f"{max(planted.values()):.3e}; {len(caught)} of "
                f"{len(planted)} fail the norm (limit {rel:.4e})")
            if "logits" not in caught:
                failures.append("the planted fault passes the logits' "
                                "norm check")
    if failures:
        raise AssertionError("flash GPT disagrees with plain GPT: "
                             + "; ".join(failures))


def _loss_fn(module, batch):
    from dlrover_tpu_torch.models.gpt import cross_entropy_loss

    return cross_entropy_loss(module(batch["x"]), batch["y"])


def _wait_committed(out: str, step: int, timeout: float = COMMIT_TIMEOUT_S):
    """Seconds until the tracker file in ``out`` names ``step``."""
    from dlrover_tpu_torch.common.constants import CheckpointConstant

    tracker = os.path.join(out, CheckpointConstant.TRACKER_FILE)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        try:
            with open(tracker) as f:
                if f.read().strip() == str(step):
                    return time.perf_counter() - t0
        except FileNotFoundError:
            pass
        time.sleep(0.005)
    raise AssertionError(f"checkpoint step {step} not committed in {out} "
                         f"within {timeout:.0f} s")


def _unlink_segments():
    """Unlink this run's shm segments (``DLROVER_JOB_NAME`` is the
    run's own); returns the names it unlinked."""
    prefix = f"dlrover_tpu_ckpt_shm_{os.environ['DLROVER_JOB_NAME']}_"
    names = [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]
    for name in names:
        os.unlink(os.path.join("/dev/shm", name))
    return names


@contextmanager
def checkpoint_scope(label: str):
    """A checkpoint directory of one run under ``chip_smoke_out``; on
    exit, failure included, the in-process saver is stopped, the shm
    segment unlinked and the directory removed."""
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    out = os.path.join(OUT_DIR, f"ckpt_{label}")
    shutil.rmtree(out, ignore_errors=True)
    try:
        yield out
    finally:
        saver = AsyncCheckpointSaver.get_ckpt_saver()
        AsyncCheckpointSaver.stop_all()
        if saver is not None:
            # a persist in flight ends before its directory goes
            saver._event_thread.join(timeout=COMMIT_TIMEOUT_S)
        _unlink_segments()
        shutil.rmtree(out, ignore_errors=True)


def run_training(label, cfg, global_batch, micro, steps, expected, card,
                 optim_factory=None, strategy=None, loss_fn=_loss_fn,
                 save_final=True):
    """Train ``cfg`` (a GPT or a Llama config) from seed 0 on one fixed
    batch of random tokens through ``Trainer.train()``, with every
    launch count set to 0 just before and read just after; check the
    losses, the exact launch counts (``expected``), the train_step
    events and the metrics file.  The Trainer's final checkpoint goes to
    a directory of the run, which is removed once the save is committed
    (with ``save_final`` off, this Trainer's saves write nothing: a run
    that keeps no state).  The model is
    built on the card and handed to the Trainer, which holds the only
    reference to it, so a plan that rebuilds it frees it.
    Returns ``(trainer, result, counts)``."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.gpt import GPT, count_params
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_tpu_torch.telemetry.events import read_events
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    t0 = time.perf_counter()
    model = (Llama if isinstance(cfg, LlamaConfig) else GPT)(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = count_params(model)
    # the table that is only looked up: GPT's positions (its tied wte is
    # the head too), Llama's wte (its head is lm_head)
    lookup = (model.wpe if hasattr(model, "wpe") else model.wte)
    lookup = lookup.weight.numel()
    log(f"{label}: {n_params} params, {cfg.num_layers} layers, "
        f"d {cfg.hidden_dim}, dtype {cfg.dtype}, params {cfg.param_dtype}, "
        f"remat {cfg.remat}, attention {cfg.attention_impl}, built on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    seq = cfg.max_seq_len
    # one global batch of random tokens from a seed, cycled: the loss
    # falls as the model fits it
    data = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (global_batch, seq + 1), dtype=np.int32)
    train_data = [{"x": data[:, :-1], "y": data[:, 1:]}]
    with checkpoint_scope(label.replace(" ", "_")) as out:
        args = TrainingArguments(
            output_dir=out, resume_from_checkpoint=False, max_steps=steps,
            global_batch_size=global_batch, micro_batch_size=micro,
            logging_steps=1, strategy=strategy, learning_rate=SMALL_LR)
        trainer = Trainer(model, args, train_data, loss_fn,
                          optim_factory=optim_factory)
        if not save_final:
            trainer._save = lambda step, to_storage: None
        del model
        if os.path.exists(os.environ["DLROVER_EVENT_LOG"]):
            os.unlink(os.environ["DLROVER_EVENT_LOG"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        result = trainer.train()
        counts = launch_counts()
        if save_final:
            # train() reads its training peak before the final save,
            # whose snapshot copies the state on the card
            peak_ckpt = torch.cuda.max_memory_allocated()
            commit_s = _wait_committed(out, steps)
    if save_final:
        log(f"{label}: final checkpoint committed {commit_s:.3f} s after "
            f"train() returned; peak memory with its snapshot "
            f"{peak_ckpt / 2**30:.2f} GiB [{card}]")

    losses = result["losses"]
    log(f"{label}: losses {losses}")
    log(f"{label}: launches {counts}, expected {expected}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    if counts != expected:
        raise AssertionError(f"{label}: launch counts {counts} != {expected}")
    events = [e for e in read_events(os.environ["DLROVER_EVENT_LOG"])
              if e.get("type") == "train_step"]
    if len(events) != steps or events[-1].get("step") != steps:
        raise AssertionError(f"{label}: {len(events)} train_step events, "
                             f"not {steps}")
    with open(os.environ["DLROVER_METRICS_FILE"]) as f:
        if json.load(f)["global_step"] != steps:
            raise AssertionError(f"{label}: the metrics file does not hold "
                                 "the last step")
    step_s = statistics.median(result["step_seconds"][2:])
    tokens = global_batch * seq
    # model FLOPs: 6 per weight per token (a head included, a table that
    # is only looked up not) plus causal attention, 6 L s d per token;
    # the remat recompute is not counted
    flops = 6 * tokens * (n_params - lookup
                          + cfg.num_layers * seq * cfg.hidden_dim)
    log(f"{label}: median step {step_s * 1e3:.3f} ms over steps 3..{steps}, "
        f"{tokens / step_s:.1f} tokens/s, model FLOPs utilisation "
        f"{flops / step_s / PEAK_FLOPS['bfloat16']:.4f} of 989 TFLOP/s "
        f"({flops:.4e} FLOPs a step), step times "
        f"{[round(t * 1e3, 3) for t in result['step_seconds']]} ms, peak "
        f"memory {result['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    return trainer, result, counts


def _zero_counts(**nonzero):
    counts = {name: 0 for name in KERNELS}
    counts.update(nonzero)
    return counts


def phase_train_small_adamw(card):
    from dlrover_tpu_torch.models.gpt import GPTConfig

    steps, global_batch, micro = 6, 32, 8
    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash")
    per_step = cfg.num_layers * (global_batch // micro)
    expected = _zero_counts(**{
        "flash_attention.fwd": per_step * steps,
        "flash_attention.bwd_dq": per_step * steps,
        "flash_attention.bwd_dkv": per_step * steps,
    })
    trainer, result, counts = run_training(
        "train GPT-2 small AdamW", cfg, global_batch, micro, steps, expected,
        card)
    SMALL_ADAMW["tokens_s"] = (global_batch * SMALL_SEQ
                               / statistics.median(result["step_seconds"][2:]))
    profile_step(trainer, trainer.train_data[0], card, "GPT-2 small AdamW")
    return counts


def phase_small_lr(card):
    """``--only 5lr``, which the full run leaves out: phase 5a's GPT-2
    small for 8 steps at the Trainer's default AdamW (lr 1e-3, as the
    reference's) through the flash kernels and through the plain
    attention math, and at SMALL_LR through the flash kernels: whether a
    loss that climbs is the kernels' doing or the learning rate's."""
    import numpy as np

    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    data = np.random.default_rng(0).integers(
        0, 50257, (32, SMALL_SEQ + 1), dtype=np.int32)
    train_data = [{"x": data[:, :-1], "y": data[:, 1:]}]
    curves = {}
    for impl, lr in (("flash", 1e-3), ("xla", 1e-3), ("flash", SMALL_LR)):
        cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ,
                                   attention_impl=impl)
        with checkpoint_scope(f"lr_{impl}_{lr}") as out:
            args = TrainingArguments(
                output_dir=out, resume_from_checkpoint=False, max_steps=8,
                global_batch_size=32, micro_batch_size=8, logging_steps=1,
                learning_rate=lr)
            trainer = Trainer(GPT(cfg, seed=0), args, train_data, _loss_fn)
            trainer._save = lambda step, to_storage: None
            curves[(impl, lr)] = trainer.train()["losses"]
        del trainer
        _free_cuda()
        log(f"5lr GPT-2 small, attention {impl}, AdamW lr {lr}: losses "
            f"{[round(x, 6) for x in curves[(impl, lr)]]} [{card}]")
    flash, plain = curves[("flash", 1e-3)], curves[("xla", 1e-3)]
    rel = [abs(a - b) / abs(b) for a, b in zip(flash, plain)]
    log(f"5lr: lr 1e-3, flash against plain attention, relative difference "
        f"a step {[f'{r:.2e}' for r in rel]}")
    if not all(np.isfinite(sum(curves.values(), []))):
        raise AssertionError(f"5lr: non-finite loss: {curves}")


def phase_train_xl(card):
    """GPT-2 XL with int8 q-AdamW moments: the twin of
    ``examples/train_xl_lowmem.py`` through the port's Trainer."""
    import torch

    from dlrover_tpu_torch.models.gpt import GPTConfig
    from dlrover_tpu_torch.optim import q_adamw

    cfg = GPTConfig.gpt2_xl(attention_impl="flash", remat=True,
                            param_dtype=torch.bfloat16)
    n_params = 12 * cfg.num_layers + 4  # per block 12; wte, wpe, ln_f
    steps = XL_STEPS
    expected = _zero_counts(**{
        # remat runs every block's forward twice
        "flash_attention.fwd": 2 * cfg.num_layers * steps,
        "flash_attention.bwd_dq": cfg.num_layers * steps,
        "flash_attention.bwd_dkv": cfg.num_layers * steps,
        # mu and nu codes of every parameter at init
        "quantization.quantize": 2 * n_params,
        # one launch a step for the one parameter group, bf16 weights
        # and fp32 layernorms alike
        "quantization.qadam": steps,
    })
    trainer, result, counts = run_training(
        "train GPT-2 XL int8 q-AdamW", cfg, XL_BATCH, XL_BATCH, steps,
        expected, card,
        optim_factory=lambda ps: q_adamw(ps, lr=3e-4, weight_decay=0.1))
    XL_BF16["ms"] = statistics.median(result["step_seconds"][2:]) * 1e3
    opt = trainer.state.optimizer
    _check_multi_against_per_leaf(opt, card)
    _report_qadam(trainer, result, n_params, "train GPT-2 XL int8 q-AdamW",
                  card)
    profile_step(trainer, trainer.train_data[0], card, "GPT-2 XL int8 q-AdamW")
    # 18b runs here, on 5b's model and state: no second XL model
    t0 = time.perf_counter()
    phase_save_attn(trainer, card, XL_BF16["ms"], result["peak_bytes"])
    log(f"chip_smoke: phase 18b took {time.perf_counter() - t0:.1f} s")
    return counts


def _report_qadam(trainer, result, n_params, label, card):
    """The int8 q-AdamW run's peak memory and the moments' share of it;
    then the optimizer alone, on the gradients of the last step: the
    host's time to queue it, the wall to its end (synchronised), and
    its time on the device with the card held until the host has queued
    it, beside the fused step's summed bound."""
    import torch

    from dlrover_tpu_torch.ops import quantization as qz

    opt = trainer.state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    if len(params) != n_params:
        raise AssertionError(f"{len(params)} parameters, not {n_params}")
    peak = result["peak_bytes"]
    moment_bytes = sum(t.numel() * t.element_size()
                       for st in opt.state.values() for t in st.values()
                       if torch.is_tensor(t))
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    log(f"{label}: peak memory {peak / 2**30:.2f} GiB, moment state (int8 "
        f"codes + fp32 scales) {moment_bytes / 2**30:.3f} GiB = "
        f"{moment_bytes / peak:.4f} of the peak, params "
        f"{param_bytes / 2**30:.3f} GiB [{card}]")
    bound = sum(qadam_bytes(p.numel(), opt.block_size, p.element_size())
                for p in params)
    hosts, walls = [], []
    launches = qz.LAUNCHES["qadam"]
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        hosts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = (qz.LAUNCHES["qadam"] - launches) // len(walls)
    device = median_ms(opt.step, 3, warmup=0, sleep_cycles=OPT_SLEEP_CYCLES)
    elements = sum(p.numel() for p in params)
    log(f"{label}: optimizer step host {statistics.median(hosts):.3f} ms "
        f"to queue, wall {statistics.median(walls):.3f} ms to its end, "
        f"device {device:.3f} ms ({launches} fused launch(es) a step over "
        f"{n_params} parameters, {elements} elements), summed bound of the "
        f"fused step {bound / 1e9:.3f} GB / 3.35 TB/s = "
        f"{bound / PEAK_BYTES_S * 1e3:.3f} ms [{card}]")
    return {"peak": peak, "moment_bytes": moment_bytes, "device_ms": device,
            "bound_ms": bound / PEAK_BYTES_S * 1e3}


def _check_multi_against_per_leaf(opt, card):
    """The optimizer's one launch over all its leaves against the plain
    step of each leaf and against one launch per leaf, from the same
    parameters, gradients and state: zero mismatches in p, codes and
    scales."""
    import torch

    from dlrover_tpu_torch.ops import quantization as qz

    keys = ("mu_values", "mu_scales", "nu_values", "nu_scales")
    group, = opt.param_groups
    params = [p for p in group["params"] if p.grad is not None]
    before = [(p.detach().clone(), [opt.state[p][k].clone() for k in keys])
              for p in params]
    launches = qz.LAUNCHES["qadam"]
    opt.step()
    multi = qz.LAUNCHES["qadam"] - launches
    hyper = dict(b1=group["b1"], b2=group["b2"], eps=group["eps"],
                 lr=group["lr"], wd=group["weight_decay"])
    failures, n_plain, n_leaf, elements = [], 0, 0, 0
    for p, (pc, state) in zip(params, before):
        bc1, bc2 = qz.bias_corrections(hyper["b1"], hyper["b2"],
                                       opt.state[p]["step"])
        block = state[0].shape[1]
        upd, *plain = qz.fused_qadam_step_plain(
            qz.to_block_tiles(p.grad, block), qz.to_block_tiles(pc, block),
            *state, bc1, bc2, out_dtype=p.dtype, **hyper)
        want_p = pc + upd.reshape(-1)[:p.numel()].reshape(p.shape)
        case = ("plain", tuple(p.shape))
        outs = [_mismatch("p", p, want_p, failures, case)]
        outs += [_mismatch(k, opt.state[p][k], want, failures, case)
                 for k, want in zip(keys, plain)]
        n_plain += sum(o[0] for o in outs)
        del upd, plain, want_p
        qz.qadam_step_cuda(pc, p.grad, *state, bc1=bc1, bc2=bc2, **hyper)
        case = ("per-leaf launch", tuple(p.shape))
        outs = [_mismatch("p", pc, p, failures, case)]
        outs += [_mismatch(k, got, opt.state[p][k], failures, case)
                 for k, got in zip(keys, state)]
        n_leaf += sum(o[0] for o in outs)
        elements += p.numel()
    torch.cuda.synchronize()
    log(f"train GPT-2 XL int8 q-AdamW: {multi} multi-tensor launch(es) over "
        f"{len(params)} leaves ({elements} elements): {n_plain} mismatches "
        f"in p, codes and scales against the plain step of each leaf, "
        f"{n_leaf} against {len(params)} per-leaf launches (tolerance "
        f"{QUANT_TOL}) [{card}]")
    if multi != 1 or failures:
        raise AssertionError(f"multi-tensor q-AdamW: {multi} launches, "
                             + "; ".join(failures[:10]))


def phase_train_small_4bit(card):
    """GPT-2 small with 4-bit q-AdamW: the path that launches the
    dequantize kernel, and quantize at qmax 7, once per parameter per
    step (the 4-bit nu codec is plain tensor ops)."""
    from dlrover_tpu_torch.models.gpt import GPTConfig
    from dlrover_tpu_torch.optim import q_adamw

    steps, batch = 6, 8
    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash")
    n_params = 12 * cfg.num_layers + 4
    expected = _zero_counts(**{
        "flash_attention.fwd": cfg.num_layers * steps,
        "flash_attention.bwd_dq": cfg.num_layers * steps,
        "flash_attention.bwd_dkv": cfg.num_layers * steps,
        "quantization.quantize": n_params * (steps + 1),
        "quantization.dequantize": n_params * steps,
    })
    _, _, counts = run_training(
        "train GPT-2 small 4-bit q-AdamW", cfg, batch, batch, steps, expected,
        card, optim_factory=lambda ps: q_adamw(ps, lr=SMALL_LR, bits=4))
    return counts


# -- phase 6: flash checkpoint ------------------------------------------------


def _leaf_bytes(t):
    import torch

    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _cat_bytes(leaves, out):
    """``out[:] = torch.cat`` of the leaves' bytes, in groups of at most
    1 GiB: over the whole XL state (6.2 GB), one ``torch.cat`` and a
    ``copy_`` per leaf both held the host until the card was idle
    (H100), grouped ``torch.cat`` calls did not."""
    import torch

    lo, group, size = 0, [], 0
    for t in [_leaf_bytes(t) for t in leaves] + [None]:
        if group and (t is None or size + t.numel() > 2**30):
            torch.cat(group, out=out[lo:lo + size])
            lo, group, size = lo + size, [], 0
        if t is not None:
            group.append(t)
            size += t.numel()


def _digests(model) -> dict:
    """sha256 of every parameter's bytes, by name."""
    import hashlib

    return {name: hashlib.sha256(
        _leaf_bytes(p).cpu().numpy().tobytes()).hexdigest()
        for name, p in model.named_parameters()}


def _small_trainer(out: str, max_steps: int):
    """The GPT-2 small AdamW Trainer of phase 6a, from seed 0, on the
    card, saving every 2 steps into ``out`` and resuming from it."""
    import numpy as np

    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash")
    data = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (32, SMALL_SEQ + 1), dtype=np.int32)
    args = TrainingArguments(
        output_dir=out, max_steps=max_steps, global_batch_size=32,
        micro_batch_size=8, logging_steps=1, save_steps=2,
        learning_rate=SMALL_LR)
    return Trainer(GPT(cfg, seed=0), args,
                   [{"x": data[:, :-1], "y": data[:, 1:]}], _loss_fn)


def ckpt_child(role: str, out: str, result_path: str,
               log_path: str = "") -> int:
    """One incarnation of phase 6a's trainer, in a process of its own.

    ``kill``: 4 steps from scratch, then SIGKILL without closing
    anything.  ``resume``: resume at step 4 (no step taken: the params
    as restored), then a second Trainer resumes again and takes steps 5
    and 6.  ``storage``: resume at step 6 from storage.  Writes what it
    saw to ``result_path`` as JSON before it ends; its output goes to
    ``log_path`` (a child forked from the template shares the
    template's standard streams)."""
    if log_path:
        fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        os.close(fd)
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"role": role}
    if role == "resume":
        trainer = _small_trainer(out, CKPT_KILL_STEP)
        trainer.train()
        result["restored"] = _digests(trainer.model)
        result["restore"] = trainer.last_restore_phases
        del trainer
    steps = CKPT_KILL_STEP if role == "kill" else CKPT_STEPS
    trainer = _small_trainer(out, steps)
    reset_launch_counts()
    run = trainer.train()
    torch.cuda.synchronize()
    result.update(
        counts=launch_counts(), steps=run["steps"], losses=run["losses"],
        digests=_digests(trainer.model),
        save=trainer._checkpointer.engine.last_save_phases,
        snapshot=trainer._checkpointer.engine.last_snapshot_phases)
    result.setdefault("restore", trainer.last_restore_phases)
    with open(result_path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(result_path + ".tmp", result_path)
    if role == "kill":
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGKILL)
    return 0


# the warm template phase 6a's children fork from: the launcher's fork
# server over its trainer preload and the Trainer
CKPT_FORK = {}


def _ckpt_fork_server():
    """Phase 6a's fork server, its template started on first use
    (``run_phases`` starts it right after the build); it imports and
    never touches CUDA, so every forked child makes its own context."""
    if "server" not in CKPT_FORK:
        from dlrover_tpu_torch.agent.forkserver import (
            TRAINER_PRELOAD,
            WorkerForkServer,
        )

        server = WorkerForkServer(
            preload=TRAINER_PRELOAD + ",dlrover_tpu_torch.trainer.trainer")
        server._ensure_template()
        CKPT_FORK["server"] = server
    return CKPT_FORK["server"]


def _run_child(role: str, out: str, restart_count: int) -> dict:
    path = os.path.join(OUT_DIR, f"ckpt_child_{role}.json")
    log_path = os.path.join(OUT_DIR, f"ckpt_child_{role}.log")
    if os.path.exists(path):
        os.unlink(path)
    env = dict(os.environ, DLROVER_RESTART_COUNT=str(restart_count),
               PYTHONPATH=ROOT,
               DLROVER_EVENT_LOG=os.path.join(
                   OUT_DIR, f"ckpt_child_{role}_events.jsonl"),
               DLROVER_METRICS_FILE=os.path.join(
                   OUT_DIR, f"ckpt_child_{role}_metrics.json"))
    t0 = time.perf_counter()
    child = _ckpt_fork_server().spawn(
        [os.path.abspath(__file__), "--ckpt-child", role, out, path,
         log_path], env, timeout=300)
    code = child.wait(timeout=600)
    seconds = time.perf_counter() - t0
    want = -signal.SIGKILL if role == "kill" else 0
    if code != want or not os.path.exists(path):
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"checkpoint child {role} ended with "
                             f"{code}, not {want}:\n{tail}")
    with open(path) as f:
        result = json.load(f)
    result["seconds"] = seconds
    return result


def phase_ckpt_small(card) -> dict:
    """6a: GPT-2 small crash and resume through ``Trainer`` with this
    process in the agent's role.  Returns the launch counts of the
    paths that launch kernels."""
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash")
    per_step = cfg.num_layers * 4  # 4 micro-batches a step
    label = "flash ckpt GPT-2 small"
    with checkpoint_scope("gpt2_small_resume") as out:
        AsyncCheckpointSaver.start_async_saving_ckpt()
        killed = _run_child("kill", out, 0)
        commit_s = _wait_committed(out, CKPT_KILL_STEP)
        resumed = _run_child("resume", out, 1)
        failures = []
        if resumed["restore"].get("tier") != "shm":
            failures.append(f"child 2 restored from "
                            f"{resumed['restore'].get('tier')}, not shm")
        if resumed["restored"] != killed["digests"]:
            bad = [n for n in killed["digests"]
                   if resumed["restored"].get(n) != killed["digests"][n]]
            failures.append(f"{len(bad)} params differ from child 1's at "
                            f"step 4: {bad[:5]}")
        losses = resumed["losses"]
        if resumed["steps"] != CKPT_STEPS or len(losses) != (
                CKPT_STEPS - CKPT_KILL_STEP) or not all(
                    map(_finite, losses)):
            failures.append(f"child 2 ran to {resumed['steps']} with "
                            f"losses {losses}")
        two = (CKPT_STEPS - CKPT_KILL_STEP) * per_step
        want_resume = _zero_counts(**{f"flash_attention.{k}": two
                                      for k in ("fwd", "bwd_dq", "bwd_dkv")})
        if resumed["counts"] != want_resume:
            failures.append(f"child 2 launches {resumed['counts']} != "
                            f"{want_resume}")
        kill_n = CKPT_KILL_STEP * per_step
        want_kill = _zero_counts(**{f"flash_attention.{k}": kill_n
                                    for k in ("fwd", "bwd_dq", "bwd_dkv")})
        if killed["counts"] != want_kill:
            failures.append(f"child 1 launches {killed['counts']} != "
                            f"{want_kill}")
        _wait_committed(out, CKPT_STEPS)
        gone = _unlink_segments()
        from_storage = _run_child("storage", out, 2)
        if from_storage["restore"].get("tier") != "storage":
            failures.append(f"child 3 restored from "
                            f"{from_storage['restore'].get('tier')}, not "
                            "storage")
        if from_storage["digests"] != resumed["digests"]:
            failures.append("child 3's params differ from child 2's at "
                            "step 6")
        if from_storage["counts"] != _zero_counts():
            failures.append(f"child 3 launched {from_storage['counts']}")
        _wait_committed(out, CKPT_STEPS)
    for name, r in (("child 1 (kill at step 4)", killed),
                    ("child 2 (resume from shm)", resumed),
                    ("child 3 (resume from storage)", from_storage)):
        log(f"{label}: {name}: {r['seconds']:.1f} s, steps {r['steps']}, "
            f"losses {r['losses']}, restore {json.dumps(r['restore'])}, "
            f"last save {json.dumps(r['save'])}, snapshot "
            f"{json.dumps(r['snapshot'])} [{card}]")
    log(f"{label}: step 4 committed {commit_s:.3f} s after child 1 was "
        f"killed; unlinked {gone} before child 3; digests of "
        f"{len(killed['digests'])} params compared [{card}]")
    if failures:
        raise AssertionError(f"{label}: " + "; ".join(failures))
    return {"gpt2_small_ckpt_kill": killed["counts"],
            "gpt2_small_ckpt_resume": resumed["counts"]}


def _finite(x) -> bool:
    return x == x and abs(x) != float("inf")


def _pinned_yardstick_gbs(nbytes: int = 256 * 2**20) -> dict:
    """GB/s of one pinned ``copy_`` of 256 MB each way (median of 5,
    between CUDA events)."""
    import torch

    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    rates = {}
    for way, fn in (("d2h", lambda: host.copy_(dev, non_blocking=True)),
                    ("h2d", lambda: dev.copy_(host, non_blocking=True))):
        ms = median_ms(fn, 5, warmup=1, device_only=False)
        rates[way] = nbytes / ms / 1e6
    return rates


def _capacity(out: str) -> dict:
    st = os.statvfs("/dev/shm")
    with open("/proc/meminfo") as f:
        mem = {line.split(":")[0]: int(line.split()[1]) * 1024
               for line in f}
    return {"shm_free": st.f_bavail * st.f_frsize,
            "shm_size": st.f_blocks * st.f_frsize,
            "mem_available": mem["MemAvailable"],
            "mem_total": mem["MemTotal"],
            "disk_free": shutil.disk_usage(os.path.dirname(out)).free}


def phase_ckpt_xl(card) -> dict:
    """6b: GPT-2 XL int8 q-AdamW, the torn-snapshot check on the whole
    state.  Returns the launch counts of the path."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.checkpoint.checkpointer import (
        Checkpointer,
        StorageType,
        restore_to_template,
    )
    from dlrover_tpu_torch.checkpoint.restore import RestoreStats
    from dlrover_tpu_torch.checkpoint.shm_handler import _flatten_state_dict
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.optim import q_adamw
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState,
        make_train_step,
        to_device,
    )
    from dlrover_tpu_torch.utils.convert import params_tree, qadamw_state_tree

    label = "flash ckpt GPT-2 XL int8 q-AdamW"
    # two training steps, then B6 twice more on step 2's gradients: the
    # third update is queued before the save and must reach it, the
    # fourth right after it and must not
    train_steps, save_step = 2, 3
    yard = _pinned_yardstick_gbs()
    with checkpoint_scope("gpt2_xl_torn") as out:
        cfg = GPTConfig.gpt2_xl(attention_impl="flash", remat=True,
                                param_dtype=torch.bfloat16)
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (XL_BATCH, cfg.max_seq_len + 1),
            dtype=np.int32)
        batch = to_device({"x": tokens[:, :-1], "y": tokens[:, 1:]},
                          torch.device("cuda"))
        reset_launch_counts()
        model = GPT(cfg, seed=0)
        opt = q_adamw(model.parameters(), lr=3e-4, weight_decay=0.1)
        train_step = make_train_step(_loss_fn, opt)
        state = TrainState.create(model, opt)
        for _ in range(train_steps):
            state, _ = train_step(state, batch)
        tree = {"params": params_tree(model),
                "opt_state": qadamw_state_tree(opt, model)}
        flat = _flatten_state_dict(tree)
        nbytes = sum(t.numel() * t.element_size() for t in flat.values())
        cap = _capacity(out)
        log(f"{label}: state {nbytes} bytes in {len(flat)} leaves; "
            f"/dev/shm {cap['shm_free']} of {cap['shm_size']} bytes free, "
            f"MemAvailable {cap['mem_available']} of {cap['mem_total']}, "
            f"disk free {cap['disk_free']} [{card}]")
        # shm holds one copy; host RAM the segment, the reference copy,
        # the saver's private copy and a restored copy
        if (cap["shm_free"] < 1.2 * nbytes
                or cap["mem_available"] < 4 * nbytes + 8 * 2**30
                or cap["disk_free"] < 2 * nbytes):
            raise AssertionError(f"{label}: the state does not fit with "
                                 f"room to spare: {nbytes} bytes, {cap}")
        ckpt = Checkpointer(out)
        engine = ckpt.engine

        def finish(step, t0):
            """Wait for the save of ``step`` queued at host time ``t0``;
            its numbers."""
            if not ckpt.wait(600):
                raise AssertionError(f"{label}: the snapshot write timed "
                                     "out")
            shm_s = time.perf_counter() - t0
            if engine._last_async_error is not None:
                raise AssertionError(f"{label}: snapshot write failed: "
                                     f"{engine._last_async_error!r}")
            persist_s = _wait_committed(out, step) + shm_s
            return {"shm_s": shm_s, "persist_s": persist_s,
                    "snap": dict(engine.last_snapshot_phases),
                    "save": dict(engine.last_save_phases)}

        # A first save of the state at step 2 sets up what a save uses
        # once (the segment, the pinned staging buffers, the writer
        # thread, the snapshot stream's block of memory): allocating
        # pinned or device memory can wait for the card, and would end
        # the race below before it ran.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not ckpt.save_checkpoint(train_steps, tree,
                                    storage_type=StorageType.DISK):
            raise AssertionError(f"{label}: save_checkpoint refused")
        first = {"stall_s": time.perf_counter() - t0, **finish(train_steps,
                                                               t0)}
        # The race runs on a stream of high priority that a sleep kernel
        # holds while the host queues it: B6 (update 3), the reference
        # copy of the state in stream order, the save, and B6 (update
        # 4) at once.  Without the snapshot's wait for this stream its
        # copy reads update 2; without this stream's wait for the copy,
        # update 4 is dispatched ahead of the copy's remaining blocks.
        # The reference's buffer, the copy kernel and the streams are
        # set up before the sleep, so that nothing in the race waits
        # for the card.
        race = torch.cuda.Stream(priority=-1)
        race.wait_stream(torch.cuda.current_stream())
        card_dev = model.wte.weight.device
        on_card = [t for t in flat.values() if t.device == card_dev]
        with torch.cuda.stream(race):
            ref_dev = torch.empty(sum(t.numel() * t.element_size()
                                      for t in on_card),
                                  dtype=torch.uint8, device=card_dev)
            torch.cat([_leaf_bytes(t)[:1] for t in on_card[:2]])
        torch.cuda.synchronize()
        marks = []

        def mark(what):
            marks.append(f"{what} {time.perf_counter() - t0:.3f} s "
                         f"{'sleeping' if not slept.query() else 'awake'}")

        with torch.cuda.stream(race):
            t0 = time.perf_counter()
            torch.cuda._sleep(RACE_SLEEP_CYCLES)
            slept = torch.cuda.Event()
            slept.record()
            opt.step()
            mark("update 3")
            # the count moves on with the update; the tensors are the
            # same, so the tree is built again on the host alone
            tree = {"params": params_tree(model),
                    "opt_state": qadamw_state_tree(opt, model)}
            flat = _flatten_state_dict(tree)
            _cat_bytes([t for t in flat.values() if t.device == card_dev],
                       ref_dev)
            ready = torch.cuda.Event()
            ready.record()
            mark("reference")
            t1 = time.perf_counter()
            if not ckpt.save_checkpoint(save_step, tree,
                                        storage_type=StorageType.DISK):
                raise AssertionError(f"{label}: save_checkpoint refused")
            stall_s = time.perf_counter() - t1
            mark("save")
            opt.step()
            mark("update 4")
            raced = not slept.query()
        torch.cuda.current_stream().wait_stream(race)
        if not raced:
            raise AssertionError(f"{label}: the sleep ended before the host "
                                 f"had queued the race: it was not run "
                                 f"({'; '.join(marks)})")
        log(f"{label}: race queued while the card slept: {'; '.join(marks)}")
        # the snapshot's copy starts on the card once the reference is
        # taken: the save's times run from there
        ready.synchronize()
        second = {"stall_s": stall_s, **finish(save_step,
                                                time.perf_counter())}
        torch.cuda.synchronize()
        counts = launch_counts()
        ref_host, reference, offset = ref_dev.cpu(), {}, 0
        del ref_dev
        for k, t in flat.items():
            if t.device != card_dev:
                reference[k] = _leaf_bytes(t).clone()
                continue
            n = t.numel() * t.element_size()
            reference[k] = ref_host[offset:offset + n]
            offset += n
        changed = sum(not torch.equal(_leaf_bytes(t).cpu(), reference[k])
                      for k, t in list(flat.items())[:8])
        restores = {}
        for tier in ("shm", "storage"):
            stats = RestoreStats()
            if tier == "shm":
                step, restored = ckpt.load_checkpoint()
            else:
                _unlink_segments()
                step, restored = engine.load_from_storage()
            phases = dict(engine.last_restore_phases)
            if step != save_step or phases.get("tier") != tier:
                raise AssertionError(f"{label}: restored step {step} from "
                                     f"{phases.get('tier')}, not "
                                     f"{save_step} from {tier}")
            got = _flatten_state_dict(restored)
            bad = [k for k in reference
                   if k not in got or not torch.equal(
                       _leaf_bytes(got[k]), reference[k])]
            if bad or len(got) != len(reference):
                raise AssertionError(f"{label}: {len(bad)} leaves restored "
                                     f"from {tier} differ from the state at "
                                     f"the save: {bad[:5]}")
            restore_to_template(tree, restored, stats=stats)
            phases["h2d_s"] = stats.h2d_s
            restores[tier] = phases
            del restored, got
        ckpt.close()
    bound_ms = 2 * nbytes / PEAK_BYTES_S * 1e3
    for which, r in (("first save (step 2, sets up)", first),
                     (f"raced save (update {save_step}; the writer's "
                      f"waits include the sleep)", second)):
        snap, save = r["snap"], r["save"]
        d2h_gbs = save["d2h_bytes"] / save["d2h_device_s"] / 1e9
        log(f"{label}: {which}: save_checkpoint stall "
            f"{r['stall_s'] * 1e3:.3f} ms on the host, snapshot copy "
            f"{snap['device_s'] * 1e3:.3f} ms on the device "
            f"({snap['bytes']} bytes), bound 2 x bytes / 3.35 TB/s = "
            f"{bound_ms:.3f} ms (bytes) [{card}]")
        log(f"{label}: {which}: D2H {save['d2h_bytes']} bytes in "
            f"{save['d2h_device_s']:.4f} s on the device = {d2h_gbs:.2f} "
            f"GB/s, pinned 256 MB copy_ {yard['d2h']:.2f} GB/s (bound "
            f"{save['d2h_bytes'] / yard['d2h'] / 1e6:.1f} ms); host waited "
            f"{save['fetch_s']:.4f} s on it [{card}]")
        log(f"{label}: {which}: shm write {save['bytes']} bytes, host "
            f"copies {save['memcpy_s']:.4f} s = "
            f"{save['bytes'] / save['memcpy_s'] / 1e9:.2f} GB/s, whole shm "
            f"save {save['total_s']:.4f} s (lock {save['lock_wait_s']:.4f} "
            f"s); {r['shm_s']:.3f} s to the snapshot in shm, persist "
            f"{r['persist_s']:.3f} s to the tracker's commit, both from the "
            f"call (first save) or from the copy's start on the card "
            f"(raced save) [{card}]")
    for tier, ph in restores.items():
        log(f"{label}: restore from {tier}: read {ph['read_s']:.4f} s, "
            f"assemble {ph['assemble_s']:.4f} s "
            f"({ph['bytes'] / max(ph['assemble_s'], 1e-9) / 1e9:.2f} GB/s, "
            f"{ph['workers']} workers), h2d {ph['h2d_s']:.4f} s "
            f"({ph['bytes'] / ph['h2d_s'] / 1e9:.2f} GB/s; pinned 256 MB "
            f"copy_ {yard['h2d']:.2f} GB/s, bound "
            f"{ph['bytes'] / yard['h2d'] / 1e6:.1f} ms) [{card}]")
    log(f"{label}: update {save_step} queued before the save and update "
        f"{save_step + 1} at once after it, both while a sleep held the "
        f"stream; {changed} of the first 8 leaves changed by update "
        f"{save_step + 1}; shm and storage restores bit-equal to the state "
        f"at update {save_step} [{card}]")
    n_params = 12 * cfg.num_layers + 4
    want = _zero_counts(**{
        "flash_attention.fwd": 2 * cfg.num_layers * train_steps,
        "flash_attention.bwd_dq": cfg.num_layers * train_steps,
        "flash_attention.bwd_dkv": cfg.num_layers * train_steps,
        "quantization.quantize": 2 * n_params,
        "quantization.qadam": save_step + 1,
    })
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} != {want}")
    if changed == 0:
        raise AssertionError(f"{label}: update {save_step + 1} changed none "
                             "of the first 8 leaves: the race was not run")
    return {"gpt2_xl_ckpt_torn": counts}


# phase 7: steps of GPT-2 small with the monitor attached; the master's
# running speed against the trainer's over the steps the master saw
CP_STEPS = 8
CP_SPEED_RTOL = 0.10
CP_MONITOR_INTERVAL_S = 0.02
CP_HEARTBEAT_INTERVAL_S = 0.2
CP_SERVE_TIMEOUT_S = 60.0
CP_RTT_REPS = 200
# tokens/s of phase 5a, which phase 7 repeats with the monitor attached
SMALL_ADAMW = {}


def _metrics_values(port: int) -> dict:
    """The master's own ``/metrics``: ``{family: value}`` of the
    unlabelled samples."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    values = {}
    for line in text.splitlines():
        if line and not line.startswith("#") and "{" not in line:
            name, _, value = line.partition(" ")
            values[name] = float(value.split()[0])
    return values


def _cuda_holders() -> dict:
    """pids with a CUDA context by ``nvidia-smi --query-compute-apps``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return {int(x) for x in out.split() if x.strip().isdigit()}


def _maps_cuda(pid: int) -> list:
    """The CUDA driver and runtime libraries mapped into ``pid``: a
    process that made a CUDA context has libcuda mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if "libcuda" in line or "libnvidia" in line
                       or "libcudart" in line})


class _Master:
    """``python -m dlrover_tpu_torch.master.main`` as a child process on
    ``port`` for one node, with its journal and event log under
    ``chip_smoke_out`` and its ``/metrics`` on ``metrics_port``."""

    def __init__(self, port, metrics_port, journal_dir, label):
        self.port, self.metrics_port = port, metrics_port
        self.journal_dir, self.label = journal_dir, label
        self.proc = None

    def start(self) -> float:
        """Seconds from the spawn until the master answers an RPC."""
        from dlrover_tpu_torch.common import messages as msg
        from dlrover_tpu_torch.common.comm import MessageClient

        env = dict(os.environ, PYTHONPATH=ROOT,
                   DLROVER_MASTER_JOURNAL_DIR=self.journal_dir,
                   DLROVER_METRICS_PORT=str(self.metrics_port),
                   DLROVER_EVENT_LOG=os.path.join(
                       OUT_DIR, "control_plane_master_events.jsonl"))
        logf = open(os.path.join(OUT_DIR, f"master_{self.label}.log"), "w")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.master.main",
             "--port", str(self.port), "--node_num", "1", "--job_name",
             os.environ["DLROVER_JOB_NAME"]],
            cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
        logf.close()
        probe = MessageClient(f"127.0.0.1:{self.port}", node_id=-1,
                              node_type="probe", timeout=2.0, retries=1)
        try:
            while True:
                if self.proc.poll() is not None:
                    raise AssertionError(
                        f"master ({self.label}) exited with "
                        f"{self.proc.returncode} before serving")
                try:
                    probe.get(msg.NumNodesWaitingRequest(
                        rdzv_name="elastic-training"))
                    return time.perf_counter() - t0
                except (ConnectionError, OSError):
                    if time.perf_counter() - t0 > CP_SERVE_TIMEOUT_S:
                        raise AssertionError(
                            f"master ({self.label}) not serving within "
                            f"{CP_SERVE_TIMEOUT_S:.0f} s")
                    time.sleep(0.01)
        finally:
            probe.close()

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        if self.proc is not None:
            self.proc.wait(timeout=30)


@contextmanager
def _reporting(client):
    """A ``TrainingMonitor`` on the metrics file and a
    ``HeartbeatReporter``, both on ``client``, for the block's run."""
    from dlrover_tpu_torch.agent.monitor import (
        HeartbeatReporter,
        TrainingMonitor,
    )

    monitor = TrainingMonitor(os.environ["DLROVER_METRICS_FILE"],
                              interval=CP_MONITOR_INTERVAL_S, client=client)
    beat = HeartbeatReporter(interval=CP_HEARTBEAT_INTERVAL_S, client=client)
    monitor.start()
    beat.start()
    try:
        yield
    finally:
        for m in (monitor, beat):
            m.stop()
            m._thread.join(timeout=30)


def phase_control_plane(card) -> dict:
    """Slice 3b.1 on the card machine: the port's master as a child
    process, a port ``MasterClient`` in this process joining its
    rendezvous, and ``TrainingMonitor`` + ``HeartbeatReporter``
    reporting while GPT-2 small trains on the card through ``Trainer``
    with flash attention.  The master's global step and running speed
    are read from its own ``/metrics``; then it is SIGKILLed and
    restarted on the same journal directory, and the restarted master
    must replay the rendezvous round and node and take the step back
    from the client's next report.  The master must never hold a CUDA
    context, and no child may outlive the phase.  The step's tokens/s
    is taken in five runs of the same 8 steps: one before the master
    starts, then monitored, bare, bare, monitored."""
    import torch.distributed as dist

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.comm import find_free_port
    from dlrover_tpu_torch.models.gpt import GPTConfig

    journal = os.path.join(OUT_DIR, "control_plane_journal")
    shutil.rmtree(journal, ignore_errors=True)
    port, metrics_port = find_free_port(), find_free_port()
    first = _Master(port, metrics_port, journal, "first")
    second = _Master(port, metrics_port, journal, "restarted")
    global_batch, micro = 32, 8
    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash")
    per_step = cfg.num_layers * (global_batch // micro) * CP_STEPS
    expected = _zero_counts(**{
        f"flash_attention.{k}": per_step
        for k in ("fwd", "bwd_dq", "bwd_dkv")})

    def train(label):
        # the last run's garbage (reference cycles) goes first, so each
        # run's peak memory is its own
        _free_cuda()
        _, result, counts = run_training(
            f"control plane GPT-2 small AdamW{label}", cfg, global_batch,
            micro, CP_STEPS, expected, card)
        steady = 1.0 / statistics.median(result["step_seconds"][2:])
        return result, counts, global_batch * SMALL_SEQ * steady

    client = None
    holders_seen, master_pids = [], []
    try:
        _, _, no_master = train(", before the master starts")
        start_s = first.start()
        master_pids.append(first.proc.pid)
        client = MasterClient(f"127.0.0.1:{port}", node_id=0,
                              node_type="worker", node_rank=0,
                              local_world_size=1)
        client.report_node_event("added", "running")
        round_ = client.join_rendezvous(0, 1, "elastic-training",
                                        "127.0.0.1")
        rdzv = client.get_comm_world("elastic-training", 0)
        log(f"control plane: master pid {first.proc.pid} serving "
            f"{start_s:.3f} s after its spawn; rendezvous round {round_}, "
            f"world {rdzv[2]}, coordinator {rdzv[3]}")
        if rdzv[0] != 1 or rdzv[2] != {0: 1}:
            raise AssertionError(f"rendezvous did not complete: {rdzv}")
        # the coordinator is the torch.distributed rendezvous address
        dist.init_process_group("gloo", init_method=f"tcp://{rdzv[3]}",
                                world_size=1, rank=0)
        dist.destroy_process_group()

        sent = []
        report = client.report_global_step

        def recorded(step, timestamp=0.0):
            sent.append((step, timestamp))
            return report(step, timestamp)

        client.report_global_step = recorded
        if os.path.exists(os.environ["DLROVER_METRICS_FILE"]):
            os.unlink(os.environ["DLROVER_METRICS_FILE"])
        holders_seen.append(_cuda_holders())
        with _reporting(client):
            result, counts, monitored = train("")
        holders_seen.append(_cuda_holders())
        mapped = {first.proc.pid: _maps_cuda(first.proc.pid)}
        client.report_global_step = report

        metrics = _metrics_values(metrics_port)
        m_step = int(metrics["dlrover_global_step"])
        m_speed = metrics["dlrover_steps_per_second"]
        seen = sorted({step for step, _ in sent})
        first_seen = seen[0]
        # the trainer's own clock over the steps the master saw
        step_times = result["step_seconds"]
        own = ((CP_STEPS - first_seen)
               / sum(step_times[first_seen:CP_STEPS]))
        log(f"control plane: master /metrics global step {m_step}, running "
            f"speed {m_speed:.4f} steps/s; the trainer's last step "
            f"{CP_STEPS}, its speed {own:.4f} steps/s over steps "
            f"{first_seen + 1}..{CP_STEPS} (the master saw steps {seen}) "
            f"(tolerance {CP_SPEED_RTOL})")
        if m_step != CP_STEPS:
            raise AssertionError(f"the master's global step {m_step} is not "
                                 f"the trainer's {CP_STEPS}")
        if abs(m_speed - own) > CP_SPEED_RTOL * own:
            raise AssertionError(f"the master's speed {m_speed} is not "
                                 f"within {CP_SPEED_RTOL} of {own}")

        # what the reporting threads cost the step, in turns with the
        # first monitored run: bare, bare, monitored
        bare = [train(", no monitor")[2] for _ in range(2)]
        with _reporting(client):
            monitored = (monitored + train("")[2]) / 2
        bare = sum(bare) / 2
        phase1 = SMALL_ADAMW["tokens_s"]
        log(f"control plane: tokens/s {monitored:.1f} with the monitor "
            f"attached, {bare:.1f} with none ({monitored / bare:.4f}; runs "
            f"in turns, two each), {no_master:.1f} before the master "
            f"started; phase 5a {phase1:.1f} ({monitored / phase1:.4f}) "
            f"[{card}]")

        rtts = []
        for _ in range(CP_RTT_REPS):
            t0 = time.perf_counter()
            client.report_global_step(CP_STEPS, time.time())
            rtts.append(time.perf_counter() - t0)
        rtt_ms = statistics.median(rtts) * 1e3
        log(f"control plane: report_global_step round trip median "
            f"{rtt_ms:.4f} ms over {CP_RTT_REPS} [{card}]")

        os.kill(first.proc.pid, signal.SIGKILL)
        first.proc.wait(timeout=30)
        restart_s = second.start()
        master_pids.append(second.proc.pid)
        t0 = time.perf_counter()
        client.report_global_step(CP_STEPS, time.time())
        reconnect_s = time.perf_counter() - t0
        after = client.get_comm_world("elastic-training", 0)
        waiting = client.num_nodes_waiting("elastic-training")
        metrics = _metrics_values(metrics_port)
        r_step = int(metrics["dlrover_global_step"])
        log(f"control plane: restarted master pid {second.proc.pid} serving "
            f"{restart_s:.3f} s after its spawn (journal replay included); "
            f"the client's next report went through in {reconnect_s:.3f} s; "
            f"round {after[0]}, world {after[2]}, waiting {waiting}, "
            f"/metrics global step {r_step} [{card}]")
        # round and world replay; each master process picks its
        # coordinator port anew, as the reference's does
        if after[:3] != rdzv[:3] or waiting != 0:
            raise AssertionError(f"restarted master's world {after} "
                                 f"(waiting {waiting}) is not {rdzv}")
        if r_step != CP_STEPS:
            raise AssertionError(f"restarted master's global step {r_step} "
                                 f"is not {CP_STEPS}")
        holders_seen.append(_cuda_holders())
        mapped[second.proc.pid] = _maps_cuda(second.proc.pid)
        me = os.getpid()
        log(f"control plane: CUDA holders by nvidia-smi {holders_seen} "
            f"(this process {me} listed: "
            f"{any(me in h for h in holders_seen)}); CUDA libraries mapped "
            f"by the masters: {mapped}")
        for pid in master_pids:
            if any(pid in h for h in holders_seen):
                raise AssertionError(f"master pid {pid} held a CUDA context")
        if any(mapped.values()):
            raise AssertionError(f"a master mapped CUDA: {mapped}")
        return {"control_plane": counts}
    finally:
        if client is not None:
            client.close()
        for m in (first, second):
            m.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        alive = [m.proc.pid for m in (first, second)
                 if m.proc is not None and m.proc.poll() is None]
        if alive:
            raise AssertionError(f"master processes left behind: {alive}")


# -- phase 9: auto_accelerate and its strategy search --------------------------


def _xl_batch(vocab, batch=XL_BATCH, seed=0):
    import numpy as np

    data = np.random.default_rng(seed).integers(
        0, vocab, (batch, SMALL_SEQ + 1), dtype=np.int32)
    return {"x": data[:, :-1], "y": data[:, 1:]}


def _flash_expected(layers, micro, steps, remat, low_bit=0, n_params=0):
    return _zero_counts(**{
        "flash_attention.fwd": (2 if remat else 1) * layers * micro * steps,
        "flash_attention.bwd_dq": layers * micro * steps,
        "flash_attention.bwd_dkv": layers * micro * steps,
        **({"quantization.quantize": 2 * n_params,
            "quantization.qadam": steps} if low_bit else {}),
    })


def _train(result, batch, steps):
    """``steps`` of an ``auto_accelerate`` result on one fixed batch:
    (losses, step seconds), each step synchronised."""
    import torch

    state, losses, secs = result.state, [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = result.train_step(state, result.place_batch(batch))
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return losses, secs


def _adamw_factory(lr=SMALL_LR, wd=1e-4):
    import torch

    return lambda ps: torch.optim.AdamW(ps, lr=lr, betas=(0.9, 0.999),
                                        eps=1e-8, weight_decay=wd)


def phase_search_xl(card) -> dict:
    """9a: ``auto_accelerate`` over GPT-2 XL at full width and depth
    (48 layers, d 1600, seq 1024, batch 4, flash attention, fp32 params)
    with the int8-optimizer opt-in, the hybrid search (the count tier
    ranks every candidate, the best two are profiled on the card); the
    chosen plan then trains 6 steps with exact launch counts."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.accel import (
        ModelContext,
        analyser,
        auto_accelerate,
        strategy_search,
    )
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = GPTConfig.gpt2_xl(attention_impl="flash")
    model = GPT(cfg, seed=0)
    n_params = 12 * cfg.num_layers + 4
    batch = _xl_batch(cfg.vocab_size)
    real_search = strategy_search.search_strategy
    found = {}

    def search(*args, **kw):
        t0 = time.perf_counter()
        result = real_search(*args, **kw)
        found["seconds"] = time.perf_counter() - t0
        # the chosen plan's build and steps are the path read below
        reset_launch_counts()
        return result

    strategy_search.search_strategy = search
    try:
        result = auto_accelerate(
            model, _adamw_factory(3e-4, 0.1), _loss_fn, batch,
            extra={"search_optimizer": True}, rank_mode="hybrid",
            profile_top_k=2)
        build_counts = launch_counts()
        losses, secs = _train(result, batch, XL_STEPS)
        counts = launch_counts()
    finally:
        strategy_search.search_strategy = real_search
    context = ModelContext(
        model=model, optim_factory=None, loss_fn=_loss_fn,
        sample_batch=batch, extra={"search_optimizer": True},
        device=torch.device("cuda"))
    unbounded = analyser.analyse(context)
    unbounded.per_device_hbm = 2 ** 62
    every = strategy_search.generate_candidates(context, 1,
                                                analysis=unbounded)
    log(f"9a search: {len(result.search.evaluated)} candidates kept of "
        f"{len(every)} (memory pruning at "
        f"{analyser._device_hbm('cuda') / 2**30:.2f} GiB), "
        f"{found['seconds']:.1f} s [{card}]")
    failures = []
    kept = {c.describe() for c in result.search.evaluated}
    for c in every:
        if c.describe() not in kept:
            log(f"9a candidate {c.describe()}: pruned")
    for got in result.search.evaluated:
        prof = ("not profiled" if got.step_time_s is None else
                f"failed ({got.error})" if not np.isfinite(got.step_time_s)
                else f"profiled {got.step_time_s * 1e3:.3f} ms/step, peak "
                f"{got.peak_bytes / 2**30:.2f} GiB")
        log(f"9a candidate {got.describe()}: kept, estimate "
            f"{got.est_step_time_s * 1e3:.3f} ms, {prof}")
        if (got.step_time_s is not None and not np.isfinite(got.step_time_s)
                and not got.error.startswith("out of memory")):
            failures.append(f"{got.describe()} failed by {got.error}")
    best = result.search.best
    plan = result.plan
    micro = plan.grad_accum
    expected = _flash_expected(cfg.num_layers, micro, XL_STEPS, plan.remat,
                               plan.low_bit_opt, n_params)
    init = expected.pop("quantization.quantize", 0)
    expected["quantization.quantize"] = 0
    want_build = _zero_counts(**({"quantization.quantize": init}
                                 if init else {}))
    got_steps = {k: counts[k] - build_counts[k] for k in counts}
    step_s = statistics.median(secs[2:])
    tokens = XL_BATCH * SMALL_SEQ
    log(f"9a chosen plan {best.describe()} ({result.strategy.opts}): losses "
        f"{losses}, median step {step_s * 1e3:.3f} ms over steps "
        f"3..{XL_STEPS}, {tokens / step_s:.1f} tokens/s; launches at build "
        f"{build_counts}, expected {want_build}; in the steps {got_steps}, "
        f"expected {expected} [{card}]")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"losses {losses}")
    if build_counts != want_build or got_steps != expected:
        failures.append(f"launch counts {build_counts} / {got_steps}")
    if failures:
        raise AssertionError("9a: " + "; ".join(failures))
    del result, model
    return {"accel_search_xl": counts}


# phase 9b's FSDP2 AdamW median step (seconds), for phase 10c's comparison
PHASE_9B: dict = {}


def _one_rank_group(tmpdir):
    import torch.distributed as dist

    store = dist.FileStore(os.path.join(tmpdir, "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)


def phase_fsdp_one_rank(card) -> dict:
    """9b: GPT-2 small under the main-path example's semi-auto strategy
    (fsdp, amp_native, checkpoint) on a one-rank NCCL group: FSDP2's
    hooks, DTensor parameters and the kernels together.  6 steps of
    phase 5a's seed and batch against an unwrapped remat run, then the
    same with int8 q-AdamW (B6 over views of the DTensors' local shards)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.optim import q_adamw
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState,
        make_train_step,
    )

    steps, global_batch, micro_bs = 6, 32, 8
    accum = global_batch // micro_bs
    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash",
                               remat=True)
    data = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (global_batch, SMALL_SEQ + 1), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    n_params = 12 * cfg.num_layers + 4
    tmp = tempfile.mkdtemp(prefix="fsdp1-")
    _one_rank_group(tmp)
    by_path, failures = {}, []
    try:
        for low_bit in (0, 8):
            opts = [("fsdp", {}), ("amp_native", {}), ("checkpoint", {}),
                    ("module_replace", {"attention": "flash"})]
            factory = _adamw_factory()
            if low_bit:
                opts.append(("low_bit_opt", {"bits": 8,
                                             "learning_rate": SMALL_LR,
                                             "weight_decay": 0.1}))
                factory = (lambda ps: q_adamw(ps, lr=SMALL_LR,
                                              weight_decay=0.1))
            # the unwrapped run: no plan, the plain step
            plain_model = GPT(cfg, seed=0)
            opt = factory(plain_model.parameters())
            step = make_train_step(_loss_fn, opt, accum)
            state, want, plain_secs = TrainState.create(plain_model, opt), [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                want.append(float(m["loss"]))
                torch.cuda.synchronize()
                plain_secs.append(time.perf_counter() - t0)
            del plain_model, opt, state, step
            _free_cuda()
            model = GPT(cfg, seed=0)
            reset_launch_counts()
            result = auto_accelerate(model, _adamw_factory(), _loss_fn, batch,
                                     strategy=Strategy(opts=opts),
                                     grad_accum=accum)
            dtensors = sum(isinstance(p, DTensor)
                           for p in result.model.parameters())
            got, secs = _train(result, batch, steps)
            counts = launch_counts()
            expected = _flash_expected(cfg.num_layers, accum, steps, True,
                                       low_bit, n_params)
            label = "9b fsdp" + (" int8 q-AdamW" if low_bit else " AdamW")
            err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            log(f"{label}: mesh {result.mesh.shape}, {dtensors} DTensor "
                f"parameters, losses {got}, unwrapped {want}, largest "
                f"relative difference {err:.3e} (rtol 1e-3, atol 1e-5), "
                f"median step {statistics.median(secs[2:]) * 1e3:.3f} ms "
                f"(unwrapped {statistics.median(plain_secs[2:]) * 1e3:.3f} "
                f"ms), "
                f"launches {counts}, expected {expected} [{card}]")
            if dtensors != n_params:
                failures.append(f"{label}: {dtensors} DTensor params")
            if not np.allclose(got, want, rtol=1e-3, atol=1e-5):
                failures.append(f"{label}: losses {got} vs {want}")
            if counts != expected:
                failures.append(f"{label}: launches {counts}")
            by_path[f"accel_fsdp_one_rank{'_int8' if low_bit else ''}"] = \
                counts
            if not low_bit:
                PHASE_9B["fsdp_step_s"] = statistics.median(secs[2:])
            del result, model
            _free_cuda()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return by_path


def phase_offload_xl(card) -> dict:
    """9c: ``offload_opt`` at GPT-2 XL: AdamW's fp32 moments (12.46 GB)
    in pinned host memory against the same plan's on-device AdamW, from
    the same init: peak device memory at least 10 GiB lower, losses
    within rtol 1e-3, both step times."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = GPTConfig.gpt2_xl(attention_impl="flash", remat=True)
    batch = _xl_batch(cfg.vocab_size)
    steps = 4
    runs = {}
    for offload in (False, True):
        opts = [("parallel_mode", {}), ("amp_native", {}),
                ("module_replace", {"attention": "flash"}),
                ("checkpoint", {})] + ([("offload_opt", {})] if offload
                                       else [])
        model = GPT(cfg, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        result = auto_accelerate(model, _adamw_factory(3e-4, 0.1), _loss_fn,
                                 batch, strategy=Strategy(opts=opts))
        losses, secs = _train(result, batch, steps)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        host = sum(t.numel() * t.element_size()
                   for st in result.state.optimizer.state.values()
                   for t in st.values()
                   if torch.is_tensor(t) and t.dim() and t.is_pinned())
        runs[offload] = (losses, peak, statistics.median(secs[1:]), counts)
        log(f"9c {'offload' if offload else 'on-device'} AdamW: losses "
            f"{losses}, peak {peak / 2**30:.2f} GiB, state in pinned host "
            f"memory {host / 1e9:.2f} GB, median step "
            f"{runs[offload][2] * 1e3:.3f} ms over steps 2..{steps}, "
            f"launches {counts} [{card}]")
        del result, model
        _free_cuda()
    (l0, p0, t0, c0), (l1, p1, t1, c1) = runs[False], runs[True]
    failures = []
    if p0 - p1 < 10 * 2**30:
        failures.append(f"peak {p1 / 2**30:.2f} GiB not 10 GiB below "
                        f"{p0 / 2**30:.2f}")
    if not np.allclose(l1, l0, rtol=1e-3):
        failures.append(f"losses {l1} vs {l0}")
    want = _flash_expected(cfg.num_layers, 1, steps, True)
    if c0 != want or c1 != want:
        failures.append(f"launches {c0} / {c1}, expected {want}")
    log(f"9c offload_opt: peak {p1 / 2**30:.2f} GiB against "
        f"{p0 / 2**30:.2f} GiB on the device ({(p0 - p1) / 2**30:.2f} GiB "
        f"less), step {t1 * 1e3:.3f} ms against {t0 * 1e3:.3f} ms [{card}]")
    if failures:
        raise AssertionError("9c: " + "; ".join(failures))
    return {"accel_offload_xl": c1}


def phase_trainer_strategy(card) -> dict:
    """9d: ``Trainer(strategy=...)`` on GPT-2 small for 4 steps through
    ``auto_accelerate`` (flash, bf16, remat: the model rebuilt with
    remat), with the checks of ``run_training``, a ``step_phases`` event
    a step and the step's phases in the metrics file."""
    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.models.gpt import GPTConfig

    steps, global_batch, micro = 4, 32, 8
    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash")
    strategy = Strategy(opts=[("parallel_mode", {}), ("amp_native", {}),
                              ("module_replace", {"attention": "flash"}),
                              ("checkpoint", {})])
    expected = _flash_expected(cfg.num_layers, global_batch // micro, steps,
                               True)
    trainer, result, counts = run_training(
        "9d Trainer with a strategy", cfg, global_batch, micro, steps,
        expected, card, strategy=strategy)
    from dlrover_tpu_torch.telemetry.events import read_events

    phases = [e for e in read_events(os.environ["DLROVER_EVENT_LOG"])
              if e.get("type") == "step_phases"]
    with open(os.environ["DLROVER_METRICS_FILE"]) as f:
        record = json.load(f)
    log(f"9d: {len(phases)} step_phases events, the last {phases[-1]}; "
        f"metrics file phases {record['phases']}")
    if not trainer.model.config.remat:
        raise AssertionError("9d: the plan's remat did not reach the model")
    if len(phases) != steps or not all("compute" in e for e in phases):
        raise AssertionError(f"9d: step_phases events {phases}")
    if not {"compute", "h2d", "report", "total_s"} <= set(record["phases"]):
        raise AssertionError(f"9d: metrics file phases {record['phases']}")
    return {"accel_trainer_strategy": counts}


# -- phase 8: the launcher, the agent and worker recovery ----------------------

L_STEPS = 8
L_CKPT_EVERY = 2
L_KILL_WINDOW = [3, 6]
L_SEED = 42
L_MONITOR_INTERVAL_S = 0.3
L_MAX_RESTARTS = 2
L_GLOBAL_BATCH, L_MICRO = 32, 8
# phase 19a: the kill at step 4 of phase 8's 8
SC_KILL_WINDOW = [4, 4]
# phase 8's in-process control, for phase 19a to reuse: {"losses",
# "path"}
LAUNCHER_CONTROL = {}

# The GPT-2 small worker of phase 8, written into each run's directory:
# the structure of the port's chaos train loop
# (``dlrover_tpu_torch/chaos/scenarios.py``) at phase 5a's width on the
# card.  Each incarnation rewrites ``incarnation_<restart>.json`` in its
# output directory after every step, before ``report_step`` (where a
# kill lands): its launch counts, losses, step times, recovery phases
# and the CUDA libraries it maps.  argv: ckpt_dir out_dir
LAUNCHER_WORKER_SCRIPT = r'''
import json, os, sys, time
import numpy as np
import torch

from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
from dlrover_tpu_torch.ops import cuda_build
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer, TrainState, make_train_step, restore_train_state,
    train_state_tree,
)
from dlrover_tpu_torch.trainer.recovery import RecoveryProfiler

# the kernel libraries this process holds before it ran anything: the
# ones a warm template preloaded (phase 19a)
LIBS_AT_START = cuda_build.loaded_libraries()
ckpt_dir, out_dir = sys.argv[1], sys.argv[2]
TOTAL_STEPS = int(os.environ["DLROVER_CHAOS_TOTAL_STEPS"])
CKPT_EVERY = int(os.environ["DLROVER_CHAOS_CKPT_EVERY"])
GLOBAL_BATCH, MICRO, SEQ = 32, 8, 1024
RESTART = int(os.environ.get("DLROVER_RESTART_COUNT", "0") or 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

prof = RecoveryProfiler()
tracker = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")

def committed_step():
    try:
        with open(tracker) as f:
            return int(f.read().strip() or -1)
    except (OSError, ValueError):
        return -1

with prof.phase("ckpt_init"):
    ckpt = Checkpointer(ckpt_dir)
    load_handle = ckpt.load_checkpoint_async()

# model_build's parts, timed here beside the profiler's phase: the
# CUDA context, the model on the card, the optimizer
parts = {}
with prof.phase("model_build"):
    t0 = time.perf_counter()
    cfg = GPTConfig.gpt2_small(max_seq_len=SEQ, attention_impl="flash")
    # no device named: the card, or an error where there is none
    model = GPT(cfg, seed=0)
    t1 = time.perf_counter()
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
    t2 = time.perf_counter()
    parts.update(model_s=t1 - t0, optimizer_s=t2 - t1)

    def loss_fn(module, batch):
        return cross_entropy_loss(module(batch["x"]), batch["y"])

    step_fn = make_train_step(loss_fn, optimizer,
                              grad_accum=GLOBAL_BATCH // MICRO)

data = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (GLOBAL_BATCH, SEQ + 1), dtype=np.int32)
batch = {"x": data[:, :-1], "y": data[:, 1:]}
if os.environ.get("DLROVER_COMPILE_CACHE_DIR"):
    # the step caches (phase 19a): the resolve finds the entry the first
    # incarnation wrote, whose flash library the template loaded
    from dlrover_tpu_torch.common.aot_cache import aot_cache_dir

    step = prof.resolve_step(
        step_fn, lambda: (TrainState.create(model, optimizer), batch),
        cache_dir=aot_cache_dir(),
        restore_busy=lambda: not load_handle.done())
else:
    step = prof.resolve_step(step_fn,
                             restore_busy=lambda: not load_handle.done())

start_step, restored = load_handle.result()
prof.record_restore(ckpt.last_restore_phases)
with prof.phase("state_build"):
    state = TrainState.create(model, optimizer)
    if start_step is None:
        start_step = 0
    else:
        restore_train_state(state, restored["state"])
        torch.cuda.synchronize()

trainer = ElasticTrainer(global_batch_size=GLOBAL_BATCH,
                         micro_batch_size=MICRO, dp_size=1)
trainer.global_step = start_step

def cuda_maps():
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if "libcuda" in line or "nvidia" in line})

with open("/proc/self/cmdline", "rb") as f:
    cmdline = f.read().replace(b"\0", b" ").decode().strip()
record = {"pid": os.getpid(), "ppid": os.getppid(), "cmdline": cmdline,
          "restart_count": RESTART, "start_step": start_step,
          "libs_at_start": LIBS_AT_START,
          "model_build_parts": parts,
          "restore": ckpt.last_restore_phases, "losses": {},
          "step_seconds": {}, "done": False}
path = os.path.join(out_dir, f"incarnation_{RESTART}.json")

def write():
    record["counts"] = dict(fa.LAUNCHES)
    record["phases"] = dict(prof.phases)
    record["nvcc_s"] = cuda_build.nvcc_seconds()
    record["maps"] = cuda_maps()
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)

fa.reset_launch_counts()
first = True
for i in range(start_step, TOTAL_STEPS):
    t0 = time.perf_counter()
    with trainer.profile("compute") as p:
        state, metrics = step(state, batch)
        p.block(metrics)
    if first:
        first = False
        prof.record_first_step()
    record["step_seconds"][str(i + 1)] = time.perf_counter() - t0
    record["losses"][str(i + 1)] = float(metrics["loss"])
    write()
    # the train_step event and the trainer.step chaos hook: a kill
    # rule ends the process here
    trainer.report_step(metrics)
    with trainer.profile("checkpoint"):
        if trainer.global_step % CKPT_EVERY == 0:
            ckpt.save_checkpoint(
                trainer.global_step,
                {"state": train_state_tree(state),
                 "trainer": trainer.state_dict()},
                storage_type=StorageType.MEMORY)

# the final step to storage, waiting for its commit
t0 = time.perf_counter()
final_sd = {"state": train_state_tree(state), "trainer": trainer.state_dict()}
deadline = time.time() + 300
while time.time() < deadline and committed_step() < TOTAL_STEPS:
    ckpt.save_checkpoint(TOTAL_STEPS, final_sd, storage_type=StorageType.DISK)
    ckpt.wait()
    poll_end = time.time() + 60
    while time.time() < poll_end and committed_step() < TOTAL_STEPS:
        time.sleep(0.05)
assert committed_step() >= TOTAL_STEPS, "checkpoint commit did not land"
record["final_save_s"] = time.perf_counter() - t0
record["done"] = True
write()
ckpt.close()
'''


def _cuda_device_files(pid) -> list:
    """The ``/dev/nvidia*`` files ``pid`` holds open or mapped: the CUDA
    driver was initialised in it (``cuInit`` opens ``/dev/nvidiactl``
    and the card's node, a context maps them).  Loading the libraries
    opens none: ``import torch`` maps ``libcudart`` and ``libcuda.so``
    (torch 2.11) without touching the card."""
    found = set()
    with open(f"/proc/{pid}/maps") as f:
        found.update(line.split()[-1] for line in f
                     if line.rstrip().split()[-1].startswith("/dev/nvidia"))
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            found.add(target)
    return sorted(found)


def _maps_kernels(pid) -> list:
    """The port's kernel libraries (``<source>-<hash>.so``) mapped into
    ``pid``."""
    with open(f"/proc/{pid}/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if any(f"/{name}-" in line for name in SOURCES)
                       and line.rstrip().endswith(".so")})


class _ProcSampler:
    """Samples, every 0.2 s, the live processes of the run (those
    ``harness.scan_processes`` finds by ``marker``, which leaves out this
    process): their latest command line and parent, the CUDA libraries
    they map and the ``/dev/nvidia*`` files they hold (unions over the
    samples)."""

    def __init__(self, marker: str):
        import threading

        self.marker = marker
        self.seen = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self):
        from dlrover_tpu_torch.chaos.harness import scan_processes

        for pid in scan_processes(self.marker):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmdline = f.read().replace(b"\0", b" ").decode().strip()
                with open(f"/proc/{pid}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
                libs = _maps_cuda(pid)
                devices = _cuda_device_files(pid)
                kernels = _maps_kernels(pid)
            except (OSError, ValueError, IndexError):
                continue
            rec = self.seen.setdefault(pid, {"maps": [], "devices": []})
            # the latest command line and parent: a child caught between
            # its fork and its exec still shows its parent's command line
            if cmdline:
                rec["cmdline"], rec["ppid"] = cmdline, ppid
            rec.setdefault("cmdline", cmdline)
            rec.setdefault("ppid", ppid)
            rec["maps"] = sorted(set(rec["maps"]) | set(libs))
            rec["devices"] = sorted(set(rec["devices"]) | set(devices))
            rec["kernels"] = sorted(set(rec.get("kernels", []))
                                    | set(kernels))

    def _run(self):
        while not self._stop.wait(0.2):
            self._sample()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


def launcher_child(label: str, workdir: str, ckpt_dir: str,
                   result_path: str, control_path: str = "") -> int:
    """One launcher run of phase 8, in a process of its own that never
    touches CUDA (this process is the agent): ``run.main`` with the
    GPT-2 small worker under ``kill_worker_midstep`` (``8a``, ``8b``
    with ``--warm-restart``).  The run's invariants are evaluated on its
    event log; what this process and its children mapped goes into
    ``result_path``."""
    from dlrover_tpu_torch.agent.forkserver import TRAINER_PRELOAD
    from dlrover_tpu_torch.chaos import harness, scenarios

    warm = label in ("8b", "19a")
    scenario = scenarios.kill_worker_midstep(seed=L_SEED)
    scenario.rules[0].step_window = list(
        SC_KILL_WINDOW if label == "19a" else L_KILL_WINDOW)
    out_dir = os.path.join(workdir, "out")
    os.makedirs(out_dir, exist_ok=True)
    env, event_log = harness.scenario_env(
        scenario, workdir, L_STEPS, L_CKPT_EVERY)
    if warm:
        env["DLROVER_PRELOAD"] = TRAINER_PRELOAD
    if label == "19a":
        # the step caches: a fresh job cache under the run's directory,
        # so the first incarnation builds the flash library into it, and
        # the template preloads the entry and its library before a fork
        env["DLROVER_COMPILE_CACHE_DIR"] = os.path.join(workdir,
                                                        "torch_cache")
        env["DLROVER_AOT_PRETRACE"] = "1"
    script = os.path.join(workdir, "gpt2_small_worker.py")
    with open(script, "w") as f:
        f.write(LAUNCHER_WORKER_SCRIPT)
    t0 = time.time()
    with _ProcSampler(workdir) as sampler:
        rc = harness.launch(
            scenario, env,
            [script, ckpt_dir, out_dir], max_restarts=L_MAX_RESTARTS,
            monitor_interval=L_MONITOR_INTERVAL_S, warm_restart=warm)
    wall = time.time() - t0
    report = harness._build_report(scenario, rc, workdir, event_log)
    with open(control_path) as f:
        control = json.load(f)
    # the tier-1 twin's set: the reference's acceptance, whose goodput
    # ledger must name >= 90% of the lost time
    checks = harness.invariants_for_scenario(
        scenario.name, L_STEPS, L_CKPT_EVERY, workdir) + [
        harness.RestoredFromTier("shm"),
        harness.LossTrajectoryMatches(control),
    ]
    harness.check_invariants(report, checks)
    result = {
        "label": label, "rc": rc, "ok": report.ok, "wall_s": wall,
        "summary": report.summary(), "timeline": report.timeline,
        "attribution": report.attribution,
        "invariants": [[r.name, r.ok, r.detail] for r in report.invariants],
        "agent": {"pid": os.getpid(), "maps": _maps_cuda(os.getpid()),
                  "devices": _cuda_device_files(os.getpid()),
                  "torch_loaded": "torch" in sys.modules},
        "procs": {str(k): v for k, v in sampler.seen.items()},
        "incarnations": [],
    }
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("incarnation_") and name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                result["incarnations"].append(json.load(f))
    with open(result_path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(result_path + ".tmp", result_path)
    return 0


def _launcher_run(label: str, turn: int, control_path: str = "") -> dict:
    """Run ``launcher_child`` for ``label`` in a process of its own and
    return its result, with the run's events.  The run gets a short
    work directory (unix socket paths) and a job name of its own; its
    checkpoint goes under ``chip_smoke_out``.  Afterwards its shm
    segment is unlinked and no segment of its job may remain."""
    from dlrover_tpu_torch.checkpoint.saver import read_last_checkpoint
    from dlrover_tpu_torch.telemetry.events import read_events

    workdir = tempfile.mkdtemp(prefix=f"dl8{label}")
    ckpt_dir = os.path.join(OUT_DIR, f"ckpt_launcher_{label}_{turn}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    result_path = os.path.join(OUT_DIR, f"launcher_{label}_{turn}.json")
    log_path = os.path.join(OUT_DIR, f"launcher_{label}_{turn}.log")
    job = f"{os.environ['DLROVER_JOB_NAME']}_l{turn}"
    env = dict(os.environ, PYTHONPATH=ROOT, DLROVER_JOB_NAME=job)
    for key in ("DLROVER_EVENT_LOG", "DLROVER_METRICS_FILE"):
        env.pop(key, None)
    if os.path.exists(result_path):
        os.unlink(result_path)
    try:
        with open(log_path, "w") as f:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--launcher-child", label, workdir, ckpt_dir, result_path,
                 control_path],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                timeout=600)
        if proc.returncode != 0 or not os.path.exists(result_path):
            with open(log_path) as f:
                tail = f.read()[-6000:]
            raise AssertionError(f"launcher run {label} ended with "
                                 f"{proc.returncode}:\n{tail}")
        with open(result_path) as f:
            result = json.load(f)
        events = os.path.join(workdir, "events.jsonl")
        result["events"] = list(read_events(events))
        shutil.copy(events, os.path.join(
            OUT_DIR, f"launcher_{label}_{turn}_events.jsonl"))
        result["committed"] = read_last_checkpoint(ckpt_dir)[0]
    finally:
        prefix = f"dlrover_tpu_ckpt_shm_{job}_"
        unlinked = [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]
        for name in unlinked:
            os.unlink(os.path.join("/dev/shm", name))
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    left = [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]
    result["shm_unlinked"], result["shm_left"] = unlinked, left
    return result


def _incarnation_counts(inc) -> dict:
    return _zero_counts(**{f"flash_attention.{k}": v
                           for k, v in inc["counts"].items()})


def _check_launcher_run(r, per_step, control=None) -> list:
    """The failures of one launcher run of phase 8, as text.  With
    ``control`` (the control's losses of steps 1..L_STEPS,
    ``_launcher_control``) every loss of every incarnation must equal
    the control's at its step bit for bit: the replay from shm is exact
    on the card."""
    failures = []
    label = r["label"]
    incs = sorted(r["incarnations"], key=lambda i: i["restart_count"])
    bad = [inv for inv in r["invariants"] if not inv[1]]
    if r["rc"] != 0 or bad:
        failures.append(f"rc {r['rc']}, failed invariants {bad}")
    if r["committed"] != L_STEPS:
        failures.append(f"committed step {r['committed']}, not {L_STEPS}")
    if len(incs) != 2:
        failures.append(f"{len(incs)} incarnations, not 2")
    for inc in incs:
        steps = len(inc["losses"])
        expect = _zero_counts(**{f"flash_attention.{k}": per_step * steps
                                 for k in ("fwd", "bwd_dq", "bwd_dkv")})
        if _incarnation_counts(inc) != expect:
            failures.append(f"incarnation {inc['restart_count']} launched "
                            f"{inc['counts']} in {steps} steps, not "
                            f"{per_step} of each a step")
        if not all(map(_finite, inc["losses"].values())):
            failures.append(f"incarnation {inc['restart_count']}: "
                            f"non-finite loss {inc['losses']}")
        if control is not None:
            differ = {k: (v, control[int(k) - 1])
                      for k, v in inc["losses"].items()
                      if v != control[int(k) - 1]}
            if differ:
                failures.append(f"incarnation {inc['restart_count']}: "
                                f"losses differ from the control's "
                                f"(step: (run, control)) {differ}")
        if not any(m.startswith("/dev/nvidia") for m in inc["maps"]):
            failures.append(f"incarnation {inc['restart_count']} (pid "
                            f"{inc['pid']}) holds no CUDA device: "
                            f"{inc['maps']}")
    if incs and not incs[-1]["done"]:
        failures.append("the last incarnation did not finish")
    agent = r["agent"]
    if agent["maps"] or agent["devices"] or agent["torch_loaded"]:
        failures.append(f"the agent (pid {agent['pid']}) maps CUDA "
                        f"{agent['maps'] + agent['devices']} (torch "
                        f"loaded: {agent['torch_loaded']})")
    masters = {p: v for p, v in r["procs"].items()
               if "dlrover_tpu_torch.master.main" in v["cmdline"]}
    if not masters:
        failures.append("no master process was sampled")
    for pid, v in masters.items():
        if v["maps"] or v["devices"]:
            failures.append(f"the master (pid {pid}) maps CUDA: "
                            f"{v['maps'] + v['devices']}")
    if r["shm_left"] or len(r["shm_unlinked"]) != 1:
        failures.append(f"shm segments: unlinked {r['shm_unlinked']}, "
                        f"left {r['shm_left']}")
    events = r["events"]
    kills = [t for t in r["timeline"] if t[3] == "kill"]
    if len(r["timeline"]) != 1 or len(kills) != 1 or not (
            L_KILL_WINDOW[0] <= kills[0][4] <= L_KILL_WINDOW[1]):
        failures.append(f"not one kill in {L_KILL_WINDOW}: {r['timeline']}")
    restarts = [e for e in events if e.get("type") == "worker_restart"]
    if len(restarts) != 1:
        failures.append(f"{len(restarts)} worker restarts, not 1")
    if len(incs) == 2 and incs[1]["restore"].get("tier") != "shm":
        failures.append(f"the respawned worker restored from "
                        f"{incs[1]['restore'].get('tier')}, not shm")
    if label in ("8b", "19a"):
        templates = {p: v for p, v in r["procs"].items()
                     if "dlrover_tpu_torch.agent.forkserver" in v["cmdline"]
                     and v["ppid"] == agent["pid"]}
        if not templates:
            failures.append("no forkserver template was sampled")
        for pid, v in templates.items():
            # it imports torch, which maps the libraries; the driver
            # must never have been initialised in it
            if v["devices"]:
                failures.append(f"the template (pid {pid}) initialised "
                                f"the CUDA driver: {v['devices']}")
        for inc in incs:
            if (str(inc["ppid"]) not in templates
                    or "agent.forkserver" not in inc["cmdline"]):
                failures.append(f"incarnation {inc['restart_count']} was "
                                f"not forked from the template: ppid "
                                f"{inc['ppid']}, {inc['cmdline']!r}")
        fallbacks = [e for e in events
                     if e.get("type") == "warm_fork_fallback"]
        if fallbacks:
            failures.append(f"warm fork fell back: {fallbacks}")
    return failures


L_BREAKDOWN = ("spawn", "import", "ckpt_init", "model_build", "aot",
               "restore", "state_build", "loop_setup", "retrace",
               "first_step")


def _recovery_breakdown(r) -> dict:
    """Seconds from the kill to the respawned worker's first step, and
    its parts: the death's detection (kill -> the agent's restart
    event), the respawned worker's recovery phases and the restore's
    stages."""
    events = r["events"]
    kill = next(e for e in events if e.get("type") == "chaos_inject")
    witnessed = next(e for e in events if e.get("type") == "worker_restart")
    first = next(e for e in events if e.get("type") == "train_step"
                 and e.get("restart_count", 0) > 0)
    inc = max(r["incarnations"], key=lambda i: i["restart_count"])
    last = max(int(s) for s in min(
        r["incarnations"], key=lambda i: i["restart_count"])["losses"])
    phases = {p: inc["phases"][p] for p in L_BREAKDOWN if p in inc["phases"]}
    total = first["ts"] - kill["ts"]
    detect = witnessed["ts"] - kill["ts"]
    # the serial chain; the restore overlaps model_build on its thread,
    # and first_step is the profiler's remainder since its construction
    serial = sum(phases.get(p, 0.0) for p in (
        "spawn", "import", "ckpt_init", "model_build", "state_build",
        "loop_setup", "retrace"))
    out = {
        "kill_step": kill.get("step"),
        "kill_to_first_step_s": total,
        "detect_s": detect,
        "other_s": total - detect - serial,
        "phases": phases,
        "restore_stages": {k: inc["restore"].get(k) for k in
                           ("tier", "read_s", "assemble_s", "h2d_s",
                            "total_s", "bytes")},
        "steps_lost": last - inc["start_step"],
        "model_build_parts": inc.get("model_build_parts"),
        "goodput": (r["attribution"] or {}).get("goodput"),
        "start_step": inc["start_step"],
    }
    return out


def _launcher_control(cfg):
    """Phase 8's control: the worker's training (its model, seed,
    batch, AdamW and step; ``LAUNCHER_WORKER_SCRIPT``) for ``L_STEPS``
    steps in this process, with every launch count set to 0 just before
    and read just after.  Returns (losses, the median of steps 3 on in
    seconds, counts).  It replaces a launcher run under no scenario:
    the kill runs start the same processes and hold the launcher's
    invariants themselves."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.gpt import GPT, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState,
        make_train_step,
    )

    model = GPT(cfg, seed=0)
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
    step_fn = make_train_step(
        lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]), optimizer,
        grad_accum=L_GLOBAL_BATCH // L_MICRO)
    data = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (L_GLOBAL_BATCH, SMALL_SEQ + 1), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    state = TrainState.create(model, optimizer)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, secs = [], []
    for _ in range(L_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
    counts = launch_counts()
    return losses, statistics.median(secs[2:]), counts


def phase_launcher(card) -> dict:
    """Phase 8: slice 3b.2 on the card — ``python -m
    dlrover_tpu_torch.run`` (its ``main``) supervising the GPT-2 small
    worker, which is SIGKILLed mid-step by ``kill_worker_midstep`` and
    must be respawned and restored from shm: 8a cold, 8b with
    ``--warm-restart``, one run each, against the control losses of the
    worker's training in this process (``_launcher_control``).  Returns
    the launch counts of the runs, summed over their incarnations."""
    import math

    from dlrover_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash")
    per_step = cfg.num_layers * (L_GLOBAL_BATCH // L_MICRO)
    tokens = L_GLOBAL_BATCH * SMALL_SEQ
    failures = []
    control_losses, steady, control_counts = _launcher_control(cfg)
    expected = _zero_counts(**{f"flash_attention.{k}": per_step * L_STEPS
                               for k in ("fwd", "bwd_dq", "bwd_dkv")})
    if control_counts != expected:
        raise AssertionError(f"launcher: control launches {control_counts} "
                             f"!= {expected}")
    if not all(math.isfinite(x) for x in control_losses) or not (
            control_losses[-1] < control_losses[0]):
        raise AssertionError(f"launcher: the control's loss did not fall: "
                             f"{control_losses}")
    control_path = os.path.join(OUT_DIR, "launcher_control_losses.json")
    with open(control_path, "w") as f:
        json.dump(control_losses, f)
    LAUNCHER_CONTROL.update(losses=control_losses, path=control_path)
    phase5a = SMALL_ADAMW["tokens_s"]
    log(f"launcher: control (the worker's training in this process, no "
        f"launcher) losses {control_losses}; steady steps 3..{L_STEPS} "
        f"median {steady * 1e3:.3f} ms, {tokens / steady:.1f} tokens/s, "
        f"phase 5a {phase5a:.1f} ({tokens / steady / phase5a:.4f}) [{card}]")
    # the control runs in this process, not under the launcher
    counts = {"launcher_control_inprocess": control_counts}
    runs = []
    for turn, label in enumerate(("8a", "8b"), start=1):
        r = _launcher_run(label, turn, control_path)
        bad = _check_launcher_run(r, per_step, control_losses)
        failures += [f"{label} turn {turn}: {f}" for f in bad]
        b = _recovery_breakdown(r) if not bad else {}
        runs.append((label, turn, r, b))
        path = "launcher_cold" if label == "8a" else "launcher_warm"
        summed = _zero_counts()
        for i in r["incarnations"]:
            for k, v in _incarnation_counts(i).items():
                summed[k] += v
        if path not in counts:
            counts[path] = summed
        log(f"launcher {label} turn {turn} "
            f"({'warm' if label == '8b' else 'cold'}): "
            f"{r['wall_s']:.1f} s, invariants "
            f"{[(n, ok) for n, ok, _ in r['invariants']]}")
        for line in r["summary"].splitlines():
            log(f"  {line}")
        if b:
            steps = [s for i in r["incarnations"]
                     for k, s in i["step_seconds"].items()
                     if int(k) >= i["start_step"] + 3]
            rate = tokens / statistics.median(steps) if steps else float("nan")
            log(f"launcher {label} turn {turn}: kill at step "
                f"{b['kill_step']}, restored at step {b['start_step']} from "
                f"{b['restore_stages']['tier']}, {b['steps_lost']} step(s) "
                f"lost, goodput {b['goodput']}; kill -> first step "
                f"{b['kill_to_first_step_s']:.3f} s: detection "
                f"{b['detect_s']:.3f} s, other (the restore's join, the "
                f"step's report) {b['other_s']:.3f} s, recovery phases "
                f"{json.dumps(b['phases'])} (model_build: "
                f"{json.dumps(b['model_build_parts'])}), restore stages "
                f"{json.dumps(b['restore_stages'])}; steady steps "
                f"{rate:.1f} tokens/s ({rate / phase5a:.4f} of 5a) [{card}]")
    cold = [b["kill_to_first_step_s"] for lb, _, _, b in runs
            if lb == "8a" and b]
    warm = [b["kill_to_first_step_s"] for lb, _, _, b in runs
            if lb == "8b" and b]
    log(f"launcher: kill -> first step, cold {[round(x, 3) for x in cold]} "
        f"s, warm {[round(x, 3) for x in warm]} s (turns "
        f"{[lb for lb, *_ in runs]}) [{card}]")
    if failures:
        raise AssertionError("launcher: " + "; ".join(failures))
    return counts


FAMILIES = ("flash attention (this port)", "quantization (this port)",
            "matmul", "other")


def _family(key: str) -> str:
    if "FlashParams" in key:
        return FAMILIES[0]
    if any(k in key for k in ("qadam_kernel", "quantize_kernel")):
        return FAMILIES[1]  # quantize_kernel also matches dequantize
    if any(k in key.lower() for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return FAMILIES[2]
    return FAMILIES[3]


def profile_step(trainer, batch, card, label):
    """One more training step under torch.profiler: device time by
    kernel family and the device's busy share of the step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    placed = trainer.place_batch(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, _ = trainer.train_step(trainer.state, placed)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device kernels only: the CPU ops' rows repeat their kernels' time,
    # and a user annotation's device range (Optimizer.step#...) spans
    # kernels that have rows of their own
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    name = label.replace(" ", "_").replace("-", "_").lower()
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        f.write(f"{label} [{card}]\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40))
    busy = sum(r[0] for r in rows)
    if not busy:
        log(f"profile {label}: the profiler recorded no device time")
        return
    families = {f: 0.0 for f in FAMILIES}
    for us, _, key in rows:
        families[_family(key)] += us
    log(f"profile {label}: step wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({busy / wall_us:.4f} of the step, "
        f"profiler on); " + ", ".join(
            f"{k} {v / 1e3:.3f} ms ({v / busy:.4f})"
            for k, v in families.items()) + f" [{card}]")
    for us, count, key in rows[:8]:
        log(f"profile {label}:   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


# -- phase 10: the elastic example -------------------------------------------

EXAMPLE = os.path.join(ROOT, "dlrover_tpu_torch", "examples",
                       "train_gpt_elastic.py")
E_STEPS, E_SAVE_EVERY, E_ORBAX_EVERY, E_KILL_AT = 12, 4, 2, 8
E_GLOBAL_BATCH = 32
# seconds one launcher run of the example may take (about 40-75 s)
E_RUN_TIMEOUT_S = 300
# the example's compute dtype (amp_native's default, bf16)
E_AMP: dict = {}


@contextmanager
def _example_scope(label: str):
    """The checkpoint directory, record directory, event log and job
    name of one example run of phase 10, emptied before it; the job's
    shm segments are unlinked after it, failure included."""
    ckpt = os.path.join(OUT_DIR, f"ckpt_example_{label}")
    rec = os.path.join(OUT_DIR, f"example_{label}")
    event_log = os.path.join(OUT_DIR, f"example_{label}_events.jsonl")
    for path in (ckpt, ckpt + "_durable", rec):
        shutil.rmtree(path, ignore_errors=True)
    if os.path.exists(event_log):
        os.remove(event_log)
    job = f"{os.environ['DLROVER_JOB_NAME']}_e{label}"
    try:
        yield ckpt, rec, event_log, job
    finally:
        prefix = f"dlrover_tpu_ckpt_shm_{job}_"
        for name in os.listdir("/dev/shm"):
            if name.startswith(prefix):
                os.unlink(os.path.join("/dev/shm", name))


def _example_result(label, ckpt, rec, event_log, wall) -> dict:
    """One example run's incarnation records and events, its checkpoint
    directory (kept for 10b) and its wall time."""
    from dlrover_tpu_torch.telemetry.events import read_events

    records = []
    for name in sorted(os.listdir(rec)):
        if name.startswith("incarnation_") and name.endswith(".json"):
            with open(os.path.join(rec, name)) as f:
                records.append(json.load(f))
    return {"label": label, "records": records,
            "events": list(read_events(event_log)), "ckpt": ckpt,
            "wall_s": wall}


def _example_run(label: str, steps: int, kill_at: int) -> dict:
    """One ``python -m dlrover_tpu_torch.run --warm-restart`` run of the
    example (the launcher in a process of its own) with a SIGKILL of the
    worker at ``kill_at``; the respawn forks from the warm template, as
    phase 8b's and 12's do (a cold respawn is phase 8a's path).  The
    run gets a short socket directory of its own."""
    from dlrover_tpu_torch.chaos import harness
    from dlrover_tpu_torch.chaos.schedule import Scenario

    # the kill lands once the snapshot of step ``kill_at`` is whole in
    # shm (a kill mid-write would leave the segment torn)
    scenario = Scenario.from_dict({"name": f"example-{label}", "seed": 0,
                                   "rules": [{
                                       "name": "kill-after-save",
                                       "point": "ckpt.shm_save",
                                       "action": "kill", "at_step": kill_at,
                                       "only_first_incarnation": True}]})
    workdir = tempfile.mkdtemp(prefix=f"dl10{label}")
    log_path = os.path.join(OUT_DIR, f"example_{label}.log")
    with _example_scope(label) as (ckpt, rec, event_log, job):
        env, _ = harness.scenario_env(scenario, workdir, steps, E_SAVE_EVERY)
        env = {**os.environ, **env, "PYTHONPATH": ROOT,
               "DLROVER_JOB_NAME": job, "DLROVER_EVENT_LOG": event_log}
        # a run that outlives its limit dumps every thread's stack of
        # every process of it (SIGABRT with the fault handler on) into
        # its log
        env["PYTHONFAULTHANDLER"] = "1"
        t0 = time.perf_counter()
        try:
            with open(log_path, "w") as f:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "dlrover_tpu_torch.run",
                     "--nproc_per_node=1", "--max_restarts=3",
                     "--warm-restart", "--monitor_interval=0.3", EXAMPLE,
                     "--steps", str(steps), "--save-every", str(E_SAVE_EVERY),
                     "--orbax-every", str(E_ORBAX_EVERY), "--ckpt-dir", ckpt,
                     "--record", rec],
                    cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                    start_new_session=True)
                try:
                    rc = proc.wait(timeout=E_RUN_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGABRT)
                    time.sleep(5)
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
                    rc = "a timeout"
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        wall = time.perf_counter() - t0
        if rc != 0:
            with open(log_path) as f:
                tail = f.read()[-12000:]
            raise AssertionError(f"example run {label} ended with "
                                 f"{rc} after {wall:.1f} s:\n{tail}")
        return _example_result(label, ckpt, rec, event_log, wall)


def _example_control_inprocess(steps: int) -> dict:
    """10a's control: the example's ``main`` in this process (its own
    one-rank NCCL group, an in-process saver, no launcher); the kill run
    starts the launcher's processes and holds the checks of a launcher
    run itself."""
    import torch.distributed as dist

    from dlrover_tpu_torch.chaos import harness
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.examples import train_gpt_elastic

    label = "control_inprocess"
    with _example_scope(label) as (ckpt, rec, event_log, job):
        t0 = time.perf_counter()
        try:
            with harness._patched_env({"DLROVER_EVENT_LOG": event_log,
                                       "DLROVER_JOB_NAME": job}):
                train_gpt_elastic.main([
                    "--steps", str(steps), "--save-every", str(E_SAVE_EVERY),
                    "--orbax-every", str(E_ORBAX_EVERY), "--ckpt-dir", ckpt,
                    "--record", rec])
            wall = time.perf_counter() - t0
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            AsyncCheckpointSaver.reset()
            _free_cuda()
        return _example_result(label, ckpt, rec, event_log, wall)


def _keep_example_logs():
    """On a failure of phase 10: the example runs' launcher logs (the
    agent's saver logs there) and event logs, into ``chiprun_out/``."""
    keep = os.path.join(ROOT, "chiprun_out", "phase10")
    os.makedirs(keep, exist_ok=True)
    for name in os.listdir(OUT_DIR):
        if name.startswith("example_") and name.endswith(
                (".log", "_events.jsonl")):
            shutil.copy(os.path.join(OUT_DIR, name), keep)
    log(f"phase 10: kept {sorted(os.listdir(keep))} in {keep}")


def _persist_line(r) -> str:
    """The persists of a run's storage saves (step: ok, seconds, to
    commit), from its events."""
    commits = {e["step"]: e["ts"] for e in r["events"]
               if e.get("type") == "checkpoint_commit"}
    out = []
    for e in r["events"]:
        if e.get("type") == "checkpoint_persist":
            out.append(f"step {e['step']}: ok {e.get('ok')}, "
                       f"{e.get('seconds')} s, committed "
                       f"{'yes' if e['step'] in commits else 'no'}")
    return "; ".join(out) or "no persist events"


def _check_example_run(r, per_step, control=None) -> list:
    """The failures of one example run, as text: every step of every
    incarnation launches ``per_step``, and with ``control`` (step ->
    loss) its loss is the control's within rtol 1e-3 / atol 1e-5."""
    failures = []
    for inc in r["records"]:
        for st in inc["steps"]:
            counts = _zero_counts(**{f"flash_attention.{k}": v
                                     for k, v in st["launches"].items()})
            if counts != per_step:
                failures.append(f"{r['label']} r{inc['restart']} step "
                                f"{st['step']}: launches {counts}")
            if not _finite(st["loss"]):
                failures.append(f"{r['label']} step {st['step']}: loss "
                                f"{st['loss']}")
            if control is not None:
                want = control[st["step"]]
                if abs(st["loss"] - want) > 1e-5 + 1e-3 * abs(want):
                    failures.append(
                        f"{r['label']} r{inc['restart']} step {st['step']}: "
                        f"loss {st['loss']} vs control {want}")
    return failures


def _flat_full(tree) -> dict:
    """flat key -> a full CPU tensor of each tensor leaf (DTensors
    gathered)."""
    from dlrover_tpu_torch.checkpoint.shm_handler import _flatten_state_dict
    from dlrover_tpu_torch.checkpoint.sharded import is_dtensor

    out = {}
    for key, leaf in _flatten_state_dict(tree).items():
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        out[key] = leaf.detach().cpu().clone()
    return out


def _same_bytes(got: dict, want: dict) -> list:
    import torch

    bad = [k for k in want if k not in got or got[k].dtype != want[k].dtype
           or not torch.equal(got[k].view(-1).view(torch.uint8),
                              want[k].contiguous().view(-1).view(
                                  torch.uint8))]
    return bad + sorted(set(got) - set(want))


def _example_batch(step: int, vocab: int):
    """The example's batch of ``step``: draw ``step`` of default_rng(0)
    after the sample batch (draw 0)."""
    import numpy as np

    from dlrover_tpu_torch.examples import train_gpt_elastic as ex

    data = ex.batches(vocab, SMALL_SEQ, np.random.default_rng(0))
    for _ in range(step):
        next(data)
    return next(data)


def _restore_plan(kind: str, ckpt_dir: str, orbax_dir: str = ""):
    """A fresh GPT-2 small (another seed: a leaf the restore missed
    shows) in the ``data`` plan (plain tensors) or a one-rank ``tensor``
    plan (the blocks' Dense layers as DTensors), restored from
    ``ckpt_dir`` through ``load_checkpoint(target_state=...)``: (model,
    optimizer, step function, step, restored flat, restore phases)."""
    import torch

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.examples import train_gpt_elastic as ex
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.parallel import sharding
    from dlrover_tpu_torch.parallel.mesh import build_mesh
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState,
        make_train_step,
    )
    from dlrover_tpu_torch.utils.convert import (
        adamw_state_from_tree,
        adamw_state_tree,
        params_tree,
    )

    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash",
                               remat=True)
    model = GPT(cfg, seed=1)
    if kind == "data":
        res = auto_accelerate(
            model, ex.optimizer, ex.loss_fn, _example_batch(0,
                                                            cfg.vocab_size),
            strategy=Strategy(opts=[
                ("parallel_mode", {}), ("amp_native", E_AMP),
                ("checkpoint", {}),
                ("module_replace", {"attention": "flash"})]))
        model, opt, step_fn = res.model, res.state.optimizer, res.train_step
        state = res.state
        place = res.place_batch
    else:
        mesh = build_mesh(
            device_type=next(model.parameters()).device.type)
        placements = sharding.param_placements(model, mesh.shape,
                                               sharding.gpt_tp_rules())
        sharding.apply_tensor_parallel(model, mesh, placements)
        # the blocks' Dense layers are DTensors and the rest plain
        # tensors: AdamW's foreach kernels take one kind at a time
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.1, foreach=False)
        step_fn = make_train_step(ex.loss_fn, opt)
        state = TrainState.create(model, opt)
        place = None
    AsyncCheckpointSaver.reset()
    ckpt = Checkpointer(ckpt_dir, replicated=False, orbax_dir=orbax_dir)
    target = {"params": params_tree(model),
              "opt_state": adamw_state_tree(opt, model)}
    step, restored = ckpt.load_checkpoint(target_state=target)
    phases = ckpt.last_restore_phases
    ckpt.close()
    AsyncCheckpointSaver.reset()
    if step is not None:
        adamw_state_from_tree(restored["opt_state"], opt, model)
        state.step = step
    return {"model": model, "opt": opt, "step_fn": step_fn, "state": state,
            "place": place, "step": step, "restored": _flat_full(restored),
            "phases": phases}


def _reference_state(ckpt_dir: str, step: int) -> dict:
    """The committed step ``step`` of ``ckpt_dir`` as full CPU tensors
    (its shards assembled on the host, no target)."""
    from dlrover_tpu_torch.checkpoint.saver import read_checkpoint_at
    from dlrover_tpu_torch.checkpoint.shm_handler import (
        _flatten_state_dict,
        state_dict_from_raw,
    )

    _, shards = read_checkpoint_at(ckpt_dir, step)
    meta, raw = shards[0]
    return _flatten_state_dict(state_dict_from_raw(meta, raw))


def _rate(phases) -> str:
    secs = sum(phases.get(k, 0.0) or 0.0
               for k in ("read_s", "assemble_s", "h2d_s"))
    gbs = phases.get("bytes", 0) / secs / 1e9 if secs else float("nan")
    return (f"tier {phases.get('tier')}: read {phases.get('read_s')} s, "
            f"assemble {phases.get('assemble_s')} s, h2d "
            f"{phases.get('h2d_s')} s, total {phases.get('total_s')} s, "
            f"{phases.get('bytes', 0) / 1e9:.4f} GB at {gbs:.3f} GB/s over "
            f"read+assemble+h2d")


def phase_example(card) -> dict:
    """10: the elastic example at GPT-2 small's full width under FSDP2:
    a control (in this process), a SIGKILLed run under the launcher
    restored through the target state, the reshard of its state into
    other plans and the orbax tier alone.  On a failure the runs' logs
    are kept in ``chiprun_out/phase10``."""
    per_step = _flash_expected(12, 1, 1, True)
    try:
        return _phase_example(card, per_step)
    except BaseException:
        _keep_example_logs()
        raise


def _phase_example(card, per_step) -> dict:
    import torch.distributed as dist

    from dlrover_tpu_torch.checkpoint.saver import read_last_checkpoint
    from dlrover_tpu_torch.models.gpt import GPTConfig

    failures = []
    # 10a: the control in this process, the kill run under the launcher
    control = _example_control_inprocess(E_STEPS + 1)
    want = {st["step"]: st["loss"]
            for inc in control["records"] for st in inc["steps"]}
    failures += _check_example_run(control, per_step)
    if sorted(want) != list(range(1, E_STEPS + 2)):
        failures.append(f"control steps {sorted(want)}")
    kill = _example_run("kill", E_STEPS, kill_at=E_KILL_AT)
    failures += _check_example_run(kill, per_step, want)
    incs = {inc["restart"]: inc for inc in kill["records"]}
    first, second = incs.get(0), incs.get(1)
    kills = [e for e in kill["events"] if e.get("type") == "chaos_inject"]
    commits = [e for e in kill["events"]
               if e.get("type") == "checkpoint_commit"]
    restore = (second or {}).get("restore", {})
    bit_equal = all(st["loss"] == want[st["step"]]
                    for inc in kill["records"] for st in inc["steps"])
    if (len(incs) != 2 or len(kills) != 1 or first["steps"][-1]["step"]
            < E_KILL_AT):
        failures.append(f"kill run: incarnations {sorted(incs)}, kills "
                        f"{kills}")
    elif not [c for c in commits if c["ts"] < kills[0]["ts"]]:
        failures.append("kill run: no save committed before the kill")
    if restore.get("tier") != "shm" or restore.get("step") != E_KILL_AT \
            or not restore.get("sharded"):
        failures.append(f"kill run: restore {restore}")
    if second and [st["step"] for st in second["steps"]] != list(
            range(restore.get("step", 0) + 1, E_STEPS + 1)):
        failures.append("kill run: the respawned worker's steps "
                        f"{[st['step'] for st in second['steps']]}")
    committed = read_last_checkpoint(kill["ckpt"])[0]
    if committed != E_STEPS:
        failures.append(f"kill run: committed step {committed}")
    log(f"10a example: control {control['wall_s']:.1f} s, kill run "
        f"{kill['wall_s']:.1f} s; killed at step "
        f"{kills[0]['step'] if kills else None}, restored step "
        f"{restore.get('step')} from {restore.get('tier')}; replayed "
        f"losses {'bit-equal to' if bit_equal else 'within 1e-3 of'} the "
        f"control's; launches a step {per_step}; committed {committed} "
        f"[{card}]")
    # 10c: the sharded save and the restores, from the records
    saves = control["records"][0]["saves"]
    commit_ts = {e["step"]: e["ts"] for e in control["events"]
                 if e.get("type") == "checkpoint_commit"}
    for sv in saves:
        if not sv["ok"]:
            log(f"10c save of step {sv['step']}: skipped, the previous "
                f"snapshot still writing [{card}]")
            continue
        to_commit = commit_ts.get(sv["step"], float("nan")) - sv["t"]
        write = sv.get("write", {})
        device_ms = (sv["device_s"] * 1e3 if sv.get("device_s")
                     else float("nan"))
        log(f"10c save of step {sv['step']}: {sv.get('bytes', 0) / 1e9:.4f} "
            f"GB of local shards, stall {sv['stall_s'] * 1e3:.3f} ms on the "
            f"host, {device_ms:.3f} ms on the card; to shm "
            f"{write.get('total_s')} s after the writer took it (fetch "
            f"{write.get('fetch_s')} s, memcpy {write.get('memcpy_s')} s); "
            f"to commit {to_commit:.3f} s after the call [{card}]")
    log(f"10c persists of the storage saves: control (in-process saver) "
        f"{_persist_line(control)}; kill run (the agent's saver) "
        f"{_persist_line(kill)} [{card}]")
    log(f"10c restore after the kill: {_rate(restore)} [{card}]")
    steady = [st["seconds"] for st in control["records"][0]["steps"][2:]]
    step_s = statistics.median(steady)
    fsdp_s = PHASE_9B.get("fsdp_step_s")
    log(f"10c example: median step {step_s * 1e3:.3f} ms, "
        f"{E_GLOBAL_BATCH * SMALL_SEQ / step_s:.1f} tokens/s (batch 32 in "
        f"one micro-batch); phase 9b's FSDP2 step "
        f"{fsdp_s * 1e3 if fsdp_s else float('nan'):.3f} ms = "
        f"{E_GLOBAL_BATCH * SMALL_SEQ / fsdp_s if fsdp_s else float('nan'):.1f} "
        f"tokens/s (4 micro-batches of 8) [{card}]")
    # 10b: reshard on the card
    vocab = GPTConfig.gpt2_small().vocab_size
    # the killed run's final state (its replay equals the control's)
    saved = kill["ckpt"]
    ref_last = _reference_state(saved, E_STEPS)
    orbax_steps = sorted(int(n.split("_")[1]) for n in os.listdir(
        saved + "_durable") if n.startswith("step_"))
    ref_orbax = _reference_state(saved, orbax_steps[-1])
    tmp = tempfile.mkdtemp(prefix="ex10-")
    _one_rank_group(tmp)
    try:
        for kind in ("data", "tensor"):
            plan = _restore_plan(kind, saved)
            bad = _same_bytes(plan["restored"], ref_last)
            dts = sum(p.__class__.__name__ == "DTensor"
                      for p in plan["model"].parameters())
            batch = _example_batch(E_STEPS + 1, vocab)
            if plan["place"] is not None:
                batch = plan["place"](batch)
            _, metrics = plan["step_fn"](plan["state"], batch)
            loss = float(metrics["loss"])
            ok = abs(loss - want[E_STEPS + 1]) <= 1e-5 + 1e-3 * abs(
                want[E_STEPS + 1])
            log(f"10b {kind} plan ({dts} DTensor params): restored step "
                f"{plan['step']} {'bit-equal' if not bad else bad[:5]}; "
                f"step {E_STEPS + 1} loss {loss} vs the control's "
                f"{want[E_STEPS + 1]} ({'bit-equal' if loss == want[E_STEPS + 1] else 'within 1e-3' if ok else 'OFF'}); "
                f"{_rate(plan['phases'])} [{card}]")
            if plan["step"] != E_STEPS or bad or not ok:
                failures.append(f"10b {kind}: step {plan['step']}, "
                                f"mismatched {bad[:5]}, loss {loss}")
            if kind == "tensor" and dts == 0:
                failures.append("10b tensor: no DTensor params")
            del plan
            _free_cuda()
        # the orbax tier alone: shm unlinked (after each run) and the
        # flash storage removed
        shutil.rmtree(saved, ignore_errors=True)
        plan = _restore_plan("data", saved, orbax_dir=saved + "_durable")
        bad = _same_bytes(plan["restored"], ref_orbax)
        log(f"10b orbax tier alone: restored step {plan['step']} of "
            f"{orbax_steps} {'bit-equal' if not bad else bad[:5]}; "
            f"{plan['phases'].get('tier')} in "
            f"{plan['phases'].get('total_s')} s [{card}]")
        if plan["step"] != orbax_steps[-1] or bad or \
                plan["phases"].get("tier") != "orbax":
            failures.append(f"10b orbax: step {plan['step']}, mismatched "
                            f"{bad[:5]}, {plan['phases']}")
        del plan
        _free_cuda()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("; ".join(failures))
    counts = {}
    for r in (control, kill):
        total = _zero_counts()
        for inc in r["records"]:
            for st in inc["steps"]:
                for k, v in st["launches"].items():
                    total[f"flash_attention.{k}"] += v
        counts[f"example_{r['label']}"] = total
    return counts


# -- phase 11: the Llama family and the chunked loss (slice 5.1) ---------------

LLAMA_STEPS = 6
LLAMA_CHUNKS = 8
# 11a: a narrow Llama at Llama-3-8B's head_dim (128) and GQA group (4)
LLAMA_SMALL = dict(vocab_size=512, max_seq_len=256, num_layers=2,
                   num_heads=4, num_kv_heads=1, hidden_dim=512,
                   intermediate_dim=1024)


def phase_llama_check():
    """11a: a narrow Llama on the card, 4 q heads over 1 kv head at
    head_dim 128: the flash model (k and v straight into the kernels)
    against the plain-attention model (k and v repeated) from the same
    weights, logits and gradients, within phase 4's tolerances."""
    import torch

    from dlrover_tpu_torch.models.gpt import cross_entropy_loss
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig

    tokens = torch.randint(0, 512, (2, 257), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    x, y = tokens[:, :-1], tokens[:, 1:]
    # (atol, rtol) of the logits: phase 4's in fp32; in bf16 those the
    # reference holds its own Llama's flash logits to against xla
    # (tests/test_llama.py, 5e-2 both: the residual stream stays bf16 and
    # the two attentions round p at other points); the gradients within
    # phase 4's atol
    for dtype, atol, rtol, gtol in ((torch.float32, 1e-4, 0.0, 1e-4),
                                    (torch.bfloat16, 5e-2, 5e-2, 3e-2)):
        results = {}
        for impl in ("xla", "flash"):
            reset_launch_counts()
            model = Llama(LlamaConfig(attention_impl=impl, dtype=dtype,
                                      **LLAMA_SMALL), device="cuda", seed=3)
            logits = model(x)
            cross_entropy_loss(logits, y).backward()
            grads = {n: p.grad for n, p in model.named_parameters()}
            results[impl] = (logits, grads, launch_counts())
        (lx, gx, cx), (lf, gf, cf) = results["xla"], results["flash"]
        if lf.shape != (2, 256, 512) or not bool(torch.isfinite(lf).all()):
            raise AssertionError(f"flash Llama logits {lf.shape} not finite")
        want = _zero_counts(**{f"flash_attention.{k}": 2 for k in (
            "fwd", "bwd_dq", "bwd_dkv")})
        if cf != want or cx != _zero_counts():
            raise AssertionError(f"11a launches {cf} / {cx}")
        diff = (lx - lf).abs()
        err = diff.max().item()
        over = (diff > atol + rtol * lx.abs()).sum().item()
        gerr = max((gx[n] - gf[n]).abs().max().item() for n in gx)
        log(f"11a Llama check {dtype} (GQA 4:1, head_dim 128, seq 256): "
            f"logits max_abs_err {err:.3e} ({over} beyond atol {atol} + "
            f"rtol {rtol}), grads max_abs_err {gerr:.3e} (tolerance {gtol})")
        if over or gerr > gtol:
            raise AssertionError(f"flash Llama disagrees with plain Llama "
                                 f"in {dtype}: {err:.3e} / {gerr:.3e}")


def _loss_peaks(trainer, card) -> dict:
    """The chunked loss against the full ``logits -> cross entropy``
    loss on the same params, each as a later micro-batch of a gradient
    accumulation: its forward and backward with the gradients of a first
    micro-batch already allocated (one micro-batch's step peaks where
    the gradients and the grad norm's fp32 copies live, past any loss).
    Prints each one's peak and its rise above what was allocated before
    it, and both losses, which must agree to bf16's rounding of the
    logits.  A full loss that runs out of memory peaks past the card."""
    import torch

    model, loss_fn = trainer.model, trainer.loss_fn
    placed = trainer.place_batch(trainer.train_data[0])
    model.zero_grad(set_to_none=True)
    loss_fn(model, placed).backward()  # the first micro-batch
    peaks, rises, losses = {}, {}, {}
    for name, fn in (("chunked", loss_fn), ("full", _loss_fn)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = None
        try:
            loss = fn(model, placed)
            loss.backward()
            losses[name] = float(loss.detach())
        except torch.OutOfMemoryError:
            losses[name] = float("nan")
        del loss
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        rises[name] = peaks[name] - base
    log(f"11b loss peaks, a micro-batch's forward and backward on top of "
        f"allocated gradients: chunked ({LLAMA_CHUNKS} chunks) "
        f"{peaks['chunked'] / 2**30:.2f} GiB (+{rises['chunked'] / 2**30:.2f}"
        f" GiB, loss {losses['chunked']:.6f}), full logits -> cross entropy "
        f"{peaks['full'] / 2**30:.2f} GiB (+{rises['full'] / 2**30:.2f} GiB, "
        f"loss {losses['full']:.6f}) [{card}]")
    model.zero_grad(set_to_none=True)
    if not peaks["full"] > peaks["chunked"]:
        raise AssertionError(f"the chunked loss did not peak lower: {peaks}")
    if not abs(losses["full"] - losses["chunked"]) <= 1e-3 * abs(
            losses["chunked"]):
        raise AssertionError(f"the chunked and full losses differ: {losses}")
    return peaks


def phase_train_llama(card) -> dict:
    """11b: Llama-3-8B at full width and depth (32 layers, d 4096, 32
    heads over 8 kv heads, intermediate 14336, vocab 128256, rope theta
    5e5), seq 8192, batch 1, bf16 params built on the card, through
    ``Trainer(strategy=[half, checkpoint, module_replace(flash),
    low_bit_opt(int8)])`` (the plan rebuilds the model with remat and
    flash) and ``chunked_loss_fn(num_chunks=8)``, q-AdamW lr 3e-4 and
    weight decay 0.1, 6 steps on one fixed batch, no checkpoint: finite
    losses that fall; 64 B1, 32 B2, 32 B3 and 1 B6 a step, B4 only at
    the optimizer's init, B5 never; peak memory and the moments' share,
    tokens/s and MFU, a profiled step, the chunked loss's peak against
    the full loss's, and B6 alone beside its bound."""
    import torch

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.models.losses import chunked_loss_fn

    label = "11b train Llama-3-8B int8 q-AdamW"
    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    # 9 a block (two norms, q/k/v/o, gate/up/down); wte, ln_f, lm_head
    n_params = 9 * cfg.num_layers + 3
    strategy = Strategy(opts=[
        ("parallel_mode", {}), ("half", {}), ("checkpoint", {}),
        ("module_replace", {"attention": "flash"}),
        ("low_bit_opt", {"bits": 8, "learning_rate": 3e-4,
                         "weight_decay": 0.1})])
    expected = _flash_expected(cfg.num_layers, 1, LLAMA_STEPS, True,
                               low_bit=8, n_params=n_params)
    log(f"{label}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"and {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved on the "
        "card before the build")
    trainer, result, counts = run_training(
        label, cfg, 1, 1, LLAMA_STEPS, expected, card, strategy=strategy,
        loss_fn=chunked_loss_fn(num_chunks=LLAMA_CHUNKS), save_final=False)
    got = trainer.model.config
    if not (got.remat and got.attention_impl == "flash"
            and got.param_dtype == torch.bfloat16):
        raise AssertionError(f"11b: the plan did not reach the model: {got}")
    ln = trainer.model.blocks[0].ln_attn.weight
    if ln.dtype != torch.float32:
        raise AssertionError(f"11b: an RMSNorm scale is {ln.dtype}")
    profile_step(trainer, trainer.train_data[0], card,
                 "Llama-3-8B int8 q-AdamW")
    _loss_peaks(trainer, card)
    # one more micro-batch's gradients for the optimizer's timing, which
    # steps on them again and again
    trainer.loss_fn(trainer.model,
                    trainer.place_batch(trainer.train_data[0])).backward()
    _report_qadam(trainer, result, n_params, label, card)
    return {"llama3_8b_int8_qadamw": counts}


def phase_llama_count(card):
    """11c: the count tier (the ``meta`` device, no profiling) over the
    Llama-3-8B candidates for this card, as a user builds the model (fp32
    params), with the int8-optimizer opt-in: one line a precision level
    (the memory model's verdict), one a kept candidate (its estimate);
    every fp32-AdamW plan must be pruned and the chosen plan's state
    must fit."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.accel import (
        ModelContext,
        OptimizationLibrary,
        analyser,
        strategy_search,
    )
    from dlrover_tpu_torch.accel.dry_runner import estimate_plan
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_tpu_torch.models.losses import chunked_loss_fn

    model = Llama(LlamaConfig.llama3_8b(), device="meta")
    data = np.random.default_rng(0).integers(
        0, model.config.vocab_size, (1, model.config.max_seq_len + 1),
        dtype=np.int32)
    context = ModelContext(
        model=model, optim_factory=_adamw_factory(3e-4, 0.1),
        loss_fn=chunked_loss_fn(num_chunks=LLAMA_CHUNKS),
        sample_batch={"x": data[:, :-1], "y": data[:, 1:]},
        extra={"search_optimizer": True}, device=torch.device("cuda"))
    analysis = analyser.analyse(context)
    hbm = analysis.per_device_hbm
    failures = []
    for half, low_bit in ((False, False), (True, False), (False, True),
                          (True, True)):
        for remat in (False, True):
            fits = analyser.fits_in_hbm(analysis, 1, 1, remat, half=half,
                                        low_bit_opt=low_bit)
            log(f"11c level params {'bf16' if half else 'fp32'}, moments "
                f"{'int8' if low_bit else 'fp32'}, remat {remat}: "
                f"{'kept' if fits else 'pruned'} (memory model at "
                f"{hbm / 2**30:.2f} GiB)")
            if fits and not low_bit:
                failures.append(f"an fp32-AdamW plan was kept (half {half})")
    t0 = time.perf_counter()
    search = strategy_search.search_strategy(context, 1,
                                             rank_mode="cost_model")
    seconds = time.perf_counter() - t0
    for cand in search.evaluated:
        log(f"11c candidate {cand.describe()}: kept, estimate "
            f"{cand.est_step_time_s * 1e3:.3f} ms")
    best = search.best
    plan = OptimizationLibrary().apply_strategy(best.strategy, context)
    est = estimate_plan(plan, context)
    log(f"11c chosen {best.describe()} in {seconds:.1f} s: estimate "
        f"{est.est_step_time_s * 1e3:.3f} ms ({est.flops:.4e} FLOPs, "
        f"{est.bytes_accessed:.4e} bytes), state "
        f"{est.device_peak_bytes / 2**30:.2f} GiB of {hbm / 2**30:.2f} GiB "
        f"[{card}]")
    if not (best.half and best.low_bit_opt):
        failures.append(f"chose {best.describe()}")
    if not est.device_peak_bytes < hbm:
        failures.append(f"the chosen plan's state "
                        f"{est.device_peak_bytes} B does not fit {hbm} B")
    if failures:
        raise AssertionError("11c: " + "; ".join(failures))


# 11d: steps past 11b's six, on request alone; and B6's timing steps
# (_report_qadam: 3 on the host's clock, 3 on the device's) on one
# gradient, then real steps
LLAMA_LOSS_STEPS = 12
STALE_STEPS, AFTER_STALE = 6, 3
# 11d's q-AdamW run: the optimizer steps whose B6 rows are written out
# (the rows with the largest update, before and after the launch) for
# the CPU replay through the reference (tests/test_torch_qadam_rows.py)
QADAM_ROW_STEPS, QADAM_ROWS = (8, 9), 4
QADAM_ROWS_FILE = "qadam_rows_11d.json"


def _b64(t) -> str:
    """A tensor's bytes as base64 text (bf16 as its 16-bit patterns)."""
    import base64

    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return base64.b64encode(t.numpy().tobytes()).decode()


class QAdamRows:
    """Wraps ``QAdamW.step``: at the optimizer steps of
    ``QADAM_ROW_STEPS`` it finds, by B6's plain version on the card leaf
    by leaf, the ``QADAM_ROWS`` rows of ``block`` elements with the
    largest update, keeps their inputs (p, g, the codes and scales of mu
    and sqrt(nu)), lets the real step (one B6 launch) run, and keeps the
    same rows after it."""

    def __init__(self, names):
        self.names, self.rows = names, []

    def __enter__(self):
        from dlrover_tpu_torch.optim import low_bit

        self.cls, self.orig = low_bit.QAdamW, low_bit.QAdamW.step
        rows = self

        def step(opt, closure=None):
            return rows.step(opt, closure)

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.orig

    def _pick(self, opt):
        import torch

        from dlrover_tpu_torch.ops.quantization import (
            bias_corrections,
            fused_qadam_step_plain,
        )

        group = opt.param_groups[0]
        hyper = dict(b1=group["b1"], b2=group["b2"], eps=group["eps"],
                     lr=group["lr"], wd=group["weight_decay"])
        block = opt.block_size
        best = []  # (max |upd| of the row, param, row)
        for p in group["params"]:
            if p.grad is None or p.numel() % block:
                continue
            st = opt.state[p]
            bc1, bc2 = bias_corrections(hyper["b1"], hyper["b2"],
                                        st["step"] + 1)
            g2, p2 = p.grad.reshape(-1, block), p.detach().reshape(-1, block)
            for lo in range(0, g2.shape[0], 65536):
                sl = slice(lo, lo + 65536)
                upd = fused_qadam_step_plain(
                    g2[sl], p2[sl], st["mu_values"][sl], st["mu_scales"][sl],
                    st["nu_values"][sl], st["nu_scales"][sl], bc1, bc2,
                    **hyper)[0].float().abs().amax(dim=1)
                top = torch.topk(upd, min(QADAM_ROWS, upd.numel()))
                best += [(float(v), p, lo + int(i))
                         for v, i in zip(top.values, top.indices)]
        best.sort(key=lambda r: -r[0])
        return best[:QADAM_ROWS], hyper, block

    def step(self, opt, closure=None):
        first = next(p for p in opt.param_groups[0]["params"]
                     if p.grad is not None)
        count = opt.state[first]["step"] + 1
        if count not in QADAM_ROW_STEPS:
            return self.orig(opt, closure)
        picked, hyper, block = self._pick(opt)
        keep = []
        for size, p, row in picked:
            st = opt.state[p]
            r = slice(row, row + 1)
            keep.append((p, row, {
                "step": count, "leaf": self.names[id(p)], "row": row,
                "max_abs_update": size,
                "p": _b64(p.detach().reshape(-1, block)[r]),
                "g": _b64(p.grad.reshape(-1, block)[r]),
                "mu": _b64(st["mu_values"][r]),
                "mu_scale": float(st["mu_scales"][row, 0]),
                "nu": _b64(st["nu_values"][r]),
                "nu_scale": float(st["nu_scales"][row, 0])}))
        out = self.orig(opt, closure)
        for p, row, rec in keep:
            st = opt.state[p]
            r = slice(row, row + 1)
            rec.update({
                "p_new": _b64(p.detach().reshape(-1, block)[r]),
                "mu_new": _b64(st["mu_values"][r]),
                "mu_scale_new": float(st["mu_scales"][row, 0]),
                "nu_new": _b64(st["nu_values"][r]),
                "nu_scale_new": float(st["nu_scales"][row, 0])})
            self.rows.append(rec)
        self.hyper, self.block = hyper, block
        return out

    def write(self, card):
        path = os.path.join(OUT_DIR, QADAM_ROWS_FILE)
        with open(path, "w") as f:
            json.dump({"card": card, "hyper": self.hyper,
                       "block": self.block, "param_dtype": "bfloat16",
                       "rows": self.rows}, f)
        for rec in self.rows:
            log(f"11d B6 row: step {rec['step']}, {rec['leaf']} row "
                f"{rec['row']}, max |update| {rec['max_abs_update']:.6e}, "
                f"mu scale {rec['mu_scale']:.6e} -> "
                f"{rec['mu_scale_new']:.6e}, sqrt(nu) scale "
                f"{rec['nu_scale']:.6e} -> {rec['nu_scale_new']:.6e}")
        log(f"11d: {len(self.rows)} B6 rows of steps {QADAM_ROW_STEPS} "
            f"written to {path} [{card}]")


def phase_llama_losses(card):
    """11d, run on request alone (``--only 11d``): 11b's Llama-3-8B,
    plan and batch for ``LLAMA_LOSS_STEPS`` steps, once with 11b's int8
    q-AdamW and once with torch's AdamW in its place (lr 3e-4, weight
    decay 0.1, fused, its state in the params' bf16), each step's loss
    and gradient norm printed: whether a loss that climbs after 11b's
    six steps comes from the port's q-AdamW or from the setting (that lr
    with no warmup, on one batch).  Then q-AdamW's six steps followed by
    ``STALE_STEPS`` optimizer steps on the sixth step's gradients (what
    B6's timing in 11b does) and ``AFTER_STALE`` real steps, their
    losses printed.  Checks nothing but that each run ends; its Trainer
    saves nothing."""
    import logging

    import numpy as np
    import torch

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.common.log import default_logger
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_tpu_torch.models.losses import chunked_loss_fn
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    class StepLines(logging.Handler):
        """The Trainer's ``step %s loss %.4f grad_norm %.3f`` lines."""

        def __init__(self):
            super().__init__()
            self.rows = []

        def emit(self, record):
            if str(record.msg).startswith("step %s loss"):
                self.rows.append(record.args)

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    data = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, cfg.max_seq_len + 1), dtype=np.int32)
    plan = [("parallel_mode", {}), ("half", {}), ("checkpoint", {}),
            ("module_replace", {"attention": "flash"})]
    qadamw = plan + [("low_bit_opt", {
        "bits": 8, "learning_rate": 3e-4, "weight_decay": 0.1})]
    runs = (
        ("int8 q-AdamW", qadamw, None, LLAMA_LOSS_STEPS),
        ("torch AdamW", plan, lambda ps: torch.optim.AdamW(
            ps, lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1,
            fused=True), LLAMA_LOSS_STEPS),
        ("int8 q-AdamW, then B6's timing steps", qadamw, None, LLAMA_STEPS),
    )
    for name, opts, factory, steps in runs:
        lines = StepLines()
        default_logger.addHandler(lines)
        try:
            with checkpoint_scope("11d") as out:
                args = TrainingArguments(
                    output_dir=out, resume_from_checkpoint=False,
                    max_steps=steps, global_batch_size=1,
                    micro_batch_size=1, logging_steps=1, save_steps=0,
                    strategy=Strategy(opts=opts))
                trainer = Trainer(Llama(cfg, seed=0), args,
                                  [{"x": data[:, :-1], "y": data[:, 1:]}],
                                  chunked_loss_fn(num_chunks=LLAMA_CHUNKS),
                                  optim_factory=factory)
                trainer._save = lambda step, to_storage: None
                torch.cuda.reset_peak_memory_stats()
                if name == "int8 q-AdamW":
                    # the plan may rebuild the model: names by shape and
                    # order are the same, so map them at the first step
                    rows = QAdamRows(_ParamNames(trainer))
                    with rows:
                        result = trainer.train()
                    rows.write(card)
                    del rows
                else:
                    result = trainer.train()
                after = []
                if steps == LLAMA_STEPS:
                    for _ in range(STALE_STEPS):
                        trainer.state.optimizer.step()
                    placed = trainer.place_batch(trainer.train_data[0])
                    for _ in range(AFTER_STALE):
                        trainer.state, m = trainer.train_step(trainer.state,
                                                              placed)
                        after.append(float(m["loss"]))
                del trainer
        finally:
            default_logger.removeHandler(lines)
        _free_cuda()
        log(f"11d Llama-3-8B {name}, lr 3e-4, weight decay 0.1, "
            f"{steps} steps on 11b's batch: losses {result['losses']}, grad "
            f"norms {[round(float(r[2]), 3) for r in lines.rows]}, peak "
            f"{result['peak_bytes'] / 2**30:.2f} GiB"
            + (f"; then {STALE_STEPS} optimizer steps on step {steps}'s "
               f"gradients and {AFTER_STALE} steps: losses {after}"
               if after else "") + f" [{card}]")


class _ParamNames(dict):
    """``id(param) -> name`` of the trainer's model, read when first
    asked (after the plan has built the model it trains)."""

    def __init__(self, trainer):
        super().__init__()
        self.trainer = trainer

    def __missing__(self, key):
        # read once, and let the trainer go (the next run needs its memory)
        if self.trainer is not None:
            self.update({id(p): n for n, p in
                         self.trainer.model.named_parameters()})
            self.trainer = None
        return dict.__getitem__(self, key)


def phase_llama(card) -> dict:
    """Phase 11: 11a, 11b and 11c, each timed."""
    out = {}
    for name, fn, args in (("11a", phase_llama_check, ()),
                           ("11b", phase_train_llama, (card,)),
                           ("11c", phase_llama_count, (card,))):
        t0 = time.perf_counter()
        out.update(fn(*args) or {})
        _free_cuda()
        log(f"chip_smoke: phase {name} took {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 12: the data side of the agent and the node check (slice 8.1) -----

# the twin of examples/train_with_shm_loader.py: GPT-2 small, flash, seq
# 1024, batch 16 (one micro-batch: 12 launches of each flash kernel a
# step), AdamW(3e-4, 0.1), two shm workers; depth cut from 200 steps
D_STEPS = 20
D_BATCH = 16
D_KILL_STEP = 4
D_SAVE_EVERY = 2
D_EXAMPLE = "dlrover_tpu_torch/examples/train_with_shm_loader.py"
D_DATASET = "shm-example"
# the runs of phase 12: (label, the example's loader, launcher options)
D_RUNS = (("plain", "plain", ("--network-check",)),
          ("shm", "shm", ()),
          ("kill", "sharded", ()))
BF16_PEAK_TFLOPS = PEAK_FLOPS["bfloat16"] / 1e12


def data_child(label: str, workdir: str, result_path: str,
               control_path: str = "") -> int:
    """One launcher run of phase 12 in a process of its own that never
    touches CUDA (this process is the agent): ``run.main`` over the
    shm-loader example with the loader of ``label``; the kill run under
    ``kill_worker_midstep`` at step D_KILL_STEP with warm restarts and
    the dataset position in the flash checkpoint.  Its invariants are
    evaluated on its event log; the example's records and what every
    process of the run held go into ``result_path``."""
    from dlrover_tpu_torch.agent.forkserver import TRAINER_PRELOAD
    from dlrover_tpu_torch.chaos import harness, scenarios
    from dlrover_tpu_torch.chaos.schedule import Scenario

    loader, launcher_args = {r[0]: r[1:] for r in D_RUNS}[label]
    if label == "kill":
        scenario = scenarios.kill_worker_midstep(seed=L_SEED)
        scenario.rules[0].step_window = [D_KILL_STEP, D_KILL_STEP]
    else:
        scenario = Scenario.from_dict({"name": "control", "seed": 0,
                                       "rules": []})
    record = os.path.join(workdir, "record")
    env, event_log = harness.scenario_env(scenario, workdir, D_STEPS,
                                          D_SAVE_EVERY)
    # the warm template imports what the trainer needs, as phase 8b's
    env["DLROVER_PRELOAD"] = TRAINER_PRELOAD
    argv = [os.path.join(ROOT, D_EXAMPLE), "--steps", str(D_STEPS),
            "--loader", loader, "--record", record]
    if label == "kill":
        argv += ["--ckpt-dir", os.path.join(workdir, "ckpt"),
                 "--save-every", str(D_SAVE_EVERY)]
    t0 = time.time()
    with _ProcSampler(workdir) as sampler:
        rc = harness.launch(
            scenario if label == "kill" else None, env, argv,
            max_restarts=L_MAX_RESTARTS,
            monitor_interval=L_MONITOR_INTERVAL_S, warm_restart=True,
            launcher_args=launcher_args)
    wall = time.time() - t0
    report = harness._build_report(scenario, rc, workdir, event_log)
    checks = []
    if label == "kill":
        with open(control_path) as f:
            control = json.load(f)
        checks = [
            harness.WorkerRestarted(),
            harness.RendezvousReconverged(),
            harness.RestoredFromTier("shm"),
            harness.BoundedStepLoss(ckpt_interval=D_SAVE_EVERY),
            harness.NoDuplicateShards(dataset_size=D_STEPS * D_BATCH,
                                      dataset=D_DATASET),
            harness.TrainingCompleted(total_steps=D_STEPS),
            harness.LossTrajectoryMatches(control),
            harness.NoOrphanProcesses(marker=workdir),
        ]
    harness.check_invariants(report, checks)
    incarnations = []
    if os.path.isdir(record):
        for name in sorted(os.listdir(record)):
            with open(os.path.join(record, name)) as f:
                incarnations.append(json.load(f))
    result = {
        "label": label, "rc": rc, "ok": report.ok, "wall_s": wall,
        "summary": report.summary(), "timeline": report.timeline,
        "invariants": [[r.name, r.ok, r.detail] for r in report.invariants],
        "agent": {"pid": os.getpid(), "maps": _maps_cuda(os.getpid()),
                  "devices": _cuda_device_files(os.getpid()),
                  "torch_loaded": "torch" in sys.modules},
        "procs": {str(k): v for k, v in sampler.seen.items()},
        "incarnations": incarnations, "events": report.events,
    }
    with open(result_path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(result_path + ".tmp", result_path)
    return 0


def _loader_segments() -> set:
    return {n for n in os.listdir("/dev/shm") if n.startswith("shmloader_")}


def _data_run(label: str, turn: int, control_path: str = "") -> dict:
    """``data_child`` for ``label`` in a process of its own, with a short
    work directory and a job name of its own; afterwards the run's
    checkpoint segment is unlinked, and neither it nor a loader segment
    may remain."""
    workdir = tempfile.mkdtemp(prefix=f"dl12{label}")
    result_path = os.path.join(OUT_DIR, f"data_{label}.json")
    log_path = os.path.join(OUT_DIR, f"data_{label}.log")
    job = f"{os.environ['DLROVER_JOB_NAME']}_d{turn}"
    env = dict(os.environ, PYTHONPATH=ROOT, DLROVER_JOB_NAME=job)
    for key in ("DLROVER_EVENT_LOG", "DLROVER_METRICS_FILE"):
        env.pop(key, None)
    if os.path.exists(result_path):
        os.unlink(result_path)
    loaders_before = _loader_segments()
    try:
        with open(log_path, "w") as f:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--data-child",
                 label, workdir, result_path, control_path],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                timeout=600)
        if proc.returncode != 0 or not os.path.exists(result_path):
            with open(log_path) as f:
                tail = f.read()[-6000:]
            raise AssertionError(f"data run {label} ended with "
                                 f"{proc.returncode}:\n{tail}")
        with open(result_path) as f:
            result = json.load(f)
        shutil.copy(os.path.join(workdir, "events.jsonl"), os.path.join(
            OUT_DIR, f"data_{label}_events.jsonl"))
    finally:
        prefix = f"dlrover_tpu_ckpt_shm_{job}_"
        for name in os.listdir("/dev/shm"):
            if name.startswith(prefix):
                os.unlink(os.path.join("/dev/shm", name))
        shutil.rmtree(workdir, ignore_errors=True)
    result["loader_segments_left"] = sorted(_loader_segments()
                                            - loaders_before)
    return result


def _check_data_run(r, per_step, control=None) -> list:
    """The failures of one run of phase 12, as text."""
    failures = []
    incs = sorted(r["incarnations"], key=lambda i: i["restart_count"])
    bad = [inv for inv in r["invariants"] if not inv[1]]
    if r["rc"] != 0 or bad:
        failures.append(f"rc {r['rc']}, failed invariants {bad}")
    want = 2 if r["label"] == "kill" else 1
    if len(incs) != want or not incs[-1]["done"]:
        failures.append(f"{len(incs)} incarnations, not {want} ending done")
    expect = {"fwd": per_step, "bwd_dq": per_step, "bwd_dkv": per_step}
    for inc in incs:
        off = [(s["step"], s["launches"]) for s in inc["steps"]
               if s["launches"] != expect]
        if off:
            failures.append(f"incarnation {inc['restart_count']}: steps "
                            f"not launching {expect}: {off}")
        if not all(map(_finite, (s["loss"] for s in inc["steps"]))):
            failures.append(f"incarnation {inc['restart_count']}: "
                            "non-finite loss")
        if control is not None:
            differ = {s["step"]: (s["loss"], control[s["step"] - 1])
                      for s in inc["steps"]
                      if s["loss"] != control[s["step"] - 1]}
            if differ:
                failures.append(f"incarnation {inc['restart_count']}: "
                                f"losses differ from the control's "
                                f"(step: (run, control)) {differ}")
    steps = [s["step"] for s in incs[-1]["steps"]] if incs else []
    if not steps or steps[-1] != D_STEPS:
        failures.append(f"the run ended at step {steps[-1:]}, "
                        f"not {D_STEPS}")
    agent = r["agent"]
    if agent["maps"] or agent["devices"] or agent["torch_loaded"]:
        failures.append(f"the agent (pid {agent['pid']}) maps CUDA "
                        f"{agent['maps'] + agent['devices']} (torch "
                        f"loaded: {agent['torch_loaded']})")
    pids = {str(i["pid"]) for i in incs}
    workers = {p: v for p, v in r["procs"].items()
               if "multiprocessing" in v["cmdline"] and v["ppid"] and
               str(v["ppid"]) in pids}
    if r["label"] != "plain" and len(workers) < 2:
        failures.append(f"{len(workers)} shm loader workers sampled")
    for pid, v in workers.items():
        if v["devices"]:
            failures.append(f"the shm loader worker {pid} opened the "
                            f"card: {v['devices']}")
    for pid in pids:
        if pid in r["procs"] and not r["procs"][pid]["devices"]:
            failures.append(f"the trainer {pid} holds no CUDA device")
    if r["loader_segments_left"]:
        failures.append(f"loader segments left: {r['loader_segments_left']}")
    return failures


def _wait_share(inc, first: int = 3) -> tuple:
    """The input wait of the steps from ``first`` on, in seconds, and its
    share of those steps' time; and the median step's ms."""
    steps = [s for s in inc["steps"] if s["step"] >= first]
    wait = sum(s["wait_s"] for s in steps)
    total = sum(s["seconds"] for s in steps)
    return wait, wait / total, statistics.median(
        s["seconds"] for s in steps) * 1e3


def _check_network(r, card) -> list:
    """12c: the plain run's network check: one round, one node check in
    a child that held the card, the collective probe over the group of
    the host's GPUs (None on one GPU, nothing to probe), and training
    after it."""
    import torch

    gpus = torch.cuda.device_count()
    failures = []
    events = r["events"]
    checks = [e for e in events if e.get("type") == "node_check"]
    rounds = [e for e in events if e.get("type") == "rendezvous_complete"
              and e.get("rdzv") == "network-check"]
    steps = [e for e in events if e.get("type") == "train_step"]
    if len(checks) != 1 or len(rounds) != 1:
        return [f"{len(checks)} node checks in {len(rounds)} network-check "
                f"rounds, not one (an abnormal node is checked again)"]
    c = checks[0]
    if not steps or steps[0]["ts"] < c["ts"]:
        failures.append("training did not start after the network check")
    if (c["collective_s"] is None) != (gpus < 2):
        failures.append(f"{gpus} GPUs, yet the collective probe gave "
                        f"{c['collective_s']}")
    probes = [v for v in r["procs"].values()
              if "dlrover_tpu_torch.agent.node_check" in v["cmdline"]]
    if not probes or not any(v["devices"] for v in probes):
        failures.append(f"no node-check child held the card: {probes}")
    tflops = c["matmul_flops"] / c["matmul_s"] / 1e12
    log(f"12c network check: one round, the node normal, training started "
        f"{steps[0]['ts'] - c['ts']:.3f} s after the check; "
        f"bm_chip_matmul ({c['matmul_size']}^2 bf16, 8 rounds of 4 GEMMs) "
        f"{c['matmul_s'] * 1e3:.4f} ms on the device, {tflops:.1f} TFLOP/s "
        f"against the bf16 peak of {BF16_PEAK_TFLOPS:.0f} "
        f"({tflops / BF16_PEAK_TFLOPS:.4f}); the check's work "
        f"{c['elapsed_s']:.4f} s; the collective probe over {gpus} GPUs "
        f"returned {c['collective_s']}"
        + (" (one GPU: nothing to probe)" if gpus < 2 else " s")
        + f" [{card}]")
    return failures


def phase_data(card) -> dict:
    """Phase 12: slice 8.1 on the card — the shm-loader example's twin
    at GPT-2 small's full width through ``python -m
    dlrover_tpu_torch.run --warm-restart``: 12a the plain elastic loader
    (after a ``--network-check``, 12c) and the shm loader on the same
    indices, losses bit for bit equal; 12b the sharded run SIGKILLed at
    step D_KILL_STEP, respawned, restored from shm with its dataset
    position, every sample index acked once.  Returns the launch counts
    of the runs, summed over their incarnations."""
    from dlrover_tpu_torch.models.gpt import GPTConfig

    per_step = GPTConfig.gpt2_small().num_layers
    tokens = D_BATCH * SMALL_SEQ
    runs, failures, counts = {}, [], {}
    control_path = os.path.join(OUT_DIR, "data_control_losses.json")
    for turn, (label, _loader, _args) in enumerate(D_RUNS):
        t0 = time.perf_counter()
        control = None
        if label == "kill":
            control = [s["loss"] for s in
                       runs["shm"]["incarnations"][0]["steps"]]
            with open(control_path, "w") as f:
                json.dump(control, f)
        r = _data_run(label, turn, control_path)
        runs[label] = r
        bad = _check_data_run(r, per_step, control)
        if label == "plain":
            bad += _check_network(r, card)
        failures += [f"12 {label}: {f}" for f in bad]
        summed = _zero_counts()
        for inc in r["incarnations"]:
            for s in inc["steps"]:
                for k, v in s["launches"].items():
                    summed[f"flash_attention.{k}"] += v
        counts[f"data_{label}"] = summed
        log(f"12 {label}: {r['wall_s']:.1f} s in the launcher, phase "
            f"{time.perf_counter() - t0:.1f} s, invariants "
            f"{[(n, ok) for n, ok, _ in r['invariants']]}")
        if bad:
            raise AssertionError("data: " + "; ".join(failures))
    plain = runs["plain"]["incarnations"][0]
    shm = runs["shm"]["incarnations"][0]
    lp = [s["loss"] for s in plain["steps"]]
    ls = [s["loss"] for s in shm["steps"]]
    if lp != ls:
        failures.append(f"12a: the loaders' losses differ: {lp} against {ls}")
    for name, inc in (("ElasticDataLoader", plain), ("ShmDataLoader", shm)):
        wait, share, med = _wait_share(inc)
        all_wait = sum(s["wait_s"] for s in inc["steps"])
        losses = [round(s["loss"], 6) for s in inc["steps"]]
        log(f"12a {name}: losses {losses}; "
            f"input wait steps 3..{D_STEPS} {wait * 1e3:.3f} ms, "
            f"{share:.4f} of those steps, {all_wait:.3f} s over all "
            f"{D_STEPS} (step 1 starts the workers); median step "
            f"{med:.3f} ms, {tokens / med * 1e3:.1f} tokens/s; exactly "
            f"{per_step} launches of each flash kernel a step"
            + (f"; loader stats {inc['loader_stats']}"
               if inc.get("loader_stats") else "") + f" [{card}]")
    kill = runs["kill"]
    events = kill["events"]
    inj = next(e for e in events if e.get("type") == "chaos_inject")
    witnessed = next(e for e in events if e.get("type") == "worker_restart")
    first = next(e for e in events if e.get("type") == "train_step"
                 and e.get("restart_count", 0) > 0)
    inc1 = max(kill["incarnations"], key=lambda i: i["restart_count"])
    acks = sorted((e["start"], e["end"]) for e in events
                  if e.get("type") == "shard_ack" and e.get("success"))
    log(f"12b: killed at step {inj.get('step')}, restored at step "
        f"{inc1['start_step']} from {inc1['restore'].get('tier')} with its "
        f"dataset position; {len(acks)} shards acked, each once, covering "
        f"samples 0..{acks[-1][1] - 1}; kill -> first step "
        f"{first['ts'] - inj['ts']:.3f} s: detection "
        f"{witnessed['ts'] - inj['ts']:.3f} s, recovery phases "
        f"{json.dumps(inc1['phases'])}, restore "
        f"{json.dumps(inc1['restore'])}; every loss equals the shm "
        f"control's bit for bit [{card}]")
    if failures:
        raise AssertionError("data: " + "; ".join(failures))
    return counts


# -- phase 13: sequence and expert parallelism (slice 5.2) -------------------

# 13a: the ring's blocks at Llama-3-8B's attention shape (b, s, q heads,
# kv heads, d), bf16, cut into RING_SP shards of one process
RING_SHAPE = (1, 8192, 32, 8, 128)
RING_SP = 4
# ||ring - reference|| / ||reference|| of O, dQ, dK and dV (bf16) against
# the whole-sequence B1-B3 and against the plain ring in fp32: phase 4's
# bf16 limit, 8 bf16 unit roundoffs (the ring rounds each block's O and
# partial gradients to bf16 once more before its fp32 sums); of the
# merged lse (fp32 sums in another order): 1e-5.  Written in PERF.md
# before the first run.
RING_REL_NORM = {"out": 8 * 2.0 ** -8, "lse": 1e-5, "dq": 8 * 2.0 ** -8,
                 "dk": 8 * 2.0 ** -8, "dv": 8 * 2.0 ** -8}
RING_TIMING_REPS = 5
# 13b: the Mixtral twin, 32 layers cut to 2 and 20 steps to 6
MIXTRAL_LAYERS, MIXTRAL_STEPS = 2, 6


def _ring_counts(causal: bool) -> dict:
    n = RING_SP * (RING_SP + 1) // 2 if causal else RING_SP * RING_SP
    return _zero_counts(**{f"flash_attention.{k}": n
                           for k in ("fwd", "bwd_dq", "bwd_dkv")})


def _plain_block_fwd(q, k, v, scale, causal):
    from dlrover_tpu_torch.ops import flash_attention as fa

    return fa.fwd_plain(q, k, v, scale, causal, 512, 512)


def _plain_block_bwd(q, k, v, out, dout, lse, scale, causal):
    from dlrover_tpu_torch.ops import flash_attention as fa

    delta = fa.delta_plain(out, dout)
    dq = fa.bwd_dq_plain(q, k, v, dout, lse, delta, scale, causal, 512, 512)
    dk, dv = fa.bwd_dkv_plain(q, k, v, dout, lse, delta, scale, causal, 512,
                              512)
    return dq, dk, dv


def _ring(qs, ks, vs, douts, scale, causal, merge=None, block_fwd=None,
          block_bwd=None):
    """The ring over the shards in one process: ``{"out", "lse", "dq",
    "dk", "dv"}`` whole, O and the gradients in the inputs' dtype (what
    the rank loop returns), lse fp32."""
    import torch

    from dlrover_tpu_torch.parallel import sequence as sq

    kw = {k: v for k, v in (("merge", merge), ("block_fwd", block_fwd))
          if v is not None}
    outs, lses = sq.ring_forward_shards(qs, ks, vs, scale, causal, **kw)
    outs = [o.to(qs[0].dtype) for o in outs]
    dqs, dks, dvs = sq.ring_backward_shards(
        qs, ks, vs, outs, douts, lses, scale, causal,
        **({"block_bwd": block_bwd} if block_bwd else {}))
    dt = qs[0].dtype
    return {"out": torch.cat(outs, 1), "lse": torch.cat(lses, 2),
            "dq": torch.cat(dqs, 1).to(dt), "dk": torch.cat(dks, 1).to(dt),
            "dv": torch.cat(dvs, 1).to(dt)}


def _ring_norms(got, want) -> dict:
    return {k: _rel_norm(got[k], want[k]) for k in RING_REL_NORM}


def _faulty_merge():
    """``ring_merge`` with one block (rank 1's second, src 0: the first
    merge past a rank's first block) folded in with weight 1 instead of
    ``exp(lse_blk - lse)``."""
    from dlrover_tpu_torch.parallel.sequence import ring_merge

    planted = []

    def merge(acc, lse, o, l):
        if acc is not None and not planted:
            import torch

            planted.append(True)
            new = torch.logaddexp(lse, l)
            w_old = torch.exp(lse - new).transpose(1, 2)[..., None]
            return acc * w_old + o.float(), new
        return ring_merge(acc, lse, o, l)

    return merge


def phase_ring_blocks(card) -> dict:
    """13a: the ring's per-block steps (B1 per visible block, merged by
    lse in fp32; B2 and B3 per block with the merged lse and O) over
    ``RING_SP`` shards of Llama-3-8B's attention in one process, causal
    and not: O, lse, dQ, dK and dV against the whole-sequence B1-B3 and
    against the plain ring in fp32 (``RING_REL_NORM``); a planted fault
    (one block merged without its lse correction) must fail; exact
    launches (causal 10 of each kernel: 4 diagonal blocks and 6 full
    ones, 6 skipped; non-causal 16); the ring's forward and backward
    timed against the whole-sequence kernels'."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    b, s, h, kvh, d = RING_SHAPE
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(13)

    def rand(heads):
        return torch.randn(b, s, heads, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    out = {}
    failures = []
    for causal in (True, False):
        label = f"13a ring {'causal' if causal else 'non-causal'}"
        q, k, v, dout = rand(h), rand(kvh), rand(kvh), rand(h)
        shards = [list(x.chunk(RING_SP, dim=1)) for x in (q, k, v, dout)]
        # the whole sequence through B1-B3 (not counted)
        o_w, lse_w = fa.fwd_cuda(q, k, v, scale, causal)
        dq_w, delta_w = fa.bwd_dq_cuda(q, k, v, o_w, dout, lse_w, scale,
                                       causal)
        dk_w, dv_w = fa.bwd_dkv_cuda(q, k, v, dout, lse_w, delta_w, scale,
                                     causal)
        whole = {"out": o_w, "lse": lse_w, "dq": dq_w, "dk": dk_w,
                 "dv": dv_w}
        torch.cuda.synchronize()
        reset_launch_counts()
        got = _ring(*shards, scale, causal)
        torch.cuda.synchronize()
        counts = launch_counts()
        out[f"ring_blocks_llama3_8b_{'causal' if causal else 'full'}"] = \
            counts
        # the plain ring in fp32 on the same inputs
        plain = _ring(*[[x.float() for x in xs] for xs in shards], scale,
                      causal, block_fwd=_plain_block_fwd,
                      block_bwd=_plain_block_bwd)
        vs_whole, vs_plain = _ring_norms(got, whole), _ring_norms(got, plain)
        whole_vs_plain = _ring_norms(whole, plain)
        fault = _ring_norms(_ring(*shards, scale, causal,
                                  merge=_faulty_merge()), whole)
        log(f"{label} (b {b}, s {s} in {RING_SP} shards of {s // RING_SP}, "
            f"{h} q heads over {kvh} kv heads, d {d}, bf16): "
            f"||ring - whole B1-B3|| / ||whole|| "
            + ", ".join(f"{k} {v:.3e}" for k, v in vs_whole.items())
            + "; against the plain ring in fp32 "
            + ", ".join(f"{k} {v:.3e}" for k, v in vs_plain.items())
            + " (the whole-sequence kernels' own: "
            + ", ".join(f"{k} {v:.3e}" for k, v in whole_vs_plain.items())
            + f"); limits {RING_REL_NORM}")
        log(f"{label}: planted fault (one block merged without its lse "
            f"correction): " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in fault.items()))
        log(f"{label}: launches {counts}, expected {_ring_counts(causal)}")
        for name, norms in (("whole", vs_whole), ("plain", vs_plain)):
            for key, value in norms.items():
                if not value <= RING_REL_NORM[key]:
                    failures.append(f"{label} {key} against {name} "
                                    f"{value:.3e}")
        if fault["out"] <= RING_REL_NORM["out"]:
            failures.append(f"{label}: the planted fault passed "
                            f"({fault['out']:.3e})")
        if counts != _ring_counts(causal):
            failures.append(f"{label}: launches {counts}")
        # time the ring (every shard, one process) against the whole
        cyc = 20 * SLEEP_CYCLES

        def ring_fwd():
            from dlrover_tpu_torch.parallel import sequence as sq

            return sq.ring_forward_shards(*shards[:3], scale, causal)

        fwd_out = ring_fwd()
        outs = [o.to(torch.bfloat16) for o in fwd_out[0]]

        def ring_bwd():
            from dlrover_tpu_torch.parallel import sequence as sq

            return sq.ring_backward_shards(*shards[:3], outs, shards[3],
                                           fwd_out[1], scale, causal)

        def whole_bwd():
            dq, delta = fa.bwd_dq_cuda(q, k, v, o_w, dout, lse_w, scale,
                                       causal)
            return fa.bwd_dkv_cuda(q, k, v, dout, lse_w, delta, scale, causal)

        ms = {
            "ring_fwd": median_ms(ring_fwd, RING_TIMING_REPS,
                                  sleep_cycles=cyc),
            "whole_fwd": median_ms(lambda: fa.fwd_cuda(q, k, v, scale,
                                                       causal),
                                   RING_TIMING_REPS, sleep_cycles=cyc),
            "ring_bwd": median_ms(ring_bwd, RING_TIMING_REPS,
                                  sleep_cycles=cyc),
            "whole_bwd": median_ms(whole_bwd, RING_TIMING_REPS,
                                   sleep_cycles=cyc),
        }
        log(f"{label}: ring forward {ms['ring_fwd']:.4f} ms against the "
            f"whole-sequence B1 {ms['whole_fwd']:.4f} ms "
            f"({ms['ring_fwd'] / ms['whole_fwd']:.3f}x); ring backward "
            f"{ms['ring_bwd']:.4f} ms against B2 + B3 "
            f"{ms['whole_bwd']:.4f} ms "
            f"({ms['ring_bwd'] / ms['whole_bwd']:.3f}x), medians of "
            f"{RING_TIMING_REPS} on the device [{card}]")
        del q, k, v, dout, shards, whole, got, plain, outs, fwd_out
        _free_cuda()
    if failures:
        raise AssertionError("13a: " + "; ".join(failures))
    return out


def phase_mixtral(card) -> dict:
    """13b: the twin of ``examples/train_mixtral.py`` at full width
    (``mixtral_8x7b``: d 4096, mlp 14336, 8 experts top-2, 32 q heads over
    8 kv heads, vocab 32000) cut to 2 layers, batch 8 x 1024, the
    reference's strategy at expert 1 plus ``module_replace(flash)``,
    AdamW 3e-4, 6 steps on one fixed batch: a finite loss that falls,
    the aux loss, the median step, tokens/s, MFU (6 FLOPs per active
    weight per token: attention, the router, 2 of the 8 experts, the
    head; plus causal attention's 6 L s d; the dispatch einsums not
    counted), the peak, and exactly 2 B1 (remat), 1 B2 and 1 B3 a layer
    a step.  Then the twin's ``--smoke`` on the card."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.examples import train_mixtral as tm
    from dlrover_tpu_torch.models.gpt import count_params
    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.parallel.moe import collect_moe_aux_loss

    label = "13b Mixtral-8x7B, 2 layers"
    cfg = LlamaConfig.mixtral_8x7b(num_layers=MIXTRAL_LAYERS)
    batch, seq = tm.batch_shape(False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    flash = [("module_replace", {"attention": "flash"})]
    run = tm.train(cfg, batch, seq, MIXTRAL_STEPS,
                   plan=tm.strategy(cfg.moe_experts, 1, flash), log_every=0)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    model = run["result"].model
    got = model.config
    aux = float(collect_moe_aux_loss(model).detach())
    n_params = count_params(model)
    e, k, layers = cfg.moe_experts, cfg.moe_top_k, cfg.num_layers
    expert_w = sum(p.numel() for n, p in model.named_parameters()
                   if "experts_w" in n)
    active = n_params - model.wte.weight.numel() - expert_w * (e - k) // e
    tokens = batch * seq
    flops = 6 * tokens * (active + layers * seq * cfg.hidden_dim)
    step_s = statistics.median(run["seconds"][2:])
    losses = run["losses"]
    expected = _flash_expected(layers, 1, MIXTRAL_STEPS, True)
    log(f"{label}: {n_params} params ({active} active a token), mesh "
        f"{run['mesh']}, attention {got.attention_impl}, remat {got.remat}; "
        f"losses {losses}, aux loss (last forward) {aux:.6f}")
    log(f"{label}: median step {step_s * 1e3:.3f} ms over steps "
        f"3..{MIXTRAL_STEPS} ({[round(t * 1e3, 3) for t in run['seconds']]}"
        f" ms), {tokens / step_s:.1f} tokens/s, MFU "
        f"{flops / step_s / PEAK_FLOPS['bfloat16']:.4f} of 989 TFLOP/s "
        f"({flops:.4e} FLOPs a step), peak {peak / 2**30:.2f} GiB; launches "
        f"{counts}, expected {expected} [{card}]")
    failures = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"losses {losses}")
    if counts != expected:
        failures.append(f"launches {counts} != {expected}")
    if not (got.attention_impl == "flash" and got.remat):
        failures.append(f"the plan did not reach the model: {got}")
    # one more step under the profiler, after the counts were read
    res = run["result"]
    profile_step(types.SimpleNamespace(
        place_batch=res.place_batch, train_step=res.train_step,
        state=run["state"]), run["batch"], card, "Mixtral-8x7B 2 layers")
    del run, model, res
    _free_cuda()
    t0 = time.perf_counter()
    tm.main(["--smoke", "--steps", str(MIXTRAL_STEPS)])
    log(f"13b the twin's --smoke on the card: {time.perf_counter() - t0:.1f}"
        " s")
    if failures:
        raise AssertionError("13b: " + "; ".join(failures))
    return {"mixtral_8x7b_2_layers": counts}


def phase_parallel(card) -> dict:
    """Phase 13: 13a and 13b, each timed."""
    out = {}
    for name, fn in (("13a", phase_ring_blocks), ("13b", phase_mixtral)):
        t0 = time.perf_counter()
        out.update(fn(card))
        _free_cuda()
        log(f"chip_smoke: phase {name} took {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 14: the rest of scale-out (slice 4.3) -------------------------------

SCALE_STEPS = 6
# 14a: the unwrapped run's steps, against the FSDP2 run's first ones
SCALE_COMPARE_STEPS = 3
# 14b: steps before the save, and replayed after the restore; layers:
# FSDP2 on one rank holds a gathered copy of each layer (and its
# gradient) beside the shard, and at 2 layers fp32 params, gradients,
# moments and those copies run out of an 80 GB card in the restored
# plan's first step (PERF.md §4), so 1
MOE_CKPT_STEPS, MOE_REPLAY_STEPS = 2, 2
MOE_CKPT_LAYERS = 1
# 14b: the shm segment and its headroom for a snapshot of fp32 params
# and AdamW moments (12 bytes a parameter)
MOE_SHM_HEADROOM = 1.25
OFFLOAD_STEPS = 3
# 14d: GPT-2 small's tree, this many replicas stacked; the outer step's
# reduce methods, each on the card against the same step on the CPU
DILOCO_REPLICAS = 4
DILOCO_METHODS = (
    ("linear", dict(reduce_method="linear")),
    ("gta_sum", dict(reduce_method="gta", consensus="sum")),
    ("gta_count", dict(reduce_method="gta", consensus="count")),
    ("sparsify_magnitude", dict(reduce_method="sparsify", density=0.1)),
    ("gta_magnitude", dict(reduce_method="gta", sparsification="magnitude",
                           density=0.5)),
)
# the leaves the CPU steps too (its time grows with the tree): GPT-2
# small's tables and its first block
DILOCO_CPU_LEAVES = ("wte.", "wpe.", "blocks.0.")
# an element whose reduction the card and the CPU sum in another order
# may flip a gta sign vote that sits within rounding of 0: at most this
# share of a leaf's elements may differ beyond rtol 1e-5
DILOCO_FLIP_SHARE = 1e-6


def _piece_expected(n_params, steps):
    """Launches of 4-bit q-AdamW over DTensor leaves in ``steps`` steps:
    each leaf's two moments dequantized (B5), their block maxima (B4
    pass 1) and their codes (B4 pass 2), once each a step."""
    return {"quantization.dequantize_pieces": 2 * n_params * steps,
            "quantization.absmax_pieces": 2 * n_params * steps,
            "quantization.quantize_pieces": 2 * n_params * steps}


def phase_llama_4bit_fsdp(card) -> dict:
    """14a: Llama-3-8B at full width and depth (11b's model and batch,
    seq 8192, bf16 params) through ``Trainer(strategy=[fsdp, half,
    checkpoint, module_replace(flash), low_bit_opt(4)])`` on a one-rank
    NCCL group: 4-bit q-AdamW state over FSDP2's DTensors (the split-
    block launches), B1-B3, ``chunked_loss_fn(8)``, 6 steps; finite
    falling losses, within rtol 1e-3 of the same plan without ``fsdp``
    (plain tensors, the whole-block 4-bit path) over its 3 steps; exact
    launches of every kernel; the median step, tokens/s, MFU and peak."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.common.device import is_dtensor
    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.models.losses import chunked_loss_fn

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    n_params = 9 * cfg.num_layers + 3
    opts = [("half", {}), ("checkpoint", {}),
            ("module_replace", {"attention": "flash"}),
            ("low_bit_opt", {"bits": 4, "learning_rate": 3e-4,
                             "weight_decay": 0.1})]
    steps, compare = SCALE_STEPS, SCALE_COMPARE_STEPS
    # the plain 4-bit path: B4 (mu's codes) at init and a step, B5 (mu's
    # values) a step; nu's sqrt-domain codec is plain tensor ops
    plain_expected = _flash_expected(cfg.num_layers, 1, compare, True)
    plain_expected.update({"quantization.quantize": n_params * (compare + 1),
                           "quantization.dequantize": n_params * compare})
    _, plain, _ = run_training(
        "14a Llama-3-8B 4-bit q-AdamW, plain tensors", cfg, 1, 1, compare,
        plain_expected, card, strategy=Strategy(opts=[
            ("parallel_mode", {})] + opts),
        loss_fn=chunked_loss_fn(num_chunks=LLAMA_CHUNKS), save_final=False)
    _free_cuda()
    expected = _flash_expected(cfg.num_layers, 1, steps, True)
    expected.update(_piece_expected(n_params, steps))
    tmp = tempfile.mkdtemp(prefix="scale14a_", dir=OUT_DIR)
    _one_rank_group(tmp)
    try:
        trainer, result, counts = run_training(
            "14a Llama-3-8B 4-bit q-AdamW under FSDP2", cfg, 1, 1, steps,
            expected, card, strategy=Strategy(opts=[("fsdp", {})] + opts),
            loss_fn=chunked_loss_fn(num_chunks=LLAMA_CHUNKS),
            save_final=False)
        model = trainer.model
        dtensors = all(is_dtensor(p) for p in model.parameters())
        del trainer, model
        _free_cuda()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    losses, want = result["losses"], plain["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    log(f"14a: FSDP2 losses {losses} against plain {want} (relative "
        f"{[f'{r:.3e}' for r in rel]}, rtol 1e-3); parameters DTensors "
        f"{dtensors}; peaks {result['peak_bytes'] / 2**30:.2f} GiB (FSDP2) "
        f"and {plain['peak_bytes'] / 2**30:.2f} GiB (plain) [{card}]")
    if not dtensors:
        raise AssertionError("14a: the FSDP2 plan left plain parameters")
    if not np.allclose(losses[:compare], want, rtol=1e-3, atol=1e-5):
        raise AssertionError(f"14a: losses {losses} vs plain {want}")
    return {"llama3_8b_4bit_fsdp": counts}


def _moe_plan_opts():
    return [("fsdp", {}), ("amp_native", {}), ("checkpoint", {}),
            ("module_replace", {"attention": "flash"})]


def _moe_tree(result):
    from dlrover_tpu_torch.utils.convert import adamw_state_tree, params_tree

    return {"params": params_tree(result.model),
            "opt_state": adamw_state_tree(result.state.optimizer,
                                          result.model)}


def phase_mixtral_ckpt(card) -> dict:
    """14b: Mixtral-8x7B at full width cut to ``MOE_CKPT_LAYERS`` layer
    (13b's model at 1 layer, its batch) under FSDP2 on a one-rank NCCL
    group, its expert kernels DTensors like every parameter, AdamW: 2
    steps, a flash checkpoint of the params and AdamW moments (fp32, ~19
    GB) to shm, 2 more steps (the control); then a fresh plan (weights
    from another seed) restores from shm through
    ``load_checkpoint(target_state=...)`` and replays the two steps:
    losses within rtol 1e-3 / atol 1e-5 of the control's (bit equality
    reported), exact launches.  The Trainer's own resume restores params
    only, as the reference's, so the moments ride the checkpoint here
    directly."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.checkpoint.checkpointer import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common.device import is_dtensor
    from dlrover_tpu_torch.examples import train_mixtral as tm
    from dlrover_tpu_torch.models.gpt import count_params
    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.utils.convert import adamw_state_from_tree

    layers = MOE_CKPT_LAYERS
    need = MOE_SHM_HEADROOM * 12 * count_params_meta(
        LlamaConfig.mixtral_8x7b(num_layers=layers))
    free = shutil.disk_usage("/dev/shm").free
    log(f"14b: /dev/shm has {free / 1e9:.1f} GB free, the snapshot needs "
        f"{need / 1e9:.1f} GB with headroom")
    if free < need:
        raise AssertionError("14b: /dev/shm is too small for the snapshot")
    cfg = LlamaConfig.mixtral_8x7b(num_layers=layers)
    b, s = tm.batch_shape(False)
    plan = Strategy(opts=_moe_plan_opts())
    tmp = tempfile.mkdtemp(prefix="scale14b_", dir=OUT_DIR)
    _one_rank_group(tmp)
    out = {}
    try:
        with checkpoint_scope("14b_mixtral") as ckdir:
            reset_launch_counts()
            run = tm.train(cfg, b, s, MOE_CKPT_STEPS, plan=plan, log_every=0)
            res, state, batch = run["result"], run["state"], run["batch"]
            n_params = count_params(res.model)
            AsyncCheckpointSaver.reset()
            ckpt = Checkpointer(ckdir, replicated=False,
                                async_snapshot=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not ckpt.save_checkpoint(MOE_CKPT_STEPS, _moe_tree(res),
                                        storage_type=StorageType.MEMORY):
                raise AssertionError("14b: the shm save was skipped")
            save_s = time.perf_counter() - t0
            phases = dict(ckpt._engine.last_save_phases)
            placed = res.place_batch(batch)
            reset_launch_counts()
            control, control_s = [], []
            for _ in range(MOE_REPLAY_STEPS):
                t0 = time.perf_counter()
                state, metrics = res.train_step(state, placed)
                control.append(float(metrics["loss"]))
                control_s.append(round((time.perf_counter() - t0) * 1e3, 3))
            control_counts = launch_counts()
            first, first_s = run["losses"], run["seconds"]
            del run, res, state, placed
            _free_cuda()
            # the fresh plan restores through the same engine, whose
            # in-process saver holds the segment's metadata (an agent's
            # saver would, across a restart)
            fresh = tm.train(cfg, b, s, 0, plan=plan, seed=1, log_every=0)
            res = fresh["result"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step, restored = ckpt.load_checkpoint(target_state=_moe_tree(res))
            adamw_state_from_tree(restored["opt_state"], res.state.optimizer,
                                  res.model)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            tier = ckpt.last_restore_phases.get("tier")
            ckpt.close()
            del restored
            state, placed = res.state, res.place_batch(batch)
            reset_launch_counts()
            replay = []
            for _ in range(MOE_REPLAY_STEPS):
                state, metrics = res.train_step(state, placed)
                replay.append(float(metrics["loss"]))
            counts = launch_counts()
            dtensor = is_dtensor(res.model.blocks[0].moe.experts_w_in)
            del fresh, res, state, placed
            _free_cuda()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    nbytes = 12 * n_params
    expected = _flash_expected(layers, 1, MOE_REPLAY_STEPS, True)
    log(f"14b Mixtral-8x7B {layers} layers under FSDP2 ({n_params} params, "
        f"experts DTensors {dtensor}): losses {first} (steps "
        f"{[round(t * 1e3, 3) for t in first_s]} ms), then control "
        f"{control} ({control_s} ms) and replay from {tier} at step {step} {replay} (bit "
        f"equal {control == replay}); shm save of {nbytes / 1e9:.2f} GB "
        f"{save_s:.2f} s ({phases}), restore {restore_s:.2f} s; launches "
        f"{counts}, expected {expected} [{card}]")
    failures = []
    if step != MOE_CKPT_STEPS or tier != "shm":
        failures.append(f"restored step {step} from {tier}")
    if not dtensor:
        failures.append("the expert kernels are not DTensors")
    if not (all(np.isfinite(first + control)) and control[-1] < first[0]):
        failures.append(f"losses {first} {control}")
    if not np.allclose(replay, control, rtol=1e-3, atol=1e-5):
        failures.append(f"replay {replay} vs control {control}")
    if counts != expected or control_counts != expected:
        failures.append(f"launches {counts} / {control_counts} != "
                        f"{expected}")
    if failures:
        raise AssertionError("14b: " + "; ".join(failures))
    out["mixtral_fsdp_ckpt_replay"] = counts
    return out


def count_params_meta(cfg) -> int:
    """The parameter count of a Llama config, built on ``meta``."""
    from dlrover_tpu_torch.models.gpt import count_params
    from dlrover_tpu_torch.models.llama import Llama

    return count_params(Llama(cfg, device="meta"))


def _pinned_state_bytes(optimizer) -> int:
    import torch

    from dlrover_tpu_torch.optim.offload import HostShard

    total = 0
    for st in optimizer.state.values():
        for v in st.values():
            t = v.local if isinstance(v, HostShard) else v
            if torch.is_tensor(t) and t.dim() and t.is_pinned():
                total += t.numel() * t.element_size()
    return total


def phase_offload_fsdp(card) -> dict:
    """14c: ``offload_opt`` at GPT-2 XL (9c's model, batch and remat)
    under FSDP2 on a one-rank NCCL group, AdamW's moments held by shard
    in pinned host memory, against the same plan without ``fsdp`` (9c's
    offload run): losses within rtol 1e-3, exact launches, the state on
    the host, both peaks and step times."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.optim.offload import HostShard

    cfg = GPTConfig.gpt2_xl(attention_impl="flash", remat=True)
    batch = _xl_batch(cfg.vocab_size)
    base = [("amp_native", {}), ("module_replace", {"attention": "flash"}),
            ("checkpoint", {}), ("offload_opt", {})]
    runs = {}
    tmp = tempfile.mkdtemp(prefix="scale14c_", dir=OUT_DIR)
    _one_rank_group(tmp)
    try:
        for label, first in (("plain", ("parallel_mode", {})),
                             ("fsdp", ("fsdp", {}))):
            model = GPT(cfg, seed=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            result = auto_accelerate(model, _adamw_factory(3e-4, 0.1),
                                     _loss_fn, batch,
                                     strategy=Strategy(opts=[first] + base))
            del model
            losses, secs = _train(result, batch, OFFLOAD_STEPS)
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            opt = result.state.optimizer
            shards = sum(isinstance(v, HostShard) for st in opt.state.values()
                         for v in st.values())
            host = _pinned_state_bytes(opt)
            runs[label] = (losses, peak, statistics.median(secs[1:]),
                           counts, shards, host)
            log(f"14c {label} offload_opt: losses {losses}, peak "
                f"{peak / 2**30:.2f} GiB, state in pinned host memory "
                f"{host / 1e9:.2f} GB ({shards} DTensor states by shard), "
                f"median step {runs[label][2] * 1e3:.3f} ms over steps "
                f"2..{OFFLOAD_STEPS} [{card}]")
            del result, opt
            _free_cuda()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    (l0, p0, t0, c0, _, h0), (l1, p1, t1, c1, n1, h1) = (runs["plain"],
                                                         runs["fsdp"])
    want = _flash_expected(cfg.num_layers, 1, OFFLOAD_STEPS, True)
    failures = []
    if not np.allclose(l1, l0, rtol=1e-3):
        failures.append(f"losses {l1} vs {l0}")
    if c0 != want or c1 != want:
        failures.append(f"launches {c0} / {c1}, expected {want}")
    if not n1 or h1 < 0.9 * h0:
        failures.append(f"FSDP2's state on the host: {n1} shards, "
                        f"{h1 / 1e9:.2f} GB against {h0 / 1e9:.2f} GB")
    log(f"14c offload_opt under FSDP2: peak {p1 / 2**30:.2f} GiB against "
        f"{p0 / 2**30:.2f} GiB without it, step {t1 * 1e3:.3f} ms against "
        f"{t0 * 1e3:.3f} ms [{card}]")
    if failures:
        raise AssertionError("14c: " + "; ".join(failures))
    return {"gpt2_xl_fsdp_offload": c1}


def phase_diloco(card) -> dict:
    """14d: DiLoCo's outer step (``optim/local_sgd.py``) on the card over
    GPT-2 small's tree stacked 4 times (the replicas drifted from the
    anchor by seeded noise), each reduce method of ``DILOCO_METHODS``
    against the same step on the CPU (over ``DILOCO_CPU_LEAVES``, each
    leaf's step independent of the others): anchors and momenta within rtol
    1e-5 / atol 1e-7 but for at most ``DILOCO_FLIP_SHARE`` of a leaf's
    elements (a gta sign vote at a tie); ``rescaled_random`` draws on
    the card's generator and keeps the expectation; each method's time
    on the card beside its bytes bound."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.optim.local_sgd import (
        diloco_outer_step,
        init_diloco,
    )

    shapes = {n: tuple(p.shape) for n, p in GPT(
        GPTConfig.gpt2_small(), device="meta").named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(14)
    anchor = {n: torch.randn(sh, generator=gen, device="cuda") * 0.02
              for n, sh in shapes.items()}
    local = {n: a[None] + torch.randn((DILOCO_REPLICAS, *a.shape),
                                      generator=gen, device="cuda") * 1e-3
             for n, a in anchor.items()}
    numel = sum(a.numel() for a in anchor.values())
    checked = [n for n in shapes if n.startswith(DILOCO_CPU_LEAVES)]
    cpu_anchor = {n: anchor[n].cpu() for n in checked}
    cpu_local = {n: local[n].cpu() for n in checked}
    # bytes the step must move: the stacked replicas read and written,
    # the anchor and momentum read and written
    bound = _bound((2 * DILOCO_REPLICAS + 4) * numel * 4,
                   10 * DILOCO_REPLICAS * numel, "float32")
    failures = []
    for label, kw in DILOCO_METHODS:
        state = init_diloco(anchor)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_local, new_state = diloco_outer_step(local, state, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        _, want = diloco_outer_step(cpu_local, init_diloco(cpu_anchor), **kw)
        worst, flips = 0.0, 0
        for which in ("anchor_params", "momentum"):
            got_t, want_t = getattr(new_state, which), getattr(want, which)
            for n in checked:
                got, ref = got_t[n].cpu(), want_t[n]
                bad = ~torch.isclose(got, ref, rtol=1e-5, atol=1e-7)
                flips = max(flips, int(bad.sum()))
                if bad.float().mean() > DILOCO_FLIP_SHARE:
                    failures.append(f"{label} {which} {n}: {int(bad.sum())}"
                                    f" of {ref.numel()} beyond rtol 1e-5")
                worst = max(worst, float((got - ref).abs().max()))
        synced = all(torch.equal(new_local[n][r], new_state.anchor_params[n])
                     for n in shapes for r in range(DILOCO_REPLICAS))
        if not synced:
            failures.append(f"{label}: the replicas did not take the anchor")
        log(f"14d DiLoCo {label} over {DILOCO_REPLICAS} replicas of GPT-2 "
            f"small ({numel} params each): {ms:.3f} ms on the card (host "
            f"clock, synchronised), bound {bound[0]:.3f} ms ({bound[1]}); "
            f"against the CPU largest difference {worst:.3e}, at most "
            f"{flips} elements of a leaf beyond rtol 1e-5 [{card}]")
        del new_local, new_state, want
    gen_r = torch.Generator(device="cuda").manual_seed(3)
    ones = {n: torch.ones(DILOCO_REPLICAS, *sh, device="cuda")
            for n, sh in list(shapes.items())[:4]}
    zero = {n: torch.zeros(sh, device="cuda") for n, sh in
            list(shapes.items())[:4]}
    _, st = diloco_outer_step(
        ones, init_diloco(zero), outer_lr=1.0, outer_momentum=0.0,
        nesterov=False, reduce_method="sparsify",
        sparsification="rescaled_random", density=0.5, generator=gen_r)
    mean = float(torch.cat([v.reshape(-1) for v in
                            st.anchor_params.values()]).mean())
    log(f"14d rescaled_random on the card: anchor mean {mean:.4f} "
        "(expectation 1)")
    if not 0.9 < mean < 1.1:
        failures.append(f"rescaled_random's mean {mean}")
    if failures:
        raise AssertionError("14d: " + "; ".join(failures))
    return {}


def phase_tensor_one_rank(card) -> dict:
    """14e: GPT-2 small (phase 5a's config, seed and batch) as a one-rank
    tensor plan on a one-rank NCCL group (``apply_tensor_parallel`` over
    the mesh: the column-parallel weights ``Shard(1)``, the vocab-parallel
    ``wte`` ``Shard(0)``, so the lookup, the tied head and the loss run
    their tensor-group paths) with int8 q-AdamW, 4 steps against the same
    model unwrapped: the column-parallel weights take the split-block B6
    (two launches a leaf a step), the rest the fused B6 (one launch a
    step); losses within rtol 1e-3 (bit equality reported), exact
    launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.optim import q_adamw
    from dlrover_tpu_torch.optim.low_bit import PieceGrid
    from dlrover_tpu_torch.parallel import sharding
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState,
        make_train_step,
    )

    steps, batch_size = 4, 8
    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash")
    data = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch_size, SMALL_SEQ + 1), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    runs = {}
    tmp = tempfile.mkdtemp(prefix="scale14e_", dir=OUT_DIR)
    _one_rank_group(tmp)
    try:
        for label in ("plain", "tensor"):
            model = GPT(cfg, seed=0)
            if label == "tensor":
                mesh = build_mesh(MeshConfig(tensor=1), device_type="cuda")
                sharding.apply_tensor_parallel(
                    model, mesh, sharding.param_placements(
                        model, mesh.shape, sharding.gpt_tp_rules()))
            reset_launch_counts()
            opt = q_adamw(model.parameters(), lr=SMALL_LR, weight_decay=0.1)
            init = launch_counts()
            pieces = sum(isinstance(opt._layout(p), PieceGrid)
                         for p in model.parameters())
            step_fn = make_train_step(_loss_fn, opt)
            state = TrainState.create(model, opt)
            reset_launch_counts()
            losses = []
            for _ in range(steps):
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            runs[label] = (losses, init, launch_counts(), pieces,
                           type(model.wte.weight).__name__)
            del model, opt, state, step_fn
            _free_cuda()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    (l0, i0, c0, _, _), (l1, i1, c1, n_pieces, wte) = (runs["plain"],
                                                       runs["tensor"])
    leaves = 12 * cfg.num_layers + 4
    want = _flash_expected(cfg.num_layers, 1, steps, False)
    want0 = dict(want, **{"quantization.qadam": steps})
    want1 = dict(want, **{"quantization.qadam": steps,
                          "quantization.qadam_split_absmax": n_pieces * steps,
                          "quantization.qadam_split_apply": n_pieces * steps})
    init_want = {0: 2 * leaves, 1: 2 * (leaves - n_pieces)}
    log(f"14e GPT-2 small one-rank tensor plan, int8 q-AdamW: losses {l1} "
        f"against unwrapped {l0} (bit equal {l1 == l0}); {n_pieces} split-"
        f"block leaves, wte a {wte}; launches {c1} (unwrapped {c0}); init "
        f"B4 {i1['quantization.quantize']} and "
        f"{i0['quantization.quantize']} [{card}]")
    failures = []
    if not np.allclose(l1, l0, rtol=1e-3, atol=1e-5) or not l1[-1] < l1[0]:
        failures.append(f"losses {l1} vs {l0}")
    if n_pieces != 2 * cfg.num_layers or wte != "DTensor":
        failures.append(f"{n_pieces} split-block leaves, wte a {wte}")
    if c0 != want0 or c1 != want1:
        failures.append(f"launches {c0} / {c1}, expected {want0} / {want1}")
    if (i0["quantization.quantize"], i1["quantization.quantize"]) != (
            init_want[0], init_want[1]):
        failures.append(f"init launches {i0} / {i1}")
    if failures:
        raise AssertionError("14e: " + "; ".join(failures))
    return {"gpt2_small_tensor_one_rank_int8": c1}


def phase_scale_out(card) -> dict:
    """Phase 14: 14a-14e, each timed."""
    out = {}
    for name, fn in (("14a", phase_llama_4bit_fsdp),
                     ("14b", phase_mixtral_ckpt),
                     ("14c", phase_offload_fsdp), ("14d", phase_diloco),
                     ("14e", phase_tensor_one_rank)):
        t0 = time.perf_counter()
        out.update(fn(card))
        _free_cuda()
        log(f"chip_smoke: phase {name} took {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 15: pipeline parallelism and fp8 (slice 5.3) -----------------------

PP_STAGES, PP_MICRO = 4, 8
# 15b's products: XL's MLP at batch 8 x 1024 tokens (fc_in, fc_out)
FP8_SHAPES = ((8192, 1600, 6400), (8192, 6400, 1600))
# e4m3 codes multiply exactly in fp32; the fp8 tensor cores keep about
# 14 bits of a partial sum between promotions to fp32 (DeepSeek-V3
# report, section 3.3.2), so the card's sums round coarser than the
# plain version's fp32 ones: 1.26e-4 / 1.28e-4 read at XL's two shapes
# on an "NVIDIA H100 80GB HBM3, 700.00 W".  2^-10 holds that with room
# and still fails a wrong scale, layout or padding (errors of order 1)
FP8_REL_NORM = 2.0 ** -10
XL_BF16 = {}


def _pp_expected(layers, micro, forwards):
    """B1 ``forwards`` times a layer and microbatch, B2 and B3 once."""
    return _zero_counts(**{
        "flash_attention.fwd": forwards * layers * micro,
        "flash_attention.bwd_dq": layers * micro,
        "flash_attention.bwd_dkv": layers * micro,
    })


def _grads_by_name(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def phase_pipeline_xl(card) -> dict:
    """15a: ``PipelinedGPT`` at GPT-2 XL's full width and depth (48
    layers, d 1600, 25 heads, seq 1024, bf16 over fp32 params, flash),
    4 stages in this process, 8 microbatches of 1: one GPipe step (remat)
    and one 1F1B step (its backward recomputes each stage) from the
    weights of an unpipelined XL step on the same batch, whose loss and
    gradients they are held to by ||got - want|| / ||want||
    (``MODEL_REL_NORM``); B1-B3 launch counts exact.  In one process the
    stages run one after another: the step times are no speed claim."""
    import dataclasses

    import torch

    from dlrover_tpu_torch.models.gpt import (
        GPT,
        GPTConfig,
        cross_entropy_loss,
        partition_pipeline_params,
    )

    cfg = GPTConfig.gpt2_xl(attention_impl="flash", remat=True)
    batch = _xl_batch(cfg.vocab_size, batch=PP_MICRO)
    x = torch.as_tensor(batch["x"], device="cuda")
    y = torch.as_tensor(batch["y"], device="cuda")
    model = GPT(cfg, seed=0)
    rel = MODEL_REL_NORM["bfloat16"]

    def timed_step(fn, module, expected, label):
        """Two steps from the same weights (gradients cleared before
        each): the counts and gradients of the first, the time of the
        second."""
        out = {}
        for turn in range(2):
            module.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            loss = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if turn == 0:
                out["counts"] = launch_counts()
                out["loss"] = float(loss)
                out["grads"] = _grads_by_name(module)
                if out["counts"] != expected:
                    raise AssertionError(
                        f"15a {label}: launch counts {out['counts']} != "
                        f"{expected}")
            out["ms"] = ms
        out["peak"] = torch.cuda.max_memory_allocated()
        return out

    def dense():
        loss = cross_entropy_loss(model(x), y)
        loss.backward()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    ref = timed_step(dense, model, _flash_expected(cfg.num_layers, 1, 1,
                                                   True), "unpipelined")
    # the unpipelined gradients in the stage-stacked layout
    want = partition_pipeline_params(ref.pop("grads"), PP_STAGES,
                                     cfg.num_layers)
    log(f"15a GPT-2 XL unpipelined, batch {PP_MICRO} x {cfg.max_seq_len}, "
        f"remat: loss {ref['loss']:.6f}, step {ref['ms']:.3f} ms [{card}]")
    out = {}
    pm = model.to_pipelined(PP_STAGES, PP_MICRO)
    failures = []
    for label, schedule, remat in (("gpipe", "gpipe", True),
                                   ("1f1b", "1f1b", False)):
        pm.config = dataclasses.replace(cfg, remat=remat)
        if schedule == "gpipe":
            def fn():
                loss = cross_entropy_loss(pm(x), y)
                loss.backward()
                return loss.detach()
        else:
            def fn():
                return pm.loss_and_grads_1f1b(x, y)
        # GPipe: each block's forward twice (remat); 1F1B: the forward
        # stream and the backward's recompute
        expected = _pp_expected(cfg.num_layers, PP_MICRO, 2)
        torch.cuda.reset_peak_memory_stats()
        got = timed_step(fn, pm, expected, label)
        norms = {n: _rel_norm(g, want[n]) for n, g in got["grads"].items()}
        if set(norms) != set(want):
            failures.append(f"{label}: gradients of {sorted(set(want) - set(norms))} missing")
        worst = max(norms, key=norms.get)
        loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        log(f"15a PipelinedGPT XL {PP_STAGES} stages x {PP_MICRO} "
            f"microbatches, {label} (remat {remat}): loss {got['loss']:.6f} "
            f"({loss_rel:.3e} from the unpipelined), largest gradient "
            f"||got - want|| / ||want|| {worst} {norms[worst]:.3e} (limit "
            f"{rel:.4e}); step {got['ms']:.3f} ms = "
            f"{got['ms'] / ref['ms']:.3f} x the unpipelined {ref['ms']:.3f} "
            f"ms, one process; peak {got['peak'] / 2**30:.2f} GiB; launches "
            f"{ {k: v for k, v in got['counts'].items() if v} } [{card}]")
        if loss_rel > rel:
            failures.append(f"{label}: loss {loss_rel:.3e} from the "
                            "unpipelined")
        failures += [f"{label} {n}: {v:.3e}" for n, v in norms.items()
                     if not v <= rel]
        out[f"gpt2_xl_pipeline_{label}"] = got["counts"]
        del got
    if failures:
        raise AssertionError("15a: " + "; ".join(failures))
    return out


def phase_fp8(card) -> dict:
    """15b: ``fp8_dot`` (``torch._scaled_mm``) on the card against its
    plain version at XL's MLP shapes, both timed beside bf16
    ``torch.matmul``; then GPT-2 XL through ``auto_accelerate`` with
    phase 5b's plan plus ``fp8``, 6 steps."""
    import torch

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.models.gpt import GPTConfig
    from dlrover_tpu_torch.ops import fp8
    from dlrover_tpu_torch.optim import q_adamw

    gen = torch.Generator(device="cuda").manual_seed(15)
    failures = []
    for m, k, n in FP8_SHAPES:
        a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        b = torch.randn(k, n, device="cuda", generator=gen) * 0.02
        aq, sa = fp8.quantize_fp8(a)
        bq, sb = fp8.quantize_fp8(b)
        got = fp8.scaled_mm(aq, bq, sa, sb)
        want = (aq.float() @ bq.float()) * (sa * sb)
        err = _rel_norm(got, want)
        b16 = b.bfloat16()
        t = {"scaled_mm": median_ms(lambda: fp8.scaled_mm(aq, bq, sa, sb), 10),
             "fp8_dot": median_ms(lambda: fp8.fp8_dot(a, b), 10),
             "plain": median_ms(lambda: (aq.float() @ bq.float())
                                * (sa * sb), 5),
             "bf16": median_ms(lambda: a @ b16, 10)}
        flops = 2 * m * k * n
        log(f"15b fp8 [{m}, {k}] x [{k}, {n}]: ||scaled_mm - plain|| / "
            f"||plain|| {err:.3e} (limit {FP8_REL_NORM:.4e}); ms dev: "
            f"_scaled_mm on the codes {t['scaled_mm']:.4f} "
            f"({flops / t['scaled_mm'] / 1e9:.1f} TFLOP/s), fp8_dot with "
            f"both quantizations {t['fp8_dot']:.4f}, plain {t['plain']:.4f}, "
            f"bf16 torch.matmul {t['bf16']:.4f} "
            f"({flops / t['bf16'] / 1e9:.1f} TFLOP/s); _scaled_mm "
            f"{t['bf16'] / t['scaled_mm']:.3f}x, fp8_dot "
            f"{t['bf16'] / t['fp8_dot']:.3f}x bf16 [{card}]")
        if not err <= FP8_REL_NORM:
            failures.append(f"[{m}, {k}, {n}]: {err:.3e}")
    if failures:
        raise AssertionError("15b fp8 products: " + "; ".join(failures))
    cfg = GPTConfig.gpt2_xl(attention_impl="flash", remat=True,
                            param_dtype=torch.bfloat16)
    n_params = 12 * cfg.num_layers + 4
    steps = XL_STEPS
    expected = _flash_expected(cfg.num_layers, 1, steps, True, low_bit=8,
                               n_params=n_params)
    strategy = Strategy(opts=[
        ("parallel_mode", {}), ("amp_native", {"dtype": "bfloat16"}),
        ("checkpoint", {}), ("module_replace", {"attention": "flash"}),
        ("fp8", {})])
    trainer, result, counts = run_training(
        "train GPT-2 XL int8 q-AdamW fp8", cfg, XL_BATCH, XL_BATCH, steps,
        expected, card, strategy=strategy,
        optim_factory=lambda ps: q_adamw(ps, lr=3e-4, weight_decay=0.1),
        save_final=False)
    model = trainer.state.module
    if not (model.config.fp8 and isinstance(model.blocks[0].mlp.fc_in,
                                            fp8.Fp8Dense)):
        raise AssertionError("15b: the plan did not build fp8 MLPs")
    step = statistics.median(result["step_seconds"][2:]) * 1e3
    if XL_BF16:
        log(f"15b fp8 XL step {step:.3f} ms against 5b's {XL_BF16['ms']:.3f} "
            f"ms in this run: {XL_BF16['ms'] / step:.3f}x [{card}]")
    else:
        log("15b: phase 5b did not run in this call; no bf16 step beside it")
    return {"gpt2_xl_fp8_int8_qadamw": counts}


def phase_pipeline_fp8(card) -> dict:
    """Phase 15: 15a and 15b, each timed."""
    out = {}
    for name, fn in (("15a", phase_pipeline_xl), ("15b", phase_fp8)):
        t0 = time.perf_counter()
        out.update(fn(card))
        _free_cuda()
        log(f"chip_smoke: phase {name} took {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 16: the RL engine and decode (slice 7 with 5.4's decode) ---------

RL_BATCH, RL_PROMPT_LEN, RL_NEW = 32, 128, 128
RL_ITERS = 4
RL_REL_NORM = 8 * 2.0 ** -8
RL_ACTOR_LR, RL_CRITIC_LR = 1e-5, 1e-4
L8B_BATCH, L8B_PROMPT, L8B_NEW, L8B_CHECK = 8, 1024, 256, 16
L8B_TIMED_STEPS = 16
RL_CHAOS_ENV = {"DLROVER_CHAOS_RL_DEVICE": "cuda",
                "DLROVER_CHAOS_RL_PRESET": "gpt2_small_2l"}


def _role_flash(module, grad_accum=1, train=True) -> dict:
    """The flash launches one step (``train``) or one forward of a role's
    module takes, from its plan: its attention impl, remat and gradient
    accumulation."""
    cfg = module.config
    if cfg.attention_impl != "flash":
        return {}
    layers = cfg.num_layers
    if not train:
        return {"flash_attention.fwd": layers}
    return {"flash_attention.fwd": (2 if cfg.remat else 1) * layers
            * grad_accum,
            "flash_attention.bwd_dq": layers * grad_accum,
            "flash_attention.bwd_dkv": layers * grad_accum}


def _sum_counts(*parts, times=1) -> dict:
    out = _zero_counts()
    for part in parts:
        for k, v in part.items():
            out[k] += v * times
    return out


def _rl_engine(card):
    """16a's engine: GPT-2 small's actor (``module_replace(flash)`` and
    bf16 amp over data parallelism), a value-head critic that searches
    its own plan (cost model), a frozen bf16 ref holding the actor's
    initial weights; AdamW for both trainable roles."""
    import dataclasses

    import numpy as np
    import torch

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, count_params
    from dlrover_tpu_torch.rl.model_engine import (
        ModelRole,
        RLModelEngine,
        RoleSpec,
    )
    from dlrover_tpu_torch.rl.rollout import (
        make_actor_loss,
        make_critic_loss,
        sample_rollout_batch,
    )

    cfg = GPTConfig.gpt2_small()
    actor = GPT(cfg, seed=0)
    critic = GPT(dataclasses.replace(cfg, head="value",
                                     attention_impl="flash"), seed=1)
    ref = GPT(dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                                  attention_impl="flash"), seed=2)
    ref.load_state_dict(actor.state_dict())
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (RL_BATCH, RL_PROMPT_LEN), dtype=np.int32)).cuda()
    t0 = time.perf_counter()
    engine = RLModelEngine(sample_rollout_batch(prompts.cpu(), RL_NEW), {
        ModelRole.ACTOR: RoleSpec(
            model=actor, loss_fn=make_actor_loss(actor, RL_PROMPT_LEN),
            optim_factory=_adamw_factory(lr=RL_ACTOR_LR, wd=0.0),
            strategy=Strategy(opts=[
                ("parallel_mode", {}), ("amp_native", {"dtype": "bfloat16"}),
                ("module_replace", {"attention": "flash"})])),
        ModelRole.CRITIC: RoleSpec(
            model=critic, loss_fn=make_critic_loss(critic, RL_PROMPT_LEN),
            optim_factory=_adamw_factory(lr=RL_CRITIC_LR, wd=0.0),
            search=True, rank_mode="cost_model"),
        ModelRole.REF: RoleSpec(model=ref),
    }).build()
    del actor, critic
    torch.cuda.synchronize()
    n = count_params(engine.state(ModelRole.ACTOR).module)
    log(f"16a: engine built in {time.perf_counter() - t0:.1f} s: actor "
        f"{n} params; {engine.role_report()}")
    if n != 124_475_904:
        raise AssertionError(f"16a: the actor has {n} params, not GPT-2 "
                             "small's 124,475,904")
    return engine, prompts


def _rl_expected(engine):
    """B1-B3 launches of one experience phase and one PPO step, from
    the roles' plans: the ref's forward and the critic's values (no
    grad: no remat), then each trainable role's step; generation runs
    the decode attention, which launches none."""
    from dlrover_tpu_torch.rl.model_engine import ModelRole

    exp = _sum_counts(
        _role_flash(engine._frozen_models[ModelRole.REF], train=False),
        _role_flash(engine.state(ModelRole.CRITIC).module, train=False))
    step = _sum_counts(*(
        _role_flash(engine.state(role).module,
                    engine._accel[role].plan.grad_accum)
        for role in ModelRole.TRAINABLE))
    return exp, step


def _reward(vocab: int):
    def reward_fn(sequences):
        # the example's form: the share of response tokens in the low
        # half of the vocab
        return (sequences[:, RL_PROMPT_LEN:] < vocab // 2).float().mean(1)
    return reward_fn


def _profile_decode(dec, tok, steps: int, label: str, card) -> dict:
    """``steps`` greedy decode steps of the bound decode model ``dec``
    (its cache filled) under torch.profiler: the device's busy ms and
    kernel launches a step against the wall (profiler on)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = dec(tok[:, None])[:, -1].argmax(-1).to(tok.dtype)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        busy += us
        launches += e.count
    out = {"wall_ms": wall_us / 1e3 / steps, "busy_ms": busy / 1e3 / steps,
           "launches": launches / steps}
    log(f"{label} decode step under the profiler ({steps} steps): wall "
        f"{out['wall_ms']:.3f} ms, device busy {out['busy_ms']:.3f} ms "
        f"({busy / wall_us:.4f} of the wall), {out['launches']:.1f} "
        f"kernels a step [{card}]")
    return out


def _greedy_against_full(engine, prompts, card):
    """Greedy decode through the cache against the full forward (the
    actor's train module, through B1) at every generated position, and
    ``generate(temperature=0)`` against the loop's tokens."""
    import torch

    from dlrover_tpu_torch.rl.generation import (
        bind_params,
        decode_variant,
        generate,
        rollout_params,
    )
    from dlrover_tpu_torch.rl.model_engine import ModelRole

    actor = engine.state(ModelRole.ACTOR).module
    dec, params = decode_variant(actor), rollout_params(actor)
    with torch.no_grad():
        with bind_params(dec, params):
            dec.reset_cache()
            logits = [dec(prompts)[:, -1]]
            toks = []
            for _ in range(RL_NEW - 1):
                toks.append(logits[-1].argmax(-1))
                logits.append(dec(toks[-1][:, None].to(prompts.dtype))[:, -1])
            toks.append(logits[-1].argmax(-1))
            _profile_decode(dec, prompts[:, -1], 8, "16a GPT-2 small", card)
            dec.reset_cache()
        got = torch.stack(logits, dim=1)
        seq = torch.cat([prompts, torch.stack(toks, 1).to(prompts.dtype)], 1)
        full = actor(seq[:, :-1])[:, RL_PROMPT_LEN - 1:]
        gseq, _ = generate(dec, params, prompts, None, max_new_tokens=RL_NEW,
                           temperature=0.0)
    err = _rel_norm(got, full)
    same = int((gseq == seq).all(dim=1).sum())
    log(f"16a greedy decode through the cache: {RL_BATCH} x {RL_NEW} "
        f"positions, ||decode - full forward (B1)|| / ||full|| {err:.3e} "
        f"(limit {RL_REL_NORM:.4e}); generate(temperature=0) equal to the "
        f"loop's tokens in {same} of {RL_BATCH} rows [{card}]")
    if not err <= RL_REL_NORM:
        raise AssertionError(f"16a: decode against the full forward {err:.3e}")
    if same != RL_BATCH:
        raise AssertionError("16a: generate's greedy tokens differ from the "
                             "decode loop's")


def _grads_flash_against_plain(engine, batch, card):
    """One PPO step's gradients of the actor and the critic through
    B1-B3 (their train modules) against the same step through the plain
    attention (a copy with the plain math), by the relative norm."""
    import copy

    import torch

    from dlrover_tpu_torch.models.gpt import Attention, xla_causal_attention
    from dlrover_tpu_torch.rl.model_engine import ModelRole

    failures = []
    for role in ModelRole.TRAINABLE:
        module = engine.state(role).module
        plain = copy.deepcopy(module)
        for m in plain.modules():
            if isinstance(m, Attention):
                m._attn = xla_causal_attention
        loss_fn = engine._roles[role].loss_fn
        grads = []
        for mod in (module, plain):
            mod.zero_grad(set_to_none=True)
            loss_fn(mod, engine.place_batch(role, batch)).backward()
            grads.append({n: p.grad for n, p in mod.named_parameters()})
        norms = {n: _check_norm(n, grads[0][n], grads[1][n], RL_REL_NORM,
                                failures, f"16a {role}")
                 for n in grads[1]}
        worst = max(norms, key=norms.get)
        log(f"16a {role} PPO step gradients, flash against plain attention: "
            f"largest ||got - plain|| / ||plain|| {worst} {norms[worst]:.3e} "
            f"over {len(norms)} params (limit {RL_REL_NORM:.4e}) [{card}]")
        module.zero_grad(set_to_none=True)
        del plain, grads
    if failures:
        raise AssertionError("; ".join(failures))


def phase_rl_ppo(card) -> dict:
    """16a: PPO at GPT-2 small's full width through the engine's entry
    points: 4 ``ppo_iteration`` s and one ``PPOTrainer`` epoch (every
    count at 0 before, exact after), per-iteration phase seconds; then
    the exact B1-B3 launches of one experience phase and one PPO step,
    greedy decode against the full forward, and the flash PPO step's
    gradients against the plain attention's."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.rl.rollout import (
        make_experience,
        ppo_iteration,
        train_on_batch,
    )
    from dlrover_tpu_torch.rl.trainer import PPOTrainer, RLTrainConfig

    engine, prompts = _rl_engine(card)
    impls = {"ref": engine._frozen_models["ref"].config.attention_impl}
    impls.update({role: engine.state(role).module.config.attention_impl
                  for role in ("actor", "critic")})
    if set(impls.values()) != {"flash"}:
        raise AssertionError(f"16a: a role runs the plain attention on the "
                             f"card: {impls}")
    vocab = engine.state("actor").module.config.vocab_size
    reward_fn = _reward(vocab)
    exp_want, step_want = _rl_expected(engine)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    reset_launch_counts()
    history = []
    for it in range(RL_ITERS):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = ppo_iteration(engine, prompts, gen, max_new_tokens=RL_NEW,
                          temperature=1.0, kl_coef=0.05, reward_fn=reward_fn)
        m["iteration_s"] = time.perf_counter() - t0
        m["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        history.append(m)
        log(f"16a iteration {it}: rollout_s {m['rollout_s']}, score_s "
            f"{m['score_s']}, gae_s {m['gae_s']}, train_s {m['train_s']}, "
            f"iteration {m['iteration_s']:.4f} s, generated "
            f"{RL_BATCH * RL_NEW / m['rollout_s']:.1f} tokens/s "
            f"({m['rollout_s'] / RL_NEW * 1e3:.3f} ms a token step), "
            f"rollout share {m['rollout_s'] / m['iteration_s']:.3f}, reward "
            f"{m['mean_reward']:.4f}, kl {m['mean_kl']:.4e}, actor loss "
            f"{m['actor_loss']:.4e}, critic loss {m['critic_loss']:.4e}, "
            f"peak {m['peak_gib']:.2f} GiB [{card}]")
    trainer = PPOTrainer(engine, RLTrainConfig(
        epochs=1, num_rollouts=RL_BATCH, ppo_epochs=1,
        train_batch_size=RL_BATCH, max_new_tokens=RL_NEW, temperature=1.0,
        kl_coef=0.05, seed=0), reward_fn=reward_fn)
    t0 = time.perf_counter()
    epoch = trainer.train([prompts])
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"16a PPOTrainer epoch: {epoch} in {time.perf_counter() - t0:.3f} s "
        f"[{card}]")
    want = _sum_counts(exp_want, step_want, times=RL_ITERS + 1)
    log(f"16a main path ({RL_ITERS} iterations + one trainer epoch): "
        f"launches {counts}, expected {want}")
    for h in history + epoch:
        if not all(isinstance(v, str) or np.isfinite(v) for v in h.values()):
            raise AssertionError(f"16a: non-finite metrics {h}")
    if len(epoch) != 1 or epoch[0]["ppo_steps"] != 1:
        raise AssertionError(f"16a: the trainer epoch ran {epoch}")
    if counts != want:
        raise AssertionError(f"16a: launches {counts} != {want}")
    # the exact launches of one experience phase and one PPO step
    reset_launch_counts()
    batch, _ = make_experience(engine, prompts, gen, max_new_tokens=RL_NEW,
                               temperature=1.0, kl_coef=0.05,
                               reward_fn=reward_fn)
    torch.cuda.synchronize()
    exp_got = launch_counts()
    reset_launch_counts()
    train_on_batch(engine, batch)
    torch.cuda.synchronize()
    step_got = launch_counts()
    log(f"16a launches of one experience phase {exp_got} (expected "
        f"{exp_want}); of one PPO step (actor + critic) {step_got} "
        f"(expected {step_want}); plans: actor "
        f"{engine._accel['actor'].strategy.names()}, critic "
        f"{engine._accel['critic'].strategy.names()} (grad_accum "
        f"{engine._accel['critic'].plan.grad_accum})")
    if exp_got != exp_want or step_got != step_want:
        raise AssertionError("16a: one phase's launches differ from the plans")
    _greedy_against_full(engine, prompts, card)
    _grads_flash_against_plain(engine, batch, card)
    return {"rl_ppo_gpt2_small": counts}


def phase_llama_decode(card) -> dict:
    """16b: Llama-3-8B decode at full width and depth (bf16 params, the
    preset's max_seq_len 8192: every step attends over the whole
    cache), batch 8, prompts of 1024, 256 greedy new tokens through
    ``generate``; a decode loop timed step by step; the first 16 greedy
    tokens' logits against one full forward through B1."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.gpt import DecodeCache
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_tpu_torch.rl.generation import (
        bind_params,
        decode_variant,
        generate,
        rollout_params,
    )

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16,
                                attention_impl="flash")
    t0 = time.perf_counter()
    model = Llama(cfg, seed=0)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    log(f"16b: Llama-3-8B built on the card in {time.perf_counter() - t0:.1f}"
        f" s, {weight_bytes / 1e9:.2f} GB of bf16 weights")
    dec, params = decode_variant(model), rollout_params(model)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (L8B_BATCH, L8B_PROMPT), dtype=np.int32)).cuda()
    cache_bytes = (2 * cfg.num_layers * L8B_BATCH * cfg.num_kv_heads
                   * cfg.max_seq_len * cfg.head_dim * 2)
    bound_ms = (weight_bytes + cache_bytes) / PEAK_BYTES_S * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    seq, logps = generate(dec, params, prompts, None, max_new_tokens=L8B_NEW,
                          temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(gen_counts.values()):
        raise AssertionError(f"16b: decode launched flash kernels "
                             f"{gen_counts}")
    if not bool(torch.isfinite(logps).all()) or seq.shape != (
            L8B_BATCH, L8B_PROMPT + L8B_NEW):
        raise AssertionError(f"16b: generate gave {tuple(seq.shape)}, "
                             "non-finite logprobs")
    # the same loop, each step between CUDA events; the first
    # L8B_CHECK steps' logits kept for the check
    with torch.no_grad(), bind_params(dec, params):
        dec.reset_cache()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        last = dec(prompts)[:, -1]
        end.record()
        torch.cuda.synchronize()
        prefill_ms = start.elapsed_time(end)
        got_cache = sum(m.cached_key.numel() * m.cached_key.element_size()
                        * 2 for m in dec.modules()
                        if isinstance(m, DecodeCache))
        logits, toks, steps = [last], [], []
        for _ in range(max(L8B_CHECK, L8B_TIMED_STEPS)):
            toks.append(last.argmax(-1))
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            last = dec(toks[-1][:, None].to(prompts.dtype))[:, -1]
            e.record()
            steps.append((s, e))
            if len(logits) < L8B_CHECK:
                logits.append(last)
        torch.cuda.synchronize()
        prof = _profile_decode(dec, toks[-1].to(prompts.dtype), 4,
                               "16b Llama-3-8B", card)
        dec.reset_cache()
        step_ms = statistics.median(s.elapsed_time(e) for s, e in steps)
        got = torch.stack(logits[:L8B_CHECK], dim=1)
        check = torch.cat([prompts, torch.stack(toks[:L8B_CHECK - 1], 1)
                           .to(prompts.dtype)], 1)
        reset_launch_counts()
        hidden = model(check, return_hidden=True)[:, L8B_PROMPT - 1:]
        full = model.lm_head(hidden, cfg.dtype).float()
        torch.cuda.synchronize()
        full_counts = launch_counts()
    same = bool((seq[:, L8B_PROMPT:L8B_PROMPT + L8B_CHECK]
                 == torch.stack(toks[:L8B_CHECK], 1)).all())
    err = _rel_norm(got, full)
    log(f"16b Llama-3-8B decode, batch {L8B_BATCH}, prompt {L8B_PROMPT}, "
        f"{L8B_NEW} greedy tokens over a {cfg.max_seq_len}-position cache "
        f"({got_cache / 2**30:.3f} GiB, {got_cache / 1e9:.3f} GB): "
        f"generate {gen_s:.3f} s, {L8B_BATCH * L8B_NEW / gen_s:.1f} tokens/s; "
        f"prefill {prefill_ms:.3f} ms; median decode step "
        f"{step_ms:.4f} ms over {len(steps)} steps "
        f"({L8B_BATCH / step_ms * 1e3:.1f} tokens/s), bound {bound_ms:.4f} "
        f"ms (weights {weight_bytes / 1e9:.3f} GB + cache "
        f"{cache_bytes / 1e9:.3f} GB at 3.35 TB/s): {bound_ms / step_ms:.3f} "
        f"of the bound's speed, the device busy {prof['busy_ms']:.3f} ms a "
        f"step ({bound_ms / max(prof['busy_ms'], 1e-9):.3f}); peak "
        f"{peak / 2**30:.2f} GiB [{card}]")
    log(f"16b first {L8B_CHECK} greedy tokens: ||decode - full forward "
        f"(B1, {full_counts['flash_attention.fwd']} launches)|| / ||full|| "
        f"{err:.3e} (limit {RL_REL_NORM:.4e}); generate's tokens equal the "
        f"loop's: {same} [{card}]")
    if not err <= RL_REL_NORM or not same:
        raise AssertionError(f"16b: decode against the full forward {err:.3e},"
                             f" tokens equal {same}")
    if full_counts["flash_attention.fwd"] != cfg.num_layers:
        raise AssertionError(f"16b: the full forward launched {full_counts}")
    del model, dec, params
    return {}


def rl_chaos_child(workdir: str, result_path: str) -> int:
    """16c's agent, in a process of its own that never touches CUDA:
    ``rl_rollout_worker_kill`` through the launcher with the loop's
    models on the card (no invariants here: the parent holds them)."""
    from dlrover_tpu_torch.chaos import harness, scenarios
    from dlrover_tpu_torch.ops import cuda_build

    # the scenario's compile_cache option scopes the job's kernel cache
    # to the run (torch_cache/ under its directory): seed it with the
    # libraries the build phase made, as an operator points a job at a
    # shared cache, so the loop's workers load them and build nothing
    kernels = os.path.join(workdir, "torch_cache", "kernels")
    os.makedirs(kernels, exist_ok=True)
    for name in SOURCES:
        shutil.copy2(cuda_build.library_path(name), kernels)
    t0 = time.time()
    report = harness.run_scenario(
        scenarios.rl_rollout_worker_kill(), workdir=workdir, invariants=[],
        extra_env=RL_CHAOS_ENV, warm_restart=True)
    with open(result_path, "w") as f:
        json.dump({"rc": report.rc, "wall_s": time.time() - t0}, f)
    return 0


def phase_rl_chaos(card) -> dict:
    """16c: the RL chaos loop on the card through the port's launcher
    (GPT-2 small's width, 2 layers, 8 leases, a SIGKILL at lease 2's
    ``rl.rollout``); the scenario's invariants held here: the losses
    equal the uninterrupted control's (run in this process on the card),
    every lease acked exactly once."""
    from dlrover_tpu_torch.chaos import harness, scenarios

    scenario = scenarios.rl_rollout_worker_kill()
    opts = scenarios.RUN_OPTIONS[scenario.name]
    workdir = tempfile.mkdtemp(prefix="rlchaos", dir=OUT_DIR)
    result_path = os.path.join(workdir, "result.json")
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--rl-chaos-child",
             os.path.join(workdir, "run"), result_path],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or not os.path.exists(result_path):
            raise AssertionError(f"16c: the launcher child failed: "
                                 f"{proc.stderr[-3000:]}")
        with open(result_path) as f:
            result = json.load(f)
        run_dir = os.path.join(workdir, "run")
        report = harness._build_report(
            scenario, result["rc"], run_dir,
            os.path.join(run_dir, "events.jsonl"))
        t0 = time.perf_counter()
        harness.check_invariants(report, harness.invariants_for_scenario(
            scenario.name, opts["total_steps"], opts["ckpt_every"], run_dir,
            env=RL_CHAOS_ENV))
        control_s = time.perf_counter() - t0
        verdicts = {r.name: (r.ok, r.detail) for r in report.invariants}
        kills = [e for e in report.events if e.get("type") == "chaos_inject"
                 and e.get("action") == "kill"]
        steps = [e for e in report.events if e.get("type") == "train_step"]
        after = [e["ts"] for e in steps
                 if kills and e["ts"] > kills[0]["ts"]]
        kill_to_step = (min(after) - kills[0]["ts"]) if after else None
        log(f"16c rl_rollout_worker_kill on the card (GPT-2 small width, 2 "
            f"layers, {opts['total_steps']} leases): launcher rc "
            f"{result['rc']}, {result['wall_s']:.1f} s; kill -> first PPO "
            f"step {kill_to_step} s; control computed in "
            f"{control_s:.1f} s; invariants {verdicts} [{card}]")
        held = ("worker_restarted", "training_completed",
                "loss_trajectory_matches_control", "no_duplicate_shards")
        bad = [n for n in held if not verdicts.get(n, (False,))[0]]
        if result["rc"] != 0 or bad or kill_to_step is None:
            raise AssertionError(f"16c: {bad or 'no step after the kill'}: "
                                 f"{verdicts}")
        # the shared segment of the run's socket dir outlives the job
        with harness._patched_env(
                {"DLROVER_SHARED_DIR": os.path.join(run_dir, "sock")}):
            from dlrover_tpu_torch.checkpoint.shm_handler import (
                SharedMemoryHandler,
            )
            SharedMemoryHandler(0).unlink()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {}


def phase_rl(card) -> dict:
    """Phase 16: 16a, 16b and 16c, each timed."""
    out = {}
    for name, fn in (("16a", phase_rl_ppo), ("16b", phase_llama_decode),
                     ("16c", phase_rl_chaos)):
        t0 = time.perf_counter()
        out.update(fn(card))
        _free_cuda()
        log(f"chip_smoke: phase {name} took {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 17: sparse training (KvVariable, DeepFM, the split step) ---------

# 17a: Criteo-scale DeepFM.  The 26 categorical fields of Criteo's
# Kaggle display-advertising data with their counts of distinct values
# (33,762,577 in all), each field's ids drawn with a Zipf skew over its
# own vocabulary; the fields' key ranges are disjoint
S_FIELD_VOCABS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                  93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652,
                  2173, 4, 7046547, 18, 15, 286181, 105, 142572)
S_ZIPF = 1.05
S_BATCH = 4096
S_STEPS = 350             # ~2.03 M distinct keys at this skew and batch
S_MIN_ROWS = 2_000_000
# the pipelined and auto runs take the first S_COMPARE_STEPS of the
# strict run's batches (a step is ~0.1 s of host table work on the card
# machine: 350 steps a mode would take the phase past two minutes)
S_COMPARE_STEPS = 100
S_SEED = 1
# both optimizers' learning rate: the reference class's GroupAdam rate
# (1e-2) makes the hot rows of a Zipf stream diverge (every field's
# hottest ids are updated every step; on the CPU, at this width and
# batch, the strict loss went 0.92 -> 1514 at step 3)
S_LR = 1e-3
# the pipelined mode's staleness-1 trajectory against the strict one:
# the reference's tests hold each mode to training (the last loss below
# 0.6 of the first); here both modes are held to that, over the means
# of the first and last 10 steps, and the pipelined mean loss of the
# last 10 steps to within S_STALE_ATOL of the strict one's
S_FALL = 0.6
S_STALE_ATOL = 0.05
S_DELTA_STEPS = 8
# where the tower runs (a rehearsal on the CPU points it there)
S_DEVICE = "cuda"


def _zipf_ids(rng, n: int, vocab: int):
    """``n`` ids of a Zipf(S_ZIPF) law truncated to ``vocab``, by the
    inverse of its continuous CDF (rank 1 the hottest, id 0)."""
    import numpy as np

    a = 1.0 - S_ZIPF
    u = rng.random(n)
    ranks = np.floor((1.0 + u * (vocab ** a - 1.0)) ** (1.0 / a))
    return np.minimum(ranks, vocab).astype(np.int64) - 1


def _sparse_batches(cfg, steps: int, seed: int = S_SEED):
    """Batches of the bench's form (``bench.py:800-811``: normal dense
    features, the first field's parity as the label) over the fields'
    Zipf ids."""
    import numpy as np

    assert cfg.num_sparse_fields == len(S_FIELD_VOCABS)
    offsets = np.concatenate([[0], np.cumsum(S_FIELD_VOCABS)[:-1]])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        sparse = np.stack([_zipf_ids(rng, S_BATCH, v) + o
                           for v, o in zip(S_FIELD_VOCABS, offsets)], axis=1)
        dense = rng.normal(size=(S_BATCH, cfg.num_dense_features)).astype(
            np.float32)
        labels = (sparse[:, 0] % 2).astype(np.float32)
        out.append((sparse, dense, labels))
    return out


def _rss_gib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def _sparse_model():
    import torch

    from dlrover_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
    from dlrover_tpu_torch.trainer.sparse_pipeline import (
        make_deepfm_device_step,
    )

    model = DeepFM(DeepFMConfig(), device=S_DEVICE)
    model.sparse_optimizer.lr = S_LR
    opt = torch.optim.Adam(model.dense.parameters(), lr=S_LR,
                           betas=(0.9, 0.999), eps=1e-8)
    return model, opt, make_deepfm_device_step(model, opt)


def _sparse_run(mode, batches, card):
    """One mode of 17a on a fresh model: the losses, the report and
    what it printed."""
    import torch

    from dlrover_tpu_torch.trainer.sparse_pipeline import (
        SparseTrainPipeline,
    )

    rss0 = _rss_gib()
    model, opt, step = _sparse_model()
    pipe = SparseTrainPipeline(model.table, model.sparse_optimizer, step,
                               device=S_DEVICE, pipeline=mode, timing=True)
    losses, marks = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(None, batches, on_aux=lambda a: losses.append(a["loss"]),
             on_step=lambda s, n: marks.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = torch.stack(losses).float().cpu().tolist()
    rep = pipe.overlap_report()
    steps = [b - a for a, b in zip(marks, marks[1:])]
    med = statistics.median(steps)
    shares = {k: rep[k] / rep["wall_s"] for k in
              ("gather_s", "h2d_s", "update_s", "fetch_s")}
    shares["device"] = rep.get("device_s", float("nan")) / rep["wall_s"]
    shares["d2h"] = rep.get("d2h_device_s", float("nan")) / rep["wall_s"]
    rows = len(model.table)
    name = rep.get("mode", mode)
    log(f"17a DeepFM {name} ({'auto' if mode == 'auto' else 'fixed'}): "
        f"{len(batches)} steps of batch {S_BATCH}: "
        f"{len(batches) * S_BATCH / wall:.0f} samples/s, median step "
        f"{med * 1e3:.2f} ms; shares of the wall: gather "
        f"{shares['gather_s']:.3f}, H2D (host) {shares['h2d_s']:.3f}, "
        f"device {shares['device']:.3f}, D2H (device) {shares['d2h']:.3f}, "
        f"update {shares['update_s']:.3f}, host wait for D2H "
        f"{shares['fetch_s']:.3f}; card busy share (step kernels) "
        f"{shares['device']:.3f}; table {rows} rows ({3 * rows * 80 / 2**30:.3f}"
        f" GiB of keys, values and counts in its 3 tables), host RSS "
        f"+{_rss_gib() - rss0:.2f} GiB; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} [{card}]")
    return model, opt, step, losses, rep


def phase_sparse_deepfm(card, keep=False):
    """17a: DeepFM at the reference's width (26 fields of 16, 13 dense
    features, tower 429-128-64-1) on the card, batch 4096 of Zipf ids
    over Criteo's 33.8 M keys: S_STEPS strict steps (the table past
    S_MIN_ROWS rows), then the pipelined and auto modes over the first
    S_COMPARE_STEPS of the same batches, each on a fresh model."""
    import math

    from dlrover_tpu_torch.models.deepfm import DeepFMConfig

    batches = _sparse_batches(DeepFMConfig(), S_STEPS)
    out, chosen = {}, None
    for mode in (False, True, "auto"):
        model, opt, step, losses, rep = _sparse_run(
            mode, batches if mode is False else batches[:S_COMPARE_STEPS],
            card)
        key = "auto" if mode == "auto" else (
            "pipelined" if mode else "strict")
        out[key] = losses
        if mode == "auto":
            chosen = rep["mode"]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"17a {key}: a loss is not finite")
        head = sum(losses[:10]) / 10
        tail = sum(losses[-10:]) / 10
        if not tail < S_FALL * head:
            raise AssertionError(f"17a {key}: the loss does not fall to "
                                 f"{S_FALL} of its start ({head:.4f} -> "
                                 f"{tail:.4f})")
        if key == "strict" and len(model.table) < S_MIN_ROWS:
            raise AssertionError(f"17a {key}: {len(model.table)} rows < "
                                 f"{S_MIN_ROWS}")
        if key == "strict" and keep:
            kept = (model, opt, step, batches)
        del model, opt, step
        _free_cuda()
    strict = out["strict"][:S_COMPARE_STEPS]
    gap = abs(sum(out["pipelined"][-10:]) - sum(strict[-10:])) / 10
    worst = max(abs(p - s) / abs(s)
                for p, s in zip(out["pipelined"], strict))
    log(f"17a pipelined against strict: last-10 mean loss gap {gap:.4f} "
        f"(limit {S_STALE_ATOL}) over {S_COMPARE_STEPS} steps, worst "
        f"relative gap of a step {worst:.4f}; auto chose {chosen}")
    if gap > S_STALE_ATOL:
        raise AssertionError(f"17a: pipelined last-10 mean loss {gap:.4f} "
                             f"from strict's, over {S_STALE_ATOL}")
    return kept if keep else {}


def _kv_digests(adapter) -> dict:
    from dlrover_tpu_torch.checkpoint.sparse import rows_digest

    out = {}
    for name, t in adapter.tables.items():
        d = 0
        for k, v, f in t.export_chunks(1 << 20):
            d = (d + rows_digest(k, v, f)) % (1 << 64)
        out[name] = (len(t), d)
    return out


def phase_sparse_ckpt(card, model=None, opt=None, step=None,
                      batches=None):
    """17b: the sparse flash checkpoint of 17a's strict table (plus its
    GroupAdam slots and the tower): a paged shm base, 8 more steps, a
    paged delta; a fresh engine and fresh tables restore it from shm;
    two durable saves with delta checkpoints (a base, 2 steps, a
    delta) and a fresh engine restores the chain from storage with the
    segment gone.  Digests of rows, frequencies and slots must equal the
    saves'."""
    import torch

    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter
    from dlrover_tpu_torch.models.deepfm import DeepFMConfig
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState,
        train_state_tree,
    )
    from dlrover_tpu_torch.trainer.sparse_pipeline import (
        SparseTrainPipeline,
    )

    if model is None:
        model, opt, step, batches = phase_sparse_deepfm(card, keep=True)
    more = _sparse_batches(DeepFMConfig(), S_DELTA_STEPS + 2, seed=S_SEED + 1)
    pipe = SparseTrainPipeline(model.table, model.sparse_optimizer, step,
                               device=S_DEVICE, pipeline=False)
    adapter = SparseStateAdapter(digest=False)
    adapter.register_optimizer(model.sparse_optimizer)
    state = TrainState.create(model.dense, opt)
    out_dir = os.path.join(OUT_DIR, "ckpt_sparse")
    os.environ["DLROVER_SHM_PAGED"] = "1"
    AsyncCheckpointSaver.reset()

    def engine():
        return CheckpointEngine(out_dir, replicated=True, local_rank=0,
                                global_rank=0, world_size=1)

    def fresh_adapter():
        from dlrover_tpu_torch.ops.kv_variable import (
            GroupAdamOptimizer,
            KvVariable,
        )

        t = KvVariable(dim=16, seed=123, name="deepfm")
        o = GroupAdamOptimizer(t, learning_rate=1e-2)
        a = SparseStateAdapter(digest=False)
        a.register_optimizer(o)
        return a

    def kv_bytes(digests):
        # keys (8) + values (16 x 4) + freq (8) per row of each table
        return sum(rows for rows, _ in digests.values()) * (8 + 64 + 8)

    try:
        eng = engine()
        eng.register_sparse(adapter)
        saves = []
        for s in (len(batches), len(batches) + S_DELTA_STEPS):
            if saves:
                pipe.run(None, more[:S_DELTA_STEPS])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not eng.save_to_memory(s, {"dense": train_state_tree(state)}):
                raise AssertionError("17b: a paged save was skipped")
            saves.append((time.perf_counter() - t0,
                          dict(eng.last_save_phases)))
        (base_s, base), (delta_s, delta) = saves
        if (base["kind"], delta["kind"]) != ("base", "delta"):
            raise AssertionError(f"17b: paged kinds {base['kind']}, "
                                 f"{delta['kind']}")
        want = _kv_digests(adapter)
        tower = {n: p.detach().clone() for n, p in
                 model.dense.named_parameters()}
        log(f"17b paged shm: base {base['bytes']} B in {base_s:.3f} s "
            f"(kv {base['kv_bytes']} B), delta after {S_DELTA_STEPS} steps "
            f"{delta['bytes']} B in {delta_s:.3f} s (skipped "
            f"{delta['bytes_skipped']} B), base/delta "
            f"{base['bytes'] / max(delta['bytes'], 1):.2f}x; save stall "
            f"base {base_s:.3f} s, delta {delta_s:.3f} s [{card}]")

        # shm restore into a fresh engine and fresh tables
        a2 = fresh_adapter()
        e2 = engine()
        e2.register_sparse(a2)
        t0 = time.perf_counter()
        got_step, got = e2.load()
        shm_s = time.perf_counter() - t0
        if got_step != len(batches) + S_DELTA_STEPS:
            raise AssertionError(f"17b: shm restore gave step {got_step}")
        if e2.last_restore_phases.get("tier") != "shm":
            raise AssertionError(f"17b: {e2.last_restore_phases}")
        if _kv_digests(a2) != want:
            raise AssertionError("17b: shm-restored tables differ")
        kernel = got["dense"]["params"]["dense_0"]["kernel"]
        if not torch.equal(kernel, tower["dense_0.weight"].cpu()):
            raise AssertionError("17b: shm-restored tower differs")
        e2.close()
        del a2, got
        log(f"17b shm restore (paged, chain replayed): {shm_s:.3f} s, "
            f"{kv_bytes(want) / shm_s / 1e9:.3f} GB/s of kv rows "
            f"[{card}]")

        # durable saves with a delta chain, restored from storage
        os.environ.pop("DLROVER_SHM_PAGED")
        adapter.enable_delta_checkpoints(full_every=8)
        durable = []
        for i, s in enumerate((len(batches) + S_DELTA_STEPS,
                               len(batches) + S_DELTA_STEPS + 2)):
            if i:
                pipe.run(None, more[S_DELTA_STEPS:])
            t0 = time.perf_counter()
            if not eng.save_to_storage(s, {"dense": train_state_tree(state)}):
                raise AssertionError("17b: a durable save was skipped")
            stall = time.perf_counter() - t0
            _wait_committed(out_dir, s)
            durable.append((s, stall))
        want = _kv_digests(adapter)
        eng.close()
        a3 = fresh_adapter()
        e3 = engine()
        e3._shm_handler.unlink()
        e3.register_sparse(a3)
        t0 = time.perf_counter()
        got_step, _ = e3.load()
        storage_s = time.perf_counter() - t0
        phases = e3.last_restore_phases
        if got_step != durable[-1][0] or phases.get("tier") != "storage" \
                or phases.get("kv_chain") != 2:
            raise AssertionError(f"17b: storage restore {got_step} "
                                 f"{phases}")
        if _kv_digests(a3) != want:
            raise AssertionError("17b: storage-restored tables differ")
        e3.close()
        log(f"17b storage: durable base stall {durable[0][1]:.3f} s, delta "
            f"stall {durable[1][1]:.3f} s; restore of the chain (base + "
            f"delta) {storage_s:.3f} s, {kv_bytes(want) / storage_s / 1e9:.3f}"
            f" GB/s of kv rows; tables {[r for r, _ in want.values()]} rows "
            f"[{card}]")
    finally:
        os.environ.pop("DLROVER_SHM_PAGED", None)
        AsyncCheckpointSaver.reset()
        _unlink_segments()
        shutil.rmtree(out_dir, ignore_errors=True)
    return {}


def sparse_chaos_child(workdir: str, result_path: str) -> int:
    """17c's agent, in a process of its own that never touches CUDA:
    ``sparse_kill_restore`` through the launcher with the tower on the
    card (no invariants here: the parent holds them)."""
    from dlrover_tpu_torch.chaos import harness, scenarios

    t0 = time.time()
    report = harness.run_scenario(
        scenarios.sparse_kill_restore(), workdir=workdir, invariants=[],
        extra_env={"DLROVER_CHAOS_SPARSE_DEVICE": S_DEVICE},
        warm_restart=True)
    with open(result_path, "w") as f:
        json.dump({"rc": report.rc, "wall_s": time.time() - t0}, f)
    return 0


def phase_sparse_chaos(card) -> dict:
    """17c: ``sparse_kill_restore`` through the port's launcher, the
    DeepFM loop's tower on the card, the spill tier armed as in its run
    options; the scenario's invariants held here: the losses equal the
    uninterrupted control's (run in this process on the card) and the
    kv digests round-trip (``KvStateRoundTrip``)."""
    from dlrover_tpu_torch.chaos import harness, scenarios

    scenario = scenarios.sparse_kill_restore()
    opts = scenarios.RUN_OPTIONS[scenario.name]
    workdir = tempfile.mkdtemp(prefix="spchaos", dir=OUT_DIR)
    result_path = os.path.join(workdir, "result.json")
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--sparse-chaos-child", os.path.join(workdir, "run"),
             result_path], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or not os.path.exists(result_path):
            raise AssertionError(f"17c: the launcher child failed: "
                                 f"{proc.stderr[-3000:]}")
        with open(result_path) as f:
            result = json.load(f)
        run_dir = os.path.join(workdir, "run")
        report = harness._build_report(
            scenario, result["rc"], run_dir,
            os.path.join(run_dir, "events.jsonl"))
        env = dict(opts.get("extra_env", {}),
                   DLROVER_CHAOS_SPARSE_DEVICE=S_DEVICE)
        harness.check_invariants(report, harness.invariants_for_scenario(
            scenario.name, opts["total_steps"], opts["ckpt_every"], run_dir,
            env=env))
        verdicts = {r.name: (r.ok, r.detail) for r in report.invariants}
        kills = [e for e in report.events if e.get("type") == "chaos_inject"
                 and e.get("action") == "kill"]
        steps = [e for e in report.events if e.get("type") == "train_step"]
        after = [e["ts"] for e in steps
                 if kills and e["ts"] > kills[0]["ts"]]
        kill_to_step = (min(after) - kills[0]["ts"]) if after else None
        spilled = max((e.get("spilled_rows", 0) for e in report.events
                       if e.get("type") == "kv_checkpoint"), default=0)
        log(f"17c sparse_kill_restore (the DeepFM tower on {S_DEVICE}, "
            f"spill tier armed, {opts['total_steps']} steps): launcher rc "
            f"{result['rc']}, {result['wall_s']:.1f} s; kill -> first step "
            f"{kill_to_step} s; up to {spilled} spilled rows; invariants "
            f"{verdicts} [{card}]")
        bad = [n for n, (ok, _) in verdicts.items() if not ok]
        if result["rc"] != 0 or bad or kill_to_step is None or not spilled:
            raise AssertionError(f"17c: {bad or 'no step after the kill'}: "
                                 f"{verdicts}")
        with harness._patched_env(
                {"DLROVER_SHARED_DIR": os.path.join(run_dir, "sock")}):
            from dlrover_tpu_torch.checkpoint.shm_handler import (
                SharedMemoryHandler,
            )
            SharedMemoryHandler(0).unlink()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {}


# 17d: the serving plane (slice 9.1) on 17b's strict table: a base, then
# SV_STEPS more strict steps on new batches with a delta every
# SV_PUB_EVERY, ingested by a pool of SV_POOL replica processes behind
# one router process while the load harness drives routed lookups
SV_STEPS, SV_PUB_EVERY, SV_POOL = 12, 4, 2
SV_CHECK_KEYS, SV_ABSENT_KEYS = 100_000, 5_000
SV_CONVERGE_S = 60.0
SV_BUDGET_S = 45.0
# the ids of 17a's fields, laid end to end
SV_KEY_SPACE = sum(S_FIELD_VOCABS)


class _ZipfKeys:
    """A lookup stream's key source.  ``fleet/lookup_load.py`` is a copy
    of the reference's and has no hook for one (ROADMAP §A 6 asks for
    a key sampler): its agent draws each batch as
    ``self._rng.integers(0, key_space, batch)``, and 17d puts this
    object in the place of ``_rng``.  It draws from 17a's field laws
    instead (each key's field uniform, its id Zipf over the field's
    vocabulary at the field's offset), so the routed traffic hits the
    table as the trainer's batches do.  It counts its draws and keeps
    any range other than ``[0, key_space)``; :func:`_zipf_draws_failed`
    holds both against the agents' lookups, so an agent that drew its
    keys another way fails the phase instead of passing with uniform
    keys."""

    def __init__(self, seed: int, key_space: int):
        import numpy as np

        self._rng = np.random.default_rng(seed)
        self._offsets = np.concatenate([[0], np.cumsum(S_FIELD_VOCABS)[:-1]])
        self.key_space = key_space
        self.draws = 0
        self.bad_ranges = set()

    def integers(self, low, high, size):
        import numpy as np

        if (low, high) != (0, self.key_space):
            self.bad_ranges.add((low, high))
        self.draws += 1
        fields = self._rng.integers(0, len(S_FIELD_VOCABS), size)
        out = np.empty(size, dtype=np.int64)
        for f in np.unique(fields):
            m = fields == f
            out[m] = _zipf_ids(self._rng, int(m.sum()),
                               S_FIELD_VOCABS[f]) + self._offsets[f]
        return out


def _zipf_draws_failed(load) -> list:
    """The failures of 17d's key sources: each agent of ``load`` made
    one draw from its :class:`_ZipfKeys` for each lookup it counted,
    over the table's key space, and made at least one lookup."""
    failures = []
    for agent in load.agents:
        src = agent._rng
        if not isinstance(src, _ZipfKeys) or src.bad_ranges or (
                src.draws != agent.stats.lookups) or not src.draws:
            failures.append(
                f"lookup stream {agent.stream_id}: {agent.stats.lookups} "
                f"lookups, {getattr(src, 'draws', None)} Zipf draws, ranges "
                f"{getattr(src, 'bad_ranges', None)} (the load harness no "
                "longer draws its keys through its stream's rng)")
    return failures


def _serving_events(paths, etype):
    from dlrover_tpu_torch.telemetry.events import read_events

    out = []
    for p in paths:
        if os.path.exists(p):
            out += [e for e in read_events(p) if e.get("type") == etype]
    return out


def phase_sparse_serving(card, model=None, step=None) -> dict:
    """17d: the serving plane on 17b's strict table (about 2.04 M rows
    of 16 fp32 trained on the card).  The trainer registers a serving
    adapter on the DeepFM table and publishes a base, then takes
    SV_STEPS strict steps on new seeded batches (17a's Zipf law and
    batch) with a delta every SV_PUB_EVERY; a ``ReplicaPool`` of
    SV_POOL ``python -m dlrover_tpu_torch.serving`` processes behind one
    ``python -m dlrover_tpu_torch.serving.router`` process ingests the
    chain while ``LookupLoadHarness`` (its default streams and batch)
    drives routed lookups of Zipf keys.  Fatal: an ingest digest that is
    not its publish's, a replica that does not reach the last
    generation, a lookup of SV_CHECK_KEYS seeded keys (some absent) on a
    replica that differs from ``model.table.gather_or_zeros`` by a bit,
    a failed or stale routed lookup, a replica or router that maps a
    CUDA library.  On a failure the run's event logs are copied into
    ``chiprun_out/``."""
    if model is None:
        model, opt, step, batches = phase_sparse_deepfm(card, keep=True)
        phase_sparse_ckpt(card, model, opt, step, batches)
    t_phase = time.perf_counter()
    # the published generations (hundreds of MB) go to the system's
    # temporary directory, never into chip_smoke_out
    workdir = tempfile.mkdtemp(prefix="serving17d")
    try:
        failures = _serving_run(card, model, step, workdir)
        log(f"17d took {time.perf_counter() - t_phase:.1f} s against a "
            f"budget of {SV_BUDGET_S:.0f} s [{card}]")
        if failures:
            raise AssertionError("17d: " + "; ".join(failures))
    except BaseException:
        keep = os.path.join(ROOT, "chiprun_out", "serving17d")
        shutil.rmtree(keep, ignore_errors=True)
        shutil.copytree(workdir, keep, ignore=shutil.ignore_patterns(
            "serving", "router_journal", "*.prom"))
        log(f"17d: kept the run's logs in {keep}")
        raise
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {}


def _serving_run(card, model, step, workdir) -> list:
    """17d's run in ``workdir``: the failures, as text."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.chaos import harness
    from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter
    from dlrover_tpu_torch.common.comm import MessageClient
    from dlrover_tpu_torch.fleet.lookup_load import LookupLoadHarness
    from dlrover_tpu_torch.models.deepfm import DeepFMConfig
    from dlrover_tpu_torch.serving.messages import (
        LookupRequest,
        RoutingTableRequest,
    )
    from dlrover_tpu_torch.serving.pool import ReplicaPool
    from dlrover_tpu_torch.serving.publisher import (
        EmbeddingPublisher,
        read_manifest,
    )
    from dlrover_tpu_torch.trainer.sparse_pipeline import (
        SparseTrainPipeline,
    )

    serving_dir = os.path.join(workdir, "serving")
    pub_log = os.path.join(workdir, "events_trainer.jsonl")
    router_log = os.path.join(workdir, "events_router.jsonl")
    port_file = os.path.join(workdir, "router.port")
    router_stop = os.path.join(workdir, "router.stop")
    router = pool = ctl = load = None
    failures = []
    try:
        with harness._patched_env({"DLROVER_EVENT_LOG": pub_log}):
            adapter = SparseStateAdapter(digest=True).register_table(
                model.table)
            pub = EmbeddingPublisher(adapter, serving_dir, compact_every=100)
            t0 = time.perf_counter()
            base_gen = pub.publish(step=0)
            base_s = time.perf_counter() - t0
        base = read_manifest(serving_dir, base_gen)
        env = dict(os.environ, PYTHONPATH=ROOT, DLROVER_EVENT_LOG=router_log,
                   DLROVER_SERVING_ROLE="router", DLROVER_MASTER_ADDR="")
        router = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.serving.router",
             "--journal-dir", os.path.join(workdir, "router_journal"),
             "--port", "0", "--port-file", port_file,
             "--stop-file", router_stop, "--heartbeat-timeout", "5",
             "--min-available", "1", "--stats-every", "0.5"],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        deadline = time.time() + 30
        while not os.path.exists(port_file):
            if time.time() > deadline or router.poll() is not None:
                raise AssertionError("17d: the router never wrote its port")
            time.sleep(0.05)
        with open(port_file) as f:
            router_addr = f"127.0.0.1:{int(f.read().strip())}"
        pool = ReplicaPool(serving_dir, os.path.join(workdir, "pool"),
                           router_addr=router_addr, size=SV_POOL,
                           heartbeat_s=0.25, stats_every_s=0.5,
                           max_respawns=0)
        ports = pool.wait_ports(60.0)
        ctl = MessageClient(router_addr, node_id=-3, node_type="chip-smoke",
                            timeout=15.0, retries=4, backoff_base=0.1,
                            backoff_max=1.0, resync_timeout=0.0)

        def wait_admitted(gen):
            deadline = time.time() + SV_CONVERGE_S
            while True:
                live = [m for m in ctl.get(RoutingTableRequest())
                        .members.values() if not m.get("removed")]
                if len(live) == SV_POOL and all(
                        int(m.get("generation", -1)) >= gen for m in live):
                    return
                if time.time() > deadline:
                    raise AssertionError(f"17d: the pool never reached "
                                         f"generation {gen}: {live}")
                time.sleep(0.05)

        wait_admitted(base_gen)
        base_ready_s = time.perf_counter() - t0
        load = LookupLoadHarness(router_addr, key_space=SV_KEY_SPACE,
                                 seed=S_SEED)
        for i, agent in enumerate(load.agents):
            agent._rng = _ZipfKeys(S_SEED * 1000 + i, SV_KEY_SPACE)
        batch = load.agents[0]._batch
        load.start()
        pipe = SparseTrainPipeline(model.table, model.sparse_optimizer, step,
                                   device=S_DEVICE, pipeline=False)
        more = _sparse_batches(DeepFMConfig(), SV_STEPS, seed=S_SEED + 2)
        deltas = []
        with harness._patched_env({"DLROVER_EVENT_LOG": pub_log}):
            for k in range(0, SV_STEPS, SV_PUB_EVERY):
                pipe.run(None, more[k:k + SV_PUB_EVERY])
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                gen = pub.publish(step=k + SV_PUB_EVERY)
                deltas.append((gen, time.perf_counter() - t1))
        last = deltas[-1][0]
        wait_admitted(last)
        load.stop()
        failures += _zipf_draws_failed(load)
        summary, load = load.summary(), None
        # every replica at the last generation against the live table
        rng = np.random.default_rng(S_SEED + 3)
        keys = np.concatenate([
            _ZipfKeys(S_SEED + 4, SV_KEY_SPACE).integers(
                0, SV_KEY_SPACE, SV_CHECK_KEYS - SV_ABSENT_KEYS),
            SV_KEY_SPACE + rng.integers(0, 10**6, SV_ABSENT_KEYS),
        ]).astype(np.int64)
        want = model.table.gather_or_zeros(keys)
        absent = int((~want.any(axis=1)).sum())
        equal = {}
        for rid, port in sorted(ports.items()):
            cli = MessageClient(f"127.0.0.1:{port}", node_id=-4,
                                node_type="chip-smoke", timeout=60.0,
                                retries=2, backoff_base=0.1,
                                backoff_max=1.0, resync_timeout=0.0)
            try:
                resp = cli.get(LookupRequest(keys=keys))
            finally:
                cli.close()
            equal[rid] = (resp.generation == last and
                          resp.values.tobytes() == want.tobytes())
            if not equal[rid]:
                failures.append(f"replica {rid} at generation "
                                f"{resp.generation} serves other values "
                                f"than the table at {last}")
        mapped = {f"replica {rid}": _maps_cuda(m.proc.pid)
                  for rid, m in pool._members.items()}
        mapped["router"] = _maps_cuda(router.pid)
        for who, libs in mapped.items():
            if libs:
                failures.append(f"the {who} maps {libs}")
        replica_logs = pool.event_logs()
    finally:
        if ctl is not None:
            ctl.close()
        if load is not None:
            load.stop()
        if pool is not None:
            pool.stop()
        if router is not None:
            with open(router_stop, "w") as f:
                f.write("stop")
            try:
                router.wait(timeout=10)
            except subprocess.TimeoutExpired:
                router.kill()
                router.wait()
    publishes = _serving_events([pub_log], "serving_publish")
    events = publishes + _serving_events(replica_logs, "serving_ingest")
    for inv in (harness.ServedGenerationCommitted(),
                harness.PublishExactlyOnce()):
        res = inv.check(events, None)
        if not res.ok:
            failures.append(f"{res.name}: {res.detail}")
    per_replica = {}
    for path in replica_logs:
        ing = _serving_events([path], "serving_ingest")
        per_replica[os.path.basename(path)] = ing
        if max((e["generation"] for e in ing), default=-1) != last:
            failures.append(f"{os.path.basename(path)} never ingested "
                            f"generation {last}")
    if summary["failed"]:
        failures.append(f"{summary['failed']} routed lookups failed")
    route = _serving_events([router_log], "serving_route")
    bad = sum(int(e.get("failed") or 0) + int(e.get("stale") or 0)
              for e in route)
    if bad:
        failures.append(f"{bad} failed or stale routed lookups counted by "
                        "the router")
    pubs = {e["generation"]: e for e in publishes}
    log(f"17d base: {base['tables']['deepfm']['rows']} rows, "
        f"{base['nbytes']} B in {base_s:.3f} s (generation {base_gen}); the "
        f"pool of {SV_POOL} admitted it {base_ready_s:.3f} s after the "
        f"publish began [{card}]")
    for gen, stall in deltas:
        p = pubs.get(gen, {})
        log(f"17d delta generation {gen}: {p.get('rows')} rows, "
            f"{p.get('dead_rows')} tombstones, {p.get('bytes')} B, the "
            f"trainer's publish stall {stall * 1e3:.3f} ms [{card}]")
    for name, ing in sorted(per_replica.items()):
        log(f"17d {name}: ingest (generation, kind, seconds) "
            f"{[(e['generation'], e['kind'], e['seconds']) for e in ing]}; "
            f"freshness, commit to servable (generation, s) "
            f"{[(e['generation'], e.get('freshness_s')) for e in ing]} "
            f"[{card}]")
    log(f"17d routed lookups (LookupLoadHarness, {summary['streams']} "
        f"streams of batch {batch}, Zipf keys): {summary['lookups']} in "
        f"{summary.get('wall_s')} s = {summary.get('qps')} lookups/s, p50 "
        f"{summary.get('p50_ms')} ms, p99 {summary.get('p99_ms')} ms, "
        f"failed {summary['failed']}, outcomes {summary['outcomes']}, "
        f"router windows failed or stale {bad}; the check's "
        f"{SV_CHECK_KEYS} keys ({absent} absent) bit-equal by replica "
        f"{equal}; CUDA libraries mapped {mapped} [{card}]")
    return failures


def phase_sparse(card) -> dict:
    """Phase 17: 17a, 17b (on 17a's strict table), 17d (on 17b's) and
    17c, each timed."""
    t0 = time.perf_counter()
    model, opt, step, batches = phase_sparse_deepfm(card, keep=True)
    log(f"chip_smoke: phase 17a took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_sparse_ckpt(card, model, opt, step, batches)
    log(f"chip_smoke: phase 17b took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_sparse_serving(card, model, step)
    del model, opt, step, batches
    _free_cuda()
    log(f"chip_smoke: phase 17d took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_sparse_chaos(card)
    log(f"chip_smoke: phase 17c took {time.perf_counter() - t0:.1f} s")
    return {}


# -- phase 18: BERT and GPT's save_attn remat (slice 5.4) --------------------

BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 512, 8
BERT_PAD = 32            # padded positions at the end of half the rows
BERT_MLM_SHARE = 0.15
BERT_MASK_ID = 103       # [MASK] in BERT's uncased vocabulary
BERT_LR = 1e-4
BERT_SMALL_ATOL = 1e-4   # a narrow BERT in fp32, card against CPU
SAVE_ATTN_RTOL, SAVE_ATTN_ATOL = 1e-3, 1e-5
SAVE_ATTN_TIMED_STEPS = 4
SAVE_ATTN = {}


def _bert_batch(vocab: int, batch: int, seq: int, seed: int = 0) -> dict:
    """MLM traffic: random tokens, two segments (the second half of each
    row), 15% of the positions masked ([MASK] in, the original token the
    target), and a padding mask on the last 32 positions of half the
    rows; from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    targets = rng.integers(0, vocab, (batch, seq), dtype=np.int64)
    mlm = rng.random((batch, seq)) < BERT_MLM_SHARE
    mask = np.ones((batch, seq), np.int64)
    mask[::2, seq - min(BERT_PAD, seq // 2):] = 0
    mlm &= mask.astype(bool)
    tokens = np.where(mlm, BERT_MASK_ID, targets)
    segments = np.broadcast_to((np.arange(seq) >= seq // 2).astype(np.int64),
                               (batch, seq)).copy()
    return {"tokens": tokens, "segment_ids": segments, "mask": mask,
            "targets": targets, "mlm_mask": mlm}


def _bert_loss_fn(module, batch):
    from dlrover_tpu_torch.models.bert import mlm_loss

    logits = module(batch["tokens"], batch["segment_ids"], batch["mask"])
    return mlm_loss(logits, batch["targets"], batch["mlm_mask"])


def _bert_small_check(card):
    """A narrow BERT (``BertConfig.tiny``, fp32) on the card against the
    same weights on the CPU: MLM logits and the loss within
    ``BERT_SMALL_ATOL`` with the padding mask and segments of 18a."""
    import torch

    from dlrover_tpu_torch.models.bert import Bert, BertConfig

    cfg = BertConfig.tiny(dtype=torch.float32)
    cpu = Bert(cfg, device="cpu", seed=1)
    gpu = Bert(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in
             _bert_batch(cfg.vocab_size, batch=4, seq=64, seed=1).items()}
    with torch.no_grad():
        want = cpu(batch["tokens"], batch["segment_ids"], batch["mask"])
        got = gpu(*(batch[k].cuda() for k in ("tokens", "segment_ids",
                                               "mask"))).cpu()
    err = float((got - want).abs().max())
    log(f"18a: a narrow BERT in fp32 on the card against the CPU: logits max "
        f"abs err {err:.3e} (limit {BERT_SMALL_ATOL}) [{card}]")
    if not err <= BERT_SMALL_ATOL:
        raise AssertionError(f"18a: BERT logits on the card differ from the "
                             f"CPU's by {err}")


def phase_bert(card) -> dict:
    """18a: BERT-base (``BertConfig()``: vocab 30528, 12 layers, 12 heads,
    hidden 768, seq 512, bf16 over fp32 params) through
    ``auto_accelerate`` with ``[half, checkpoint]`` and AdamW on one
    fixed MLM batch (``_bert_batch``): a finite loss that falls, no hand
    kernel launched (the reference's BERT reaches no Pallas kernel), the
    median step, tokens/s, MFU, the peak and the top ops of one step
    from ``dlrover_tpu_torch.utils.profiler``."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.bert import Bert, BertConfig
    from dlrover_tpu_torch.models.gpt import count_params
    from dlrover_tpu_torch.utils.profiler import parse_trace_dir, trace

    _bert_small_check(card)
    cfg = BertConfig()
    t0 = time.perf_counter()
    model = Bert(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = count_params(model)
    # the tables that are only looked up (wte is the tied head too)
    lookup = model.wpe.weight.numel() + model.wse.weight.numel()
    log(f"18a BERT-base: {n_params} params, {cfg.num_layers} layers, d "
        f"{cfg.hidden_dim}, vocab {cfg.vocab_size}, built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = _bert_batch(cfg.vocab_size, BERT_BATCH, BERT_SEQ)
    result = auto_accelerate(
        model, lambda ps: torch.optim.AdamW(ps, lr=BERT_LR, betas=(0.9, 0.999),
                                            eps=1e-8, weight_decay=1e-4),
        _bert_loss_fn, batch,
        strategy=Strategy(opts=[("half", {}), ("checkpoint", {})]))
    del model
    built = result.model.config
    if not (built.remat and built.param_dtype == torch.bfloat16):
        raise AssertionError(f"18a: the plan built {built}")
    placed = result.place_batch(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    state, losses, secs = result.state, [], []
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        state, metrics = result.train_step(state, placed)
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"18a BERT-base: losses {[round(x, 6) for x in losses]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"18a: losses not finite and falling: {losses}")
    if counts != _zero_counts():
        raise AssertionError(f"18a: hand kernels launched: {counts}")
    step_s = statistics.median(secs[2:])
    tokens = BERT_BATCH * BERT_SEQ
    # 6 FLOPs per weight per token (the tied head counted, the tables
    # that are only looked up not) plus non-causal attention, 12 L s d
    # per token; the remat recompute is not counted
    flops = tokens * (6 * (n_params - lookup)
                      + 12 * cfg.num_layers * BERT_SEQ * cfg.hidden_dim)
    log(f"18a BERT-base: median step {step_s * 1e3:.3f} ms over steps "
        f"3..{BERT_STEPS}, {tokens / step_s:.1f} tokens/s, model FLOPs "
        f"utilisation {flops / step_s / PEAK_FLOPS['bfloat16']:.4f} of 989 "
        f"TFLOP/s ({flops:.4e} FLOPs a step), step times "
        f"{[round(t * 1e3, 3) for t in secs]} ms, peak memory "
        f"{peak / 2**30:.2f} GiB, launches {counts} [{card}]")
    logdir = os.path.join(OUT_DIR, "trace_bert")
    shutil.rmtree(logdir, ignore_errors=True)
    with trace(logdir):
        state, _ = result.train_step(state, placed)
        torch.cuda.synchronize()
    summary = parse_trace_dir(logdir)
    if not summary.op_self_time_us:
        raise AssertionError("18a: the profiler's trace holds no events")
    log(f"18a BERT-base: one step under utils.profiler.trace spans "
        f"{summary.total_duration_us / 1e3:.3f} ms; top ops by summed "
        f"duration:")
    # the profiler's own span covers the whole step
    top = [(n, us) for n, us in summary.top_ops(9)
           if not n.startswith("PyTorch Profiler")]
    for name, us in top[:8]:
        log(f"18a:   {us / 1e3:9.3f} ms  {name[:90]}")
    shutil.rmtree(logdir, ignore_errors=True)
    result.state = state
    profile_step(result, batch, card, "BERT-base MLM")
    return {"bert_base_mlm": counts}


def phase_slice_5_4(card):
    """``--only 18``: 18a, then phase 5b, which runs 18b on its state."""
    phase_bert(card)
    _free_cuda()
    phase_train_xl(card)


def phase_save_attn(trainer, card, xl_ms: float, xl_peak: int) -> dict:
    """18b, in phase 5b's process on its model and q-AdamW state: one
    step under full remat and one under ``remat_policy="save_attn"``
    from the same state (params and moments copied before and put back
    between them): losses and updated parameters within
    ``SAVE_ATTN_RTOL``/``SAVE_ATTN_ATOL``, and exactly 96 B1, 48 B2, 48
    B3 and 1 B6 in the save_attn step (the reference's jaxpr holds the
    flash forward twice a layer under save_attn too); then
    ``SAVE_ATTN_TIMED_STEPS`` steps of each policy, interleaved, their
    median and peak beside 5b's."""
    import dataclasses

    import torch

    module, opt = trainer.state.module, trainer.state.optimizer
    cfg = module.config
    placed = trainer.place_batch(trainer.train_data[0])
    params = [p for p in module.parameters()]
    saved_p = [p.detach().clone() for p in params]
    saved_opt = {p: {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in st.items()} for p, st in opt.state.items()}

    def restore():
        with torch.no_grad():
            for p, c in zip(params, saved_p):
                p.copy_(c)
            for p, st in saved_opt.items():
                for k, v in st.items():
                    if torch.is_tensor(v):
                        opt.state[p][k].copy_(v)
                    else:
                        opt.state[p][k] = v

    def step(policy):
        module.config = dataclasses.replace(cfg, remat_policy=policy)
        torch.cuda.synchronize()
        reset_launch_counts()
        trainer.state, metrics = trainer.train_step(trainer.state, placed)
        loss = float(metrics["loss"])
        return loss, launch_counts()

    runs = {}
    for policy in ("full", "save_attn"):
        restore()
        loss, counts = step(policy)
        runs[policy] = (loss, counts, [p.detach().clone() for p in params])
    expected = _zero_counts(**{
        "flash_attention.fwd": 2 * cfg.num_layers,
        "flash_attention.bwd_dq": cfg.num_layers,
        "flash_attention.bwd_dkv": cfg.num_layers,
        "quantization.qadam": 1})
    (l_full, c_full, p_full), (l_sa, c_sa, p_sa) = (runs["full"],
                                                    runs["save_attn"])
    worst, bad, elements = 0.0, 0, 0
    for a, b in zip(p_sa, p_full):
        diff = (a.float() - b.float()).abs()
        worst = max(worst, float(diff.max()))
        bad += int((diff > SAVE_ATTN_ATOL
                    + SAVE_ATTN_RTOL * b.float().abs()).sum())
        elements += a.numel()
    equal = all(torch.equal(a, b) for a, b in zip(p_sa, p_full))
    del p_full, p_sa, runs
    log(f"18b GPT-2 XL save_attn: from 5b's state, loss {l_sa:.6f} against "
        f"full remat's {l_full:.6f}; updated params max abs diff {worst:.3e}, "
        f"{bad} of {elements} elements past rtol {SAVE_ATTN_RTOL} / atol "
        f"{SAVE_ATTN_ATOL} (bit-equal: {equal}); launches a step {c_sa} "
        f"(full remat {c_full}), expected {expected} [{card}]")
    failures = []
    if abs(l_sa - l_full) > SAVE_ATTN_ATOL + SAVE_ATTN_RTOL * abs(l_full):
        failures.append(f"loss {l_sa} against {l_full}")
    if bad:
        failures.append(f"{bad} parameter elements differ")
    if c_sa != expected:
        failures.append(f"launches {c_sa} != {expected}")
    if failures:
        raise AssertionError("18b: " + "; ".join(failures))
    # the copies go before the timed steps, so their peaks are training's
    saved_p = saved_opt = None
    _free_cuda()
    # the two policies' steps interleaved, so a drift of the host's
    # speed reaches both alike
    secs = {"full": [], "save_attn": []}
    peaks = {"full": 0, "save_attn": 0}
    for i in range(2 * SAVE_ATTN_TIMED_STEPS):
        policy = ("full", "save_attn")[i % 2]
        module.config = dataclasses.replace(cfg, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.state, _ = trainer.train_step(trainer.state, placed)
        torch.cuda.synchronize()
        secs[policy].append(time.perf_counter() - t0)
        peaks[policy] = max(peaks[policy], torch.cuda.max_memory_allocated())
    timing = {p: (statistics.median(secs[p]) * 1e3, peaks[p]) for p in secs}
    module.config = cfg
    log(f"18b GPT-2 XL save_attn: median step {timing['save_attn'][0]:.3f} ms, "
        f"peak {timing['save_attn'][1] / 2**30:.2f} GiB; full remat in the "
        f"same process {timing['full'][0]:.3f} ms, peak "
        f"{timing['full'][1] / 2**30:.2f} GiB; 5b's steps {xl_ms:.3f} ms, "
        f"peak {xl_peak / 2**30:.2f} GiB ({SAVE_ATTN_TIMED_STEPS} steps of "
        f"each, interleaved) [{card}]")
    SAVE_ATTN["counts"] = c_sa
    return c_sa


# -- phase 19: the step caches and the fleet (slices 8.2 and 9.2) -------------


def _cache_events(events, etype):
    return {int(e.get("restart_count", 0)): e for e in events
            if e.get("type") == etype}


def phase_step_caches(card) -> dict:
    """19a: phase 8's GPT-2 small worker under the launcher with
    ``--warm-restart``, ``DLROVER_AOT_PRETRACE`` and a fresh compile
    cache; the kill at step 4 of 8.  The first incarnation builds the
    flash library into the cache and writes its step's AOT entry; the
    respawn must resolve through both with nothing built, from a
    template that loaded the library and never initialised the driver,
    and replay the control's losses bit for bit.  Returns the run's
    launch counts (path ``launcher_warm_step_caches``)."""
    from dlrover_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt2_small(max_seq_len=SMALL_SEQ, attention_impl="flash")
    per_step = cfg.num_layers * (L_GLOBAL_BATCH // L_MICRO)
    if not LAUNCHER_CONTROL:
        # --only 19: phase 8's control, computed here as phase 8 does
        losses, _steady, _counts = _launcher_control(cfg)
        path = os.path.join(OUT_DIR, "launcher_control_losses.json")
        with open(path, "w") as f:
            json.dump(losses, f)
        LAUNCHER_CONTROL.update(losses=losses, path=path)
        log(f"19a: phase 8's control computed here: losses {losses}")
    control = LAUNCHER_CONTROL["losses"]
    r = _launcher_run("19a", 19, LAUNCHER_CONTROL["path"])
    failures = _check_launcher_run(r, per_step, control)
    events = r["events"]
    cc = _cache_events(events, "compile_cache")
    aot = _cache_events(events, "aot_cache")
    incs = {i["restart_count"]: i for i in r["incarnations"]}
    first, respawn = cc.get(0, {}), cc.get(1, {})
    if not (first.get("status") == "cold" and first.get("build_s", 0) > 0
            and first.get("entries_before") == 0
            and first.get("entries_after") == 1):
        failures.append(f"the first incarnation did not build the flash "
                        f"library into the fresh cache: {first}")
    if not (aot.get(0, {}).get("wrote") and not aot.get(0, {}).get("hit")):
        failures.append(f"the first incarnation wrote no AOT entry: "
                        f"{aot.get(0)}")
    if not (respawn.get("status") == "aot-hit" and respawn.get("hit")
            and respawn.get("entries_before") == respawn.get(
                "entries_after") == 1 and respawn.get("build_s") == 0):
        failures.append(f"the respawn's compile cache did not hit: "
                        f"{respawn}")
    hit = aot.get(1, {})
    if not (hit.get("hit") and hit.get("preloaded")
            and hit.get("libraries") == 1
            and hit.get("libraries_preloaded")):
        failures.append(f"the respawn's AOT resolve did not hit with the "
                        f"template's library: {hit}")
    if [x["name"] for x in incs.get(1, {}).get("libs_at_start", [])] != [
            "flash_attention"]:
        failures.append(f"the respawn did not inherit the flash library: "
                        f"{incs.get(1, {}).get('libs_at_start')}")
    if incs.get(1, {}).get("nvcc_s", 1.0) != 0.0:
        failures.append(f"the respawn ran nvcc: {incs.get(1)}")
    templates = {p: v for p, v in r["procs"].items()
                 if "dlrover_tpu_torch.agent.forkserver" in v["cmdline"]
                 and v["ppid"] == r["agent"]["pid"]}
    for pid, v in templates.items():
        driver = [m for m in v["maps"] if "libnvidia" in m]
        if v["devices"] or driver:
            failures.append(f"the template (pid {pid}) initialised the CUDA "
                            f"driver: {v['devices'] + driver}")
        if not any("/flash_attention-" in k for k in v.get("kernels", [])):
            failures.append(f"the template (pid {pid}) never loaded the "
                            f"flash library: {v.get('kernels')}")
    b = _recovery_breakdown(r) if not failures else {}
    summed = _zero_counts()
    for i in r["incarnations"]:
        for k, v in _incarnation_counts(i).items():
            summed[k] += v
    seen = {p: {k: v.get(k) for k in ("maps", "devices", "kernels")}
            for p, v in templates.items()}
    log(f"19a step caches: {r['wall_s']:.1f} s, invariants "
        f"{[(n, ok) for n, ok, _ in r['invariants']]}; first incarnation "
        f"nvcc {incs.get(0, {}).get('nvcc_s')} s (the build a replacement "
        f"host pays without the cache; compile_cache {json.dumps(first)}); "
        f"respawn compile_cache {json.dumps(respawn)}; aot_cache "
        f"{json.dumps(hit)}; templates "
        f"{json.dumps(seen)} "
        f"[{card}]")
    if b:
        log(f"19a: kill at step {b['kill_step']}, restored at step "
            f"{b['start_step']} from {b['restore_stages']['tier']}, "
            f"{b['steps_lost']} step(s) lost; retrace "
            f"{b['phases'].get('retrace')} s, aot {b['phases'].get('aot')} s; "
            f"kill -> first step {b['kill_to_first_step_s']:.3f} s: "
            f"detection {b['detect_s']:.3f} s, recovery phases "
            f"{json.dumps(b['phases'])} [{card}]")
    if failures:
        raise AssertionError("19a: " + "; ".join(failures))
    return {"launcher_warm_step_caches": summed}


# the ramp of tests/test_fleet.py::test_fleet_full_ramp_200_agents
FLEET_AGENTS = 200
FLEET_PROFILE = dict(heartbeat_interval=2.0, step_interval=1.0,
                     shard_interval=4.0, kv_interval=8.0,
                     reconnect_prob=0.002)
FLEET_SEARCH_S = 30.0


def fleet_child(workdir: str, result_path: str) -> int:
    """19b, in a process of its own that never imports torch: the
    FleetRunner's journal-backed master lives here, its 200 agents in
    packs of 50.  What this process maps goes into the result."""
    from dlrover_tpu_torch.fleet import AgentProfile, FleetRunner
    from dlrover_tpu_torch.telemetry.events import read_events

    os.environ["DLROVER_EVENT_LOG"] = os.path.join(workdir, "events.jsonl")
    runner = FleetRunner(
        max_nodes=512, profile=AgentProfile(**FLEET_PROFILE),
        workdir=os.path.join(workdir, "fleet"), fsync_window_s=0.05,
        piggyback=True, pack_size=50)
    try:
        t0 = time.perf_counter()
        level = runner._probe_level(FLEET_AGENTS, window_s=8.0, settle_s=2.0)
        level_s = time.perf_counter() - t0
        stats = runner.stats()
        t0 = time.perf_counter()
        # from the level above the one just held green
        search = runner.capacity_search(
            start=FLEET_AGENTS + 100, step=100, max_agents=500,
            window_s=4.0, settle_s=1.0, deadline_s=FLEET_SEARCH_S)
        search_s = time.perf_counter() - t0
    finally:
        runner.stop()
    reports = [e for e in read_events(os.environ["DLROVER_EVENT_LOG"])
               if e.get("type") == "fleet_report"]
    result = {
        "level": level, "level_s": level_s, "stats": stats,
        "search": search, "search_s": search_s,
        "report_agents": sorted({e["agents"] for e in reports}),
        "pid": os.getpid(), "maps": _maps_cuda(os.getpid()),
        "devices": _cuda_device_files(os.getpid()),
        "torch_loaded": "torch" in sys.modules,
    }
    with open(result_path, "w") as f:
        json.dump(result, f)
    return 0


def phase_fleet(card) -> dict:
    """19b: the fleet on the card machine's host (``fleet_child``): 200
    agents held SLO-green with no agent-side error, then the capacity
    search; the master's process maps no CUDA library."""
    workdir = tempfile.mkdtemp(prefix="dl19b")
    result_path = os.path.join(workdir, "result.json")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("DLROVER_EVENT_LOG", None)
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--fleet-child",
             workdir, result_path],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        if proc.returncode != 0 or not os.path.exists(result_path):
            raise AssertionError(f"19b: the fleet child failed "
                                 f"({proc.returncode}): {proc.stderr[-3000:]}")
        with open(result_path) as f:
            r = json.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    level, search = r["level"], r["search"]
    log(f"19b fleet: {FLEET_AGENTS} agents (packs of 50) against one "
        f"journal-backed master: green {level['green']}, "
        f"{level['mean_rps']} rps, errors {r['stats']['errors']}, error "
        f"ratio {level['error_ratio']}, per-verb p99 ms "
        f"{json.dumps(level['worst_p99_ms'])} ({r['level_s']:.1f} s); "
        f"capacity search ({r['search_s']:.1f} s, cap {FLEET_SEARCH_S} s): "
        f"max sustained {search['max_sustained_agents']} agents at "
        f"{search['rps_at_capacity']} rps, p99 ms at capacity "
        f"{json.dumps(search['p99_at_capacity_ms'])}, levels "
        f"{json.dumps(search['levels'])}, first breach "
        f"{json.dumps(search['first_breach'])}; the master's process (pid "
        f"{r['pid']}) maps {r['maps'] + r['devices']}, torch loaded "
        f"{r['torch_loaded']} [{card}]")
    failures = []
    if not level["green"] or r["stats"]["errors"]:
        failures.append(f"{FLEET_AGENTS} agents not sustained green: "
                        f"{level}, errors {r['stats']['errors']}")
    if FLEET_AGENTS not in r["report_agents"]:
        failures.append(f"no fleet_report at {FLEET_AGENTS} agents: "
                        f"{r['report_agents']}")
    if r["maps"] or r["devices"] or r["torch_loaded"]:
        failures.append(f"the master's process maps CUDA: "
                        f"{r['maps'] + r['devices']}, torch "
                        f"{r['torch_loaded']}")
    if not search["levels"]:
        failures.append("the capacity search probed no level")
    if failures:
        raise AssertionError("19b: " + "; ".join(failures))
    return {}


def phase_19(card) -> dict:
    """Phase 19: 19a and 19b, each timed."""
    out = {}
    for name, phase in (("19a", phase_step_caches), ("19b", phase_fleet)):
        t0 = time.perf_counter()
        out.update(phase(card))
        log(f"chip_smoke: phase {name} took {time.perf_counter() - t0:.1f} s")
    return out


def _free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main(argv) -> int:
    if argv[:1] == ["--launcher-child"]:
        # phase 8's agent: this process must never touch CUDA, so it
        # returns before the check below initialises the driver
        sys.path.insert(0, ROOT)
        return launcher_child(*argv[1:6])
    if argv[:1] == ["--data-child"]:
        # phase 12's agent, as phase 8's
        sys.path.insert(0, ROOT)
        return data_child(*argv[1:5])
    if argv[:1] == ["--rl-chaos-child"]:
        # phase 16c's agent, as phase 8's
        sys.path.insert(0, ROOT)
        return rl_chaos_child(*argv[1:3])
    if argv[:1] == ["--fleet-child"]:
        # phase 19b's master and agents, as phase 8's agent
        sys.path.insert(0, ROOT)
        return fleet_child(*argv[1:3])
    if argv[:1] == ["--sparse-chaos-child"]:
        # phase 17c's agent, as phase 8's
        sys.path.insert(0, ROOT)
        return sparse_chaos_child(*argv[1:3])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "dlrover_tpu_torch")):
        print("chip_smoke: run from a checkout that holds dlrover_tpu_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if argv[:1] == ["--ckpt-child"]:
        return ckpt_child(*argv[1:5])
    os.makedirs(OUT_DIR, exist_ok=True)
    # the run's own IPC namespace: sockets, and the names of its shm
    # segments, which it unlinks at the end
    sockets = tempfile.mkdtemp(prefix="dlrover-smoke-")
    os.environ["DLROVER_SHARED_DIR"] = sockets
    os.environ["DLROVER_JOB_NAME"] = f"chipsmoke{os.getpid()}"
    os.environ["DLROVER_EVENT_LOG"] = os.path.join(OUT_DIR,
                                                   "chip_smoke_events.jsonl")
    os.environ["DLROVER_METRICS_FILE"] = os.path.join(
        OUT_DIR, "chip_smoke_metrics.json")
    try:
        if argv[:1] == ["--only"]:
            return run_only(torch, argv[1].split(","))
        return run_phases(torch)
    finally:
        if "server" in CKPT_FORK:
            CKPT_FORK.pop("server").close()
        left = _unlink_segments()
        shutil.rmtree(sockets, ignore_errors=True)
        for name in os.listdir(OUT_DIR):
            if name.startswith("ckpt_") and os.path.isdir(
                    os.path.join(OUT_DIR, name)):
                shutil.rmtree(os.path.join(OUT_DIR, name),
                              ignore_errors=True)
        if left:
            log(f"chip_smoke: unlinked leftover shm segments {left}")


ONLY = {"2": phase_kernels, "3": phase_quant_kernels,
        "4": lambda card: phase_model_check(), "5b": phase_train_xl,
        "5lr": phase_small_lr,
        "6a": phase_ckpt_small, "9b": phase_fsdp_one_rank,
        "10": phase_example, "11": phase_llama, "11d": phase_llama_losses,
        "12": phase_data, "13": phase_parallel, "13a": phase_ring_blocks,
        "13b": phase_mixtral, "14": phase_scale_out,
        "14a": phase_llama_4bit_fsdp, "14b": phase_mixtral_ckpt,
        "14c": phase_offload_fsdp, "14d": phase_diloco,
        "14e": phase_tensor_one_rank, "15": phase_pipeline_fp8,
        "15a": phase_pipeline_xl, "15b": phase_fp8, "16": phase_rl,
        "16a": phase_rl_ppo, "16b": phase_llama_decode,
        "16c": phase_rl_chaos, "17": phase_sparse,
        "17a": phase_sparse_deepfm, "17b": phase_sparse_ckpt,
        "17c": phase_sparse_chaos, "17d": phase_sparse_serving,
        "18": phase_slice_5_4, "18a": phase_bert, "18b": phase_train_xl,
        "19": phase_19, "19a": phase_step_caches, "19b": phase_fleet}


def run_only(torch, names) -> int:
    """``--only 2,11``: the build, then the named phases alone (a quick
    check of one path; the full run, with no arguments, is the card's
    check and prints the result lines)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    phase_build()
    for name in names:
        t0 = time.perf_counter()
        ONLY[name](card)
        _free_cuda()
        log(f"chip_smoke: phase {name} took {time.perf_counter() - t0:.1f} s")
    print(card)
    return 0


def run_phases(torch) -> int:
    # the plain versions' fp32 products must be full fp32 for the 1e-4
    # comparison (these are PyTorch's defaults, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        _free_cuda()
        log(f"chip_smoke: phase {name} took {time.perf_counter() - t0:.1f} s")
        return out

    timed("1 build", phase_build)
    # 6a's fork template imports while phases 2-5 run
    _ckpt_fork_server()
    timings = timed("2 flash kernels", phase_kernels, card)
    timed("2 flash repairs", phase_flash_repairs, card)
    timed("2 flash wide head dims", time_wide, card)
    timings.update(timed("3 quantization kernels", phase_quant_kernels, card))
    timed("4 model check", phase_model_check)
    by_path = {}
    for path, name, phase in (
            ("gpt2_small_adamw", "5a", phase_train_small_adamw),
            ("gpt2_xl_int8_qadamw", "5b", phase_train_xl),
            ("gpt2_small_4bit_qadamw", "5c", phase_train_small_4bit)):
        by_path[path] = timed(name, phase, card)
    for name, phase in (("6a", phase_ckpt_small), ("6b", phase_ckpt_xl),
                        ("7", phase_control_plane)):
        by_path.update(timed(name, phase, card))
    by_path.update(timed("8", phase_launcher, card))
    for name, phase in (("9a", phase_search_xl), ("9b", phase_fsdp_one_rank),
                        ("9c", phase_offload_xl),
                        ("9d", phase_trainer_strategy),
                        ("10", phase_example), ("11", phase_llama),
                        ("12", phase_data), ("13", phase_parallel),
                        ("14", phase_scale_out),
                        ("15", phase_pipeline_fp8), ("16", phase_rl),
                        ("17", phase_sparse), ("18a", phase_bert),
                        ("19", phase_19)):
        by_path.update(timed(name, phase, card))
    by_path["gpt2_xl_save_attn"] = SAVE_ATTN["counts"]
    leaked = [n for n in os.listdir("/dev/shm")
              if n.startswith(f"dlrover_tpu_ckpt_shm_"
                              f"{os.environ['DLROVER_JOB_NAME']}_")]
    if leaked:
        raise AssertionError(f"shm segments left behind: {leaked}")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = timings[name]
        launches = {path: counts[name] for path, counts in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call_ms": t["library_call_ms"],
        })
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
