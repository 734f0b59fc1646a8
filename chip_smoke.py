#!/usr/bin/env python3
"""Drive the PyTorch port (``dlrover_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the CUDA kernels of ``dlrover_tpu_torch/csrc`` with nvcc
   (one process per source, all started together);
2. hold each flash-attention kernel (fwd, bwd_dq, bwd_dkv) against its
   plain PyTorch version on the card, at the training shapes
   (b=8, s=1024, h=12, d=64, bf16, causal) and at small non-causal,
   GQA, head_dim-128 and fp32 cases; time each beside its bound, its
   plain version and scaled_dot_product_attention (a yardstick that
   the port never calls);
3. check a small GPT on the card: the flash model against the plain
   attention model, logits and gradients;
4. train GPT-2 small (seq 1024, global batch 32, micro-batch 8) through
   ``Trainer.train()`` and check that the loss is finite and falls and
   that every kernel launched as often as the model needs.

Prints the card, a ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Exits non-zero with no result
when there is no CUDA device or no package beside the script.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chip_smoke_out")

# H100 SXM data-sheet peaks (dense): HBM bytes/s, FLOP/s by input type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "fwd": ("dlrover_tpu_torch/csrc/flash_attention.cu",
            "dlrover_tpu/ops/flash_attention.py:70 (_fwd_kernel, via _fwd :137)"),
    "bwd_dq": ("dlrover_tpu_torch/csrc/flash_attention.cu",
               "dlrover_tpu/ops/flash_attention.py:195 (_bwd_dq_kernel, via _bwd :318)"),
    "bwd_dkv": ("dlrover_tpu_torch/csrc/flash_attention.cu",
                "dlrover_tpu/ops/flash_attention.py:252 (_bwd_dkv_kernel, via _bwd :318)"),
}

# (b, s, h, kv_heads, d, dtype, causal): the training shape first
CASES = [
    (8, 1024, 12, 12, 64, "bfloat16", True),
    (2, 200, 4, 4, 64, "bfloat16", False),    # ragged last tile
    (2, 328, 8, 4, 64, "bfloat16", True),     # GQA group 2, ragged
    (2, 384, 4, 4, 128, "bfloat16", True),
    (1, 136, 4, 2, 128, "bfloat16", True),    # d 128, GQA, ragged
    (2, 512, 4, 4, 64, "float32", True),
    (2, 320, 8, 2, 128, "float32", False),
    (1, 100, 2, 2, 64, "float32", True),
]
# dtype -> tolerance on (out, dq, dk, dv), lse, delta: bf16 outputs are
# rounded once more than the fp32 math inside; fp32 differs only by
# the order of the sums
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2, lse=1e-3, delta=1e-3),
       "float32": dict(atol=1e-4, rtol=0.0, lse=1e-4, delta=1e-4)}

TRAIN_GLOBAL, TRAIN_MICRO, TRAIN_SEQ, TRAIN_STEPS = 32, 8, 1024, 6


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_build():
    from dlrover_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    seconds = cuda_build.build(["flash_attention"])
    log(f"build: {json.dumps(seconds)} (wall {time.perf_counter() - t0:.1f} s)")
    ptxas = cuda_build.library_path("flash_attention").with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


def _pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def bounds_ms(b, s, h, kvh, d, dtype, causal):
    """Least time per kernel: each input read once, each output written
    once, over HBM; the products the kernel must do over the peak of
    the input type; the larger of the two."""
    esz = 2 if dtype == "bfloat16" else 4
    qo = b * s * h * d * esz          # q, out, dout, dq: [b, s, h, d]
    kv = b * s * kvh * d * esz        # k, v, dk, dv
    rows = b * h * s * 4              # lse, delta: fp32 [b, h, s]
    pairs = b * h * _pairs(s, causal)
    work = {
        # bytes moved, FLOPs (2 d per pair per product)
        "fwd": (qo + 2 * kv + qo + rows, 2 * 2 * d * pairs),
        "bwd_dq": (qo + 2 * kv + 2 * qo + rows + qo + rows,
                   3 * 2 * d * pairs),
        "bwd_dkv": (qo + 2 * kv + qo + 2 * rows + 2 * kv,
                    4 * 2 * d * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_S
        t_ops = flops / PEAK_FLOPS[dtype]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def _check(name, got, want, atol, rtol, failures, case):
    import torch

    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (err <= atol + rtol * want.float().abs()).all()
    )
    if not ok:
        failures.append(f"{case} {name}: max_abs_err {err.max().item():.3e}")
    return err.max().item()


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
        blocks = (fa._fit_block(s, 128), fa._fit_block(s, 128))
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
            "fwd": max(_check("out", out_c, out_p, at, rt, failures, case),
                       _check("lse", lse_c, lse_p, tol["lse"], 0.0,
                              failures, case)),
            "bwd_dq": max(_check("dq", dq_c, dq_p, at, rt, failures, case),
                          _check("delta", delta_c, delta_p, tol["delta"],
                                 0.0, failures, case)),
            "bwd_dkv": max(_check("dk", dk_c, dk_p, at, rt, failures, case),
                           _check("dv", dv_c, dv_p, at, rt, failures, case)),
        }
        log(f"kernel check {case}: " + ", ".join(
            f"{n} max_abs_err {e:.3e}" for n, e in errs.items())
            + f" (tolerance {tol})")
        if case is CASES[0]:
            results = _time_main_case(case, q, k, v, dout, out_p, lse_p,
                                      delta_p, blocks, errs, card)
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
        "fwd": lambda: fa.fwd_cuda(q, k, v, scale, causal),
        "bwd_dq": lambda: fa.bwd_dq_cuda(q, k, v, out, dout, lse, scale,
                                         causal),
        "bwd_dkv": lambda: fa.bwd_dkv_cuda(q, k, v, dout, lse, delta, scale,
                                           causal),
    }
    plain_fns = {
        "fwd": lambda: fa.fwd_plain(q, k, v, scale, causal, *blocks),
        "bwd_dq": lambda: fa.bwd_dq_plain(q, k, v, dout, lse, delta, scale,
                                          causal, *blocks),
        "bwd_dkv": lambda: fa.bwd_dkv_plain(q, k, v, dout, lse, delta,
                                            scale, causal, *blocks),
    }
    # the yardstick: one library call on the same inputs, [b, h, s, d]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in
                  (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dt)

    sdpa_fwd = median_ms(sdpa, 20)
    sdpa_both = median_ms(sdpa_fwd_bwd, 20)
    log(f"sdpa yardstick {case}: fwd {sdpa_fwd:.4f} ms, fwd+bwd "
        f"{sdpa_both:.4f} ms, bwd {sdpa_both - sdpa_fwd:.4f} ms [{card}]")
    bounds = bounds_ms(*case)
    results = {}
    for name in KERNELS:
        ms = median_ms(kernel_fns[name], 20)
        plain = median_ms(plain_fns[name], 3, warmup=1)
        bound, bound_by = bounds[name]
        results[name] = dict(
            max_abs_err=errs[name], ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=bound_by,
            library_ms=sdpa_fwd if name == "fwd" else None,
        )
        log(f"kernel {name} {case}: {ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}), plain {plain:.4f} ms [{card}]")
    return results


def phase_model_check():
    """A small GPT with head_dim 64 on the card: the flash model
    against the plain-attention model from the same weights."""
    import torch

    from dlrover_tpu_torch.models.gpt import (
        GPT,
        GPTConfig,
        cross_entropy_loss,
    )

    tokens = torch.randint(0, 512, (2, 201), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    x, y = tokens[:, :-1], tokens[:, 1:]
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        results = {}
        for impl in ("xla", "flash"):
            cfg = GPTConfig.tiny(vocab_size=512, max_seq_len=200,
                                 num_heads=2, hidden_dim=128,
                                 attention_impl=impl, dtype=dtype)
            model = GPT(cfg, device="cuda", seed=3)
            logits = model(x)
            cross_entropy_loss(logits, y).backward()
            grads = {n: p.grad for n, p in model.named_parameters()}
            results[impl] = (logits, grads)
        (lx, gx), (lf, gf) = results["xla"], results["flash"]
        if lf.shape != (2, 200, 512) or not bool(torch.isfinite(lf).all()):
            raise AssertionError(f"flash GPT logits {lf.shape} not finite")
        err = (lx - lf).abs().max().item()
        gerr = max((gx[n] - gf[n]).abs().max().item() for n in gx)
        log(f"model check {dtype}: logits max_abs_err {err:.3e}, "
            f"grads max_abs_err {gerr:.3e} (tolerance {atol})")
        if err > atol or gerr > atol:
            raise AssertionError(f"flash GPT disagrees with plain GPT "
                                 f"in {dtype}: {err:.3e} / {gerr:.3e}")


def phase_train(steps: int, card: str):
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.gpt import (
        GPT,
        GPTConfig,
        count_params,
        cross_entropy_loss,
    )
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.telemetry.events import read_events
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    cfg = GPTConfig.gpt2_small(max_seq_len=TRAIN_SEQ, attention_impl="flash")
    model = GPT(cfg, seed=0)
    log(f"train: GPT-2 small, {count_params(model)} params, "
        f"{cfg.num_layers} layers, dtype {cfg.dtype}, remat {cfg.remat}")
    # one global batch of random tokens from a seed, cycled: the loss
    # falls as the model fits it
    rng = np.random.default_rng(0)
    data = rng.integers(0, cfg.vocab_size, (TRAIN_GLOBAL, TRAIN_SEQ + 1),
                        dtype=np.int32)
    train_data = [{"x": data[:, :-1], "y": data[:, 1:]}]

    def loss_fn(module, batch):
        return cross_entropy_loss(module(batch["x"]), batch["y"])

    args = TrainingArguments(
        max_steps=steps, global_batch_size=TRAIN_GLOBAL,
        micro_batch_size=TRAIN_MICRO, logging_steps=1,
    )
    trainer = Trainer(model, args, train_data, loss_fn)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    result = trainer.train()
    counts = dict(fa.LAUNCHES)

    losses = result["losses"]
    grad_accum = TRAIN_GLOBAL // TRAIN_MICRO
    per_step = cfg.num_layers * grad_accum
    expected = {"fwd": per_step * steps * (2 if cfg.remat else 1),
                "bwd_dq": per_step * steps, "bwd_dkv": per_step * steps}
    log(f"train: losses {losses}")
    log(f"train: launches {counts}, expected {expected}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != {expected}")
    events = [e for e in read_events(os.environ["DLROVER_EVENT_LOG"])
              if e.get("type") == "train_step"]
    if len(events) != steps:
        raise AssertionError(f"{len(events)} train_step events, not {steps}")
    with open(os.environ["DLROVER_METRICS_FILE"]) as f:
        if json.load(f)["global_step"] != steps:
            raise AssertionError("metrics file does not hold the last step")
    steady = result["step_seconds"][2:]
    step_s = statistics.median(steady)
    tokens = TRAIN_GLOBAL * TRAIN_SEQ
    # model FLOPs: 6 per weight per token (the tied head included, the
    # position table not) plus causal attention, 6 L s d per token
    weights = count_params(model) - model.wpe.weight.numel()
    flops = 6 * tokens * (weights + cfg.num_layers * TRAIN_SEQ
                          * cfg.hidden_dim)
    log(f"train: median step {step_s * 1e3:.3f} ms over steps 3..{steps}, "
        f"{tokens / step_s:.1f} tokens/s, model FLOPs utilisation "
        f"{flops / step_s / PEAK_FLOPS['bfloat16']:.4f} of 989 TFLOP/s, "
        f"step times {[round(t * 1e3, 3) for t in result['step_seconds']]} "
        f"ms, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB [{card}]")
    profile_step(trainer, train_data[0], card)
    return {name: n // steps for name, n in counts.items()}, counts


def profile_step(trainer, batch, card):
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
    # device kernels only: the CPU ops' rows repeat their kernels' time
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(f"{card}\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40))
    busy = sum(r[0] for r in rows)
    if not busy:
        log("profile: the profiler recorded no device time")
        return
    families = {"flash attention (this port)": 0.0, "matmul": 0.0,
                "other": 0.0}
    for us, _, key in rows:
        if "FlashParams" in key:
            families["flash attention (this port)"] += us
        elif any(k in key.lower() for k in ("gemm", "nvjet", "xmma",
                                             "cutlass")):
            families["matmul"] += us
        else:
            families["other"] += us
    log(f"profile: step wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({busy / wall_us:.4f} of the step, "
        f"profiler on); " + ", ".join(
            f"{k} {v / 1e3:.3f} ms ({v / busy:.4f})"
            for k, v in families.items()) + f" [{card}]")
    for us, count, key in rows[:8]:
        log(f"profile:   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "dlrover_tpu_torch")):
        print("chip_smoke: run from a checkout that holds dlrover_tpu_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    os.environ["DLROVER_EVENT_LOG"] = os.path.join(OUT_DIR,
                                                   "chip_smoke_events.jsonl")
    os.environ["DLROVER_METRICS_FILE"] = os.path.join(
        OUT_DIR, "chip_smoke_metrics.json")
    if os.path.exists(os.environ["DLROVER_EVENT_LOG"]):
        os.unlink(os.environ["DLROVER_EVENT_LOG"])
    # the plain versions' fp32 products must be full fp32 for the 1e-4
    # comparison (these are PyTorch's defaults, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build()
    timings = phase_kernels(card)
    phase_model_check()
    per_step, counts = phase_train(TRAIN_STEPS, card)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = timings[name]
        kernels.append({
            "name": f"flash_attention.{name}", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": counts[name], "launches_per_step": per_step[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
