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
   small (b=8, s=1024, h=12, d=64, bf16, causal) and GPT-2 XL (b=4,
   h=25) and at small non-causal, GQA, ragged, head_dim-128 and fp32
   cases, and hold the bf16 dK/dV kernel to fp32 p and dS and the bf16
   dQ kernel to dS rounded to bf16 (each closer to the plain version
   at the TPU kernel's rounding point than to one at the other); time
   each at both training shapes, on the device alone and per call
   with the host's launch path inside, beside its bound, its plain
   version and scaled_dot_product_attention (a yardstick that the
   port never calls), and the backward pair beside SDPA's backward;
3. hold each quantization kernel (quantize, dequantize, the fused
   q-AdamW step) against its plain version on the card at GPT-2 XL's
   leaves (``wte`` as [39300, 2048], an ``fc_in`` weight as
   [5000, 2048]; bf16 and fp32), a ragged leaf, blocks 64 and 128,
   qmax 7, an all-zero row and a row of exact .5 ties; time each at
   ``wte`` beside its bound, its plain version and, for dequantize,
   ``torch.mul(q, scales)`` (a yardstick the port never calls);
4. check a small GPT on the card: the flash model against the plain
   attention model, logits and gradients;
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
      agent's ``AsyncCheckpointSaver``; child 1 trains 4 steps
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
   The run uses a socket directory and ``DLROVER_JOB_NAME`` of its own
   and unlinks its shm segments and removes its checkpoint directories
   at the end, on failure too.

Prints the card, a ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Exits non-zero with no result
when there is no CUDA device or no package beside the script.
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
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chip_smoke_out")

# H100 SXM data-sheet peaks (dense): HBM bytes/s, FLOP/s by input type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

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
}

# (b, s, h, kv_heads, d, dtype, causal): the training shapes first, GPT-2
# small's (the one in the kernels line) and GPT-2 XL's
CASES = [
    (8, 1024, 12, 12, 64, "bfloat16", True),
    (4, 1024, 25, 25, 64, "bfloat16", True),
    (2, 200, 4, 4, 64, "bfloat16", False),    # ragged last tile
    (2, 328, 8, 4, 64, "bfloat16", True),     # GQA group 2, ragged
    (2, 384, 4, 4, 128, "bfloat16", True),
    (1, 136, 4, 2, 128, "bfloat16", True),    # d 128, GQA, ragged
    (2, 512, 4, 4, 64, "float32", True),
    (2, 320, 8, 2, 128, "float32", False),
    (1, 100, 2, 2, 64, "float32", True),
]
TIMED_CASES = 2
# dtype -> tolerance on (out, dq, dk, dv), lse, delta: bf16 outputs are
# rounded once more than the fp32 math inside; fp32 differs only by
# the order of the sums
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2, lse=1e-3, delta=1e-3),
       "float32": dict(atol=1e-4, rtol=0.0, lse=1e-4, delta=1e-4)}
# bf16 dK/dV and dQ: the largest ratio of mean errors to the plain
# version at the TPU kernel's rounding point and to the one at the other
# point (_check_dkv_rounding, _check_dq_rounding)
ROUNDING_RATIO = 0.8

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
]
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
            **{f"quantization.{k}": v for k, v in qz.LAUNCHES.items()}}


# the kernels that must issue wgmma and TMA copies
WGMMA_KERNELS = ("fwd_tma_kernel", "dkv_tma_kernel", "dq_tma_kernel")


def _kernel_name(mangled: str) -> str:
    """``fwd_tma_kernel<64>`` from an Itanium-mangled template name."""
    import re

    m = re.search(r"\d+([a-z_]+kernel)I(?:Li(\d+)E)?", mangled)
    if not m:
        return mangled[:60]
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


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
    esz = 2 if dtype == "bfloat16" else 4
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


def _check_dkv_rounding(q, k, v, dout, lse, delta, scale, causal, blocks,
                        dk, dv, failures, case):
    """The bf16 dK/dV kernel keeps p and dS at fp32 precision (the TPU
    kernel's rounding point, by a bf16 hi+lo split), which TOL cannot
    tell from rounding them to bf16.  The mean error to the plain
    version with fp32 p and dS must be well under the mean error to one
    that rounds them to bf16: ~0.63 of it for a kernel that keeps fp32,
    ~1.6 for one that rounds (both outputs rounded to bf16 once).
    Returns the two ratios (dk, dv)."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    f32 = [x.float() for x in (q, k, v, dout)]
    fine = fa.bwd_dkv_plain(*f32, lse, delta, scale, causal, *blocks)
    coarse = fa.bwd_dkv_plain(*f32, lse, delta, scale, causal, *blocks,
                              operand_dtype=torch.bfloat16)
    ratios = []
    for name, got, a, b in zip(("dk", "dv"), (dk, dv), fine, coarse):
        got = got.float()
        ratio = ((got - a).abs().mean() / (got - b).abs().mean()).item()
        ratios.append(ratio)
        if not ratio <= ROUNDING_RATIO:
            failures.append(f"{case} {name}: closer to bf16 p and dS than "
                            f"to fp32 (error ratio {ratio:.4f})")
    return ratios


def _check_dq_rounding(q, k, v, dout, lse, delta, scale, causal, blocks, dq,
                       failures, case):
    """The bf16 dQ kernel rounds dS to bf16 before dS K, as the TPU
    kernel does (``ds.astype(k.dtype)``), which TOL cannot tell from
    keeping it fp32.  The mean error to the plain version with bf16 dS
    (fp32 out) must be well under the mean error to one that keeps dS
    fp32: ~0.63 of it for a kernel that rounds, ~1.6 for one that does
    not (the output rounded to bf16 once either way).  Returns the
    ratio."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    fine = fa.bwd_dq_plain(qf, kf, vf, dof, lse, delta, scale, causal,
                           *blocks)
    # k in bf16 rounds dS to bf16 (ds.to(k.dtype)); q in fp32 keeps dq fp32
    coarse = fa.bwd_dq_plain(qf, k, vf, dof, lse, delta, scale, causal,
                             *blocks)
    got = dq.float()
    ratio = ((got - coarse).abs().mean() / (got - fine).abs().mean()).item()
    if not ratio <= ROUNDING_RATIO:
        failures.append(f"{case} dq: closer to fp32 dS than to bf16 dS "
                        f"(error ratio {ratio:.4f})")
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
        if dtype is torch.bfloat16:
            ratios = _check_dkv_rounding(q, k, v, dout, lse_p, delta_p, scale,
                                         causal, blocks, dk_c, dv_c,
                                         failures, case)
            log(f"dkv rounding point {case}: mean error to the fp32-p/dS "
                f"version over that to the bf16-p/dS one, dk "
                f"{ratios[0]:.4f}, dv {ratios[1]:.4f} (must be <= "
                f"{ROUNDING_RATIO})")
            dq_ratio = _check_dq_rounding(q, k, v, dout, lse_p, delta_p, scale,
                                          causal, blocks, dq_c, failures,
                                          case)
            log(f"dq rounding point {case}: mean error to the bf16-dS "
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
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

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
                 optim_factory=None):
    """Train ``cfg`` from seed 0 on one fixed batch of random tokens
    through ``Trainer.train()``, with every launch count set to 0 just
    before and read just after; check the losses, the exact launch
    counts (``expected``), the train_step events and the metrics file.
    The Trainer's final checkpoint goes to a directory of the run,
    which is removed once the save is committed.
    Returns ``(trainer, result, counts)``."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.gpt import GPT, count_params
    from dlrover_tpu_torch.telemetry.events import read_events
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    t0 = time.perf_counter()
    model = GPT(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"{label}: {count_params(model)} params, {cfg.num_layers} layers, "
        f"d {cfg.hidden_dim}, dtype {cfg.dtype}, params {cfg.param_dtype}, "
        f"remat {cfg.remat}, built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
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
            logging_steps=1)
        trainer = Trainer(model, args, train_data, _loss_fn,
                          optim_factory=optim_factory)
        if os.path.exists(os.environ["DLROVER_EVENT_LOG"]):
            os.unlink(os.environ["DLROVER_EVENT_LOG"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        result = trainer.train()
        counts = launch_counts()
        # train() reads its training peak before the final save, whose
        # snapshot copies the state on the card
        peak_ckpt = torch.cuda.max_memory_allocated()
        commit_s = _wait_committed(out, steps)
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
    # model FLOPs: 6 per weight per token (the tied head included, the
    # position table not) plus causal attention, 6 L s d per token; the
    # remat recompute is not counted
    weights = count_params(model) - model.wpe.weight.numel()
    flops = 6 * tokens * (weights + cfg.num_layers * seq * cfg.hidden_dim)
    log(f"{label}: median step {step_s * 1e3:.3f} ms over steps 3..{steps}, "
        f"{tokens / step_s:.1f} tokens/s, model FLOPs utilisation "
        f"{flops / step_s / PEAK_FLOPS['bfloat16']:.4f} of 989 TFLOP/s, "
        f"step times {[round(t * 1e3, 3) for t in result['step_seconds']]} "
        f"ms, peak memory {result['peak_bytes'] / 2**30:.2f} GiB [{card}]")
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
    trainer, _, counts = run_training(
        "train GPT-2 small AdamW", cfg, global_batch, micro, steps, expected,
        card)
    profile_step(trainer, trainer.train_data[0], card, "GPT-2 small AdamW")
    return counts


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
    opt = trainer.state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    if len(params) != n_params:
        raise AssertionError(f"{len(params)} parameters, not {n_params}")
    peak = result["peak_bytes"]
    moment_bytes = sum(t.numel() * t.element_size()
                       for st in opt.state.values() for t in st.values()
                       if torch.is_tensor(t))
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    log(f"train GPT-2 XL int8 q-AdamW: peak memory {peak / 2**30:.2f} GiB, "
        f"moment state (int8 codes + fp32 scales) {moment_bytes / 2**30:.3f} "
        f"GiB = {moment_bytes / peak:.4f} of the peak, params "
        f"{param_bytes / 2**30:.3f} GiB [{card}]")
    bound = sum(qadam_bytes(p.numel(), opt.block_size, p.element_size())
                for p in params)
    _check_multi_against_per_leaf(opt, card)
    from dlrover_tpu_torch.ops import quantization as qz

    # the optimizer alone, on the gradients of the last step: the host's
    # time to queue it, the wall to its end (synchronised), and its time
    # on the device with the card held until the host has queued it
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
    log(f"train GPT-2 XL int8 q-AdamW: optimizer step host "
        f"{statistics.median(hosts):.3f} ms to queue, wall "
        f"{statistics.median(walls):.3f} ms to its end, device "
        f"{device:.3f} ms ({launches} fused launch(es) a step over "
        f"{n_params} parameters), summed bound of the fused step "
        f"{bound / 1e9:.3f} GB / 3.35 TB/s = "
        f"{bound / PEAK_BYTES_S * 1e3:.3f} ms [{card}]")
    profile_step(trainer, trainer.train_data[0], card, "GPT-2 XL int8 q-AdamW")
    return counts


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
        card, optim_factory=lambda ps: q_adamw(ps, lr=1e-3, bits=4))
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
        micro_batch_size=8, logging_steps=1, save_steps=2)
    return Trainer(GPT(cfg, seed=0), args,
                   [{"x": data[:, :-1], "y": data[:, 1:]}], _loss_fn)


def ckpt_child(role: str, out: str, result_path: str) -> int:
    """One incarnation of phase 6a's trainer, in a process of its own.

    ``kill``: 4 steps from scratch, then SIGKILL without closing
    anything.  ``resume``: resume at step 4 (no step taken: the params
    as restored), then a second Trainer resumes again and takes steps 5
    and 6.  ``storage``: resume at step 6 from storage.  Writes what it
    saw to ``result_path`` as JSON before it ends."""
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
    with open(log_path, "w") as f:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--ckpt-child", role,
             out, path], cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
            timeout=600)
    seconds = time.perf_counter() - t0
    want = -signal.SIGKILL if role == "kill" else 0
    if proc.returncode != want or not os.path.exists(path):
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"checkpoint child {role} ended with "
                             f"{proc.returncode}, not {want}:\n{tail}")
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


def _free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main(argv) -> int:
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
        return ckpt_child(*argv[1:4])
    os.makedirs(OUT_DIR, exist_ok=True)
    # the run's own IPC namespace: sockets, and the names of its shm
    # segments, which it unlinks at the end
    sockets = tempfile.mkdtemp(prefix="dlrover-smoke-")
    os.environ["DLROVER_SHARED_DIR"] = sockets
    os.environ["DLROVER_JOB_NAME"] = f"chipsmoke{os.getpid()}"
    try:
        return run_phases(torch)
    finally:
        left = _unlink_segments()
        shutil.rmtree(sockets, ignore_errors=True)
        for name in os.listdir(OUT_DIR):
            if name.startswith("ckpt_") and os.path.isdir(
                    os.path.join(OUT_DIR, name)):
                shutil.rmtree(os.path.join(OUT_DIR, name),
                              ignore_errors=True)
        if left:
            log(f"chip_smoke: unlinked leftover shm segments {left}")


def run_phases(torch) -> int:
    os.environ["DLROVER_EVENT_LOG"] = os.path.join(OUT_DIR,
                                                   "chip_smoke_events.jsonl")
    os.environ["DLROVER_METRICS_FILE"] = os.path.join(
        OUT_DIR, "chip_smoke_metrics.json")
    # the plain versions' fp32 products must be full fp32 for the 1e-4
    # comparison (these are PyTorch's defaults, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build()
    timings = phase_kernels(card)
    _free_cuda()
    timings.update(phase_quant_kernels(card))
    _free_cuda()
    phase_model_check()
    by_path = {}
    for path, phase in (("gpt2_small_adamw", phase_train_small_adamw),
                        ("gpt2_xl_int8_qadamw", phase_train_xl),
                        ("gpt2_small_4bit_qadamw", phase_train_small_4bit)):
        by_path[path] = phase(card)
        _free_cuda()
    for phase in (phase_ckpt_small, phase_ckpt_xl):
        by_path.update(phase(card))
        _free_cuda()
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
