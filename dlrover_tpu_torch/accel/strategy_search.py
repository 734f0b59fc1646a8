"""Strategy search: mesh factorizations x remat x grad-accum, memory
pruned, dry-run ranked, BO-guided under a budget.

Mostly a copy of ``dlrover_tpu/accel/strategy_search.py``: the same
candidates in the same order (``describe()`` for ``describe()``), the
same pruning and the same three rank modes.  The differences: the
candidates carry ``module_replace`` (the CUDA flash kernels) when the
job runs on the card, as the reference adds it on the TPU; the cost
tier is the port's own count (:func:`dry_runner.estimate_plan`); and
a profiled candidate fails only by running out of memory.
Reference of that file: the acceleration-engine strategy generation —
exhaustive combination (``atorch/auto/engine/sg_algo/combination_sg.py``)
plus Bayesian optimization (``bayes_opt_sg.py`` / vendored HEBO) —
conducted through the engine's task queue.  This search generates
candidate (data, fsdp, tensor) mesh factorizations with remat and
gradient-accumulation knobs, prunes by the analyser's memory model, and
ranks the survivors with real dry-run step timings.  When there are
more candidates than the dry-run budget, a GP/EI optimizer
(:mod:`dlrover_tpu.brain.bo`) picks which to measure next.
"""

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.accel.analyser import analyse, fits_in_hbm
from dlrover_tpu_torch.accel.strategy import Strategy
from dlrover_tpu_torch.brain.bo import BayesianOptimizer, Parameter
from dlrover_tpu_torch.common.log import default_logger as logger


@dataclass
class Candidate:
    strategy: Strategy
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    expert: int = 1
    remat: bool = False
    act_offload: bool = False   # remat + pinned host checkpoints
    grad_accum: int = 1
    half: bool = False          # bf16 param storage
    low_bit_opt: bool = False   # int8 optimizer moments
    step_time_s: Optional[float] = None
    est_step_time_s: Optional[float] = None  # cost-model rank (hybrid)
    # the profile's peak device memory, and why it failed (out of memory)
    peak_bytes: Optional[int] = None
    error: str = ""

    def features(self) -> Dict[str, float]:
        return {
            "log_fsdp": math.log2(self.fsdp),
            "log_tensor": math.log2(self.tensor),
            "log_seq": math.log2(self.sequence),
            "log_expert": math.log2(self.expert),
            "remat": float(self.remat),
            "act_offload": float(self.act_offload),
            "log_accum": math.log2(self.grad_accum),
            "half": float(self.half),
            "low_bit": float(self.low_bit_opt),
        }

    def describe(self) -> str:
        return (
            f"data{self.data}xfsdp{self.fsdp}xtp{self.tensor}"
            f"{f'xsp{self.sequence}' if self.sequence > 1 else ''}"
            f"{f'xep{self.expert}' if self.expert > 1 else ''}"
            f"{'+remat' if self.remat else ''}"
            f"{'+actoffload' if self.act_offload else ''}"
            f"{f'+ga{self.grad_accum}' if self.grad_accum > 1 else ''}"
            f"{'+half' if self.half else ''}"
            f"{'+int8opt' if self.low_bit_opt else ''}"
        )


def mesh_factorizations(num_devices: int) -> List[Tuple[int, int, int]]:
    """(data, fsdp, tensor) triples with product == num_devices."""
    out = []
    for fsdp in _divisors(num_devices):
        for tensor in _divisors(num_devices // fsdp):
            data = num_devices // (fsdp * tensor)
            out.append((data, fsdp, tensor))
    return out


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _build_strategy(
    data: int, fsdp: int, tensor: int, remat: bool, grad_accum: int,
    sequence: int = 1, expert: int = 1,
    half: bool = False, low_bit_opt: bool = False,
    act_offload: bool = False, on_cuda: bool = False,
) -> Strategy:
    opts: List[Tuple[str, Dict]] = []
    if tensor > 1 or expert > 1 or (fsdp > 1 and sequence > 1):
        opts.append((
            "mixed_parallel",
            {"tensor": tensor, "fsdp": fsdp, "expert": expert,
             "data": -1},
        ))
    elif fsdp > 1:
        opts.append(("fsdp", {"size": fsdp}))
    else:
        opts.append(("parallel_mode", {}))
    if sequence > 1:
        opts.append((
            "sequence_parallel", {"size": sequence, "mode": "ring"},
        ))
    opts.append(("half", {}) if half else ("amp_native", {}))
    if low_bit_opt:
        opts.append(("low_bit_opt", {"bits": 8}))
    if act_offload:
        opts.append(("offload_activation", {}))
    elif remat:
        opts.append(("checkpoint", {}))
    if on_cuda:
        # fixed module-replacement pass on the card (reference:
        # module_replace_optimization always swaps FA in when legal, and
        # the TPU package adds it on the TPU); skipped on the CPU, where
        # the flash wrapper would take its plain version
        opts.append(("module_replace", {"attention": "flash"}))
    return Strategy(opts=opts)


def _on_cuda(context) -> bool:
    device = getattr(context, "device", None)
    return device is not None and torch.device(device).type == "cuda"


def generate_candidates(
    context,
    num_devices: int,
    grad_accums: Tuple[int, ...] = (1, 2),
    max_tensor: int = 8,
    long_seq_threshold: int = 8192,
    num_slices: int = 1,
    analysis=None,
) -> List[Candidate]:
    """Combination generation pruned by the memory model (reference:
    combination_sg.py).  Model-aware axes: MoE configs get
    expert-parallel variants, long sequences get ring
    sequence-parallel variants (the tensor slot of each factorization
    is repurposed — both shard the same "model" dimension budget).

    ``num_slices`` > 1 (several nodes): only factorizations whose
    ``data`` axis, which may span nodes, absorbs the node count survive
    — fsdp/tensor/sequence/expert collectives must never cross the
    network between nodes (``parallel.mesh.DCN_AXES`` placement rule)."""
    if analysis is None:
        analysis = analyse(context)
    on_cuda = _on_cuda(context)
    batch = max(1, analysis.batch_size)
    model_cfg = getattr(context.model, "config", None)
    is_moe = bool(getattr(model_cfg, "moe_experts", 0))
    long_seq = analysis.seq_len >= long_seq_threshold
    cands: List[Candidate] = []
    seen = set()
    for data, fsdp, tensor in mesh_factorizations(num_devices):
        if tensor > max_tensor:
            continue
        if num_slices > 1 and data % num_slices:
            # NVLink-hungry axes would straddle nodes
            continue
        # the third factor is a "model-dim shard" budget: try it as
        # tensor parallel, and — when the model calls for it — as
        # expert or ring-sequence parallel instead
        variants = [(tensor, 1, 1)]
        num_experts = int(getattr(model_cfg, "moe_experts", 0) or 0)
        if (
            tensor > 1 and is_moe
            and num_experts % tensor == 0  # expert dim must shard
        ):
            variants.append((1, 1, tensor))   # expert
        if (
            tensor > 1 and long_seq
            and analysis.seq_len % tensor == 0
        ):
            variants.append((1, tensor, 1))   # ring sp
        # int8-moment variants swap the user optimizer for q_adamw —
        # a training-semantics change (the user's optax chain and LR
        # schedule are replaced) — so they are OPT-IN:
        # context.extra["search_optimizer"] = True enables them
        search_opt = bool(
            getattr(context, "extra", {}).get("search_optimizer", False)
        )
        for tp, sp, ep in variants:
            # precision levels, cheapest-memory last (the single-device
            # levers: bf16 param storage, int8 optimizer moments)
            for half, lowbit in (
                (False, False), (True, False), (True, True),
            ):
                if lowbit and not search_opt:
                    continue
                # act_offload (pinned host checkpoints) is a MEMORY
                # fallback lever: only emitted when plain remat does
                # not fit (it adds D2H/H2D traffic, never wins on
                # speed when remat alone fits)
                for remat, act_off in (
                    (False, False), (True, False), (True, True),
                ):
                    if act_off and fits_in_hbm(
                        analysis, fsdp, tp, True,
                        seq_shards=sp, expert_shards=ep,
                        half=half, low_bit_opt=lowbit,
                    ):
                        continue
                    if not fits_in_hbm(
                        analysis, fsdp, tp, remat,
                        seq_shards=sp, expert_shards=ep,
                        half=half, low_bit_opt=lowbit,
                        act_offload=act_off,
                    ):
                        continue
                    for ga in grad_accums:
                        if batch % (ga * max(1, data * fsdp)):
                            continue
                        key = (
                            data, fsdp, tp, sp, ep, remat, act_off,
                            ga, half, lowbit,
                        )
                        if key in seen:
                            continue
                        seen.add(key)
                        cands.append(Candidate(
                            strategy=_build_strategy(
                                data, fsdp, tp, remat, ga,
                                sequence=sp, expert=ep,
                                half=half, low_bit_opt=lowbit,
                                act_offload=act_off, on_cuda=on_cuda,
                            ),
                            data=data, fsdp=fsdp, tensor=tp,
                            sequence=sp, expert=ep,
                            remat=remat, act_offload=act_off,
                            grad_accum=ga,
                            half=half, low_bit_opt=lowbit,
                        ))
    if not cands:
        # nothing fits the model: fall back to the most
        # memory-frugal plan and let the dry run surface the OOM
        logger.warning(
            "no candidate passed the memory model; falling back to "
            "fsdp x remat(+offload) x half x int8-opt"
        )
        # the frugalest plan available: pinned host activation
        # checkpoints when even plain remat's 0.35x activation
        # footprint was what failed the check
        fb_offload = not fits_in_hbm(
            analysis, num_devices, 1, True, half=True,
            low_bit_opt=True,
        )
        cands.append(Candidate(
            strategy=_build_strategy(
                1, num_devices, 1, True, grad_accums[0],
                half=True, low_bit_opt=True,
                act_offload=fb_offload, on_cuda=on_cuda,
            ),
            data=1, fsdp=num_devices, tensor=1, remat=True,
            act_offload=fb_offload,
            grad_accum=grad_accums[0], half=True, low_bit_opt=True,
        ))
    return cands


@dataclass
class SearchResult:
    best: Candidate
    evaluated: List[Candidate] = field(default_factory=list)


def search_strategy(
    context,
    num_devices: int,
    dry_run_budget: int = 6,
    grad_accums: Tuple[int, ...] = (1, 2),
    seed: int = 0,
    rank_mode: str = "profile",
    num_slices: int = 1,
    profile_top_k: int = 1,
    profile_steps: int = 3,
    cost_budget: int = 0,
) -> SearchResult:
    """Generate, prune, and rank; BO picks what to measure when
    candidates exceed the budget (reference: bayes_opt_sg.py).

    ``rank_mode="profile"`` times real executions (ground truth);
    ``"cost_model"`` counts the step on the ``meta`` device and ranks
    by its FLOPs/bytes roofline (deterministic, never runs a step);
    ``"hybrid"`` cost-ranks the candidates (all of them, or an even
    subsample of ``cost_budget`` when set), then profiles only the
    ``profile_top_k`` best: time on the card is bounded by k builds +
    k x ``profile_steps`` steps, not by the candidate count.
    Profiling needs ``num_devices`` to be the process group's world
    (one device a rank)."""
    from dlrover_tpu_torch.accel.dry_runner import (
        estimate_plan,
        profile_plan,
    )
    from dlrover_tpu_torch.accel.opt_lib import OptimizationLibrary

    if rank_mode not in ("profile", "cost_model", "hybrid"):
        raise ValueError(f"unknown rank_mode {rank_mode!r}")
    lib = OptimizationLibrary()
    analysis = analyse(context)  # one pass, shared with the comm term
    cands = generate_candidates(
        context, num_devices, grad_accums, num_slices=num_slices,
        analysis=analysis,
    )
    logger.info(
        "strategy search: %d candidates after memory pruning: %s",
        len(cands), [c.describe() for c in cands],
    )

    def _plan_for(cand: Candidate):
        plan = lib.apply_strategy(cand.strategy, context)
        plan.grad_accum = cand.grad_accum
        if num_slices > 1:
            plan.mesh_config.num_slices = num_slices
        return plan

    def eval_cost(cand: Candidate) -> float:
        result = estimate_plan(
            _plan_for(cand), context, num_devices=num_devices
        )
        cand.est_step_time_s = (
            result.est_step_time_s if result.ok else float("inf")
        )
        if result.ok:
            # the collective term the single-device count cannot see
            from dlrover_tpu_torch.accel.analyser import comm_cost_s

            cand.est_step_time_s += comm_cost_s(
                analysis, cand.data, cand.fsdp, cand.tensor,
                num_slices=num_slices,
                grad_accum=cand.grad_accum,
                sequence=cand.sequence,
                expert=cand.expert,
            )
        logger.info(
            "candidate %s: ok=%s est=%.4fs (cost_model)",
            cand.describe(), result.ok, cand.est_step_time_s,
        )
        return cand.est_step_time_s

    def eval_profile(cand: Candidate) -> float:
        result = profile_plan(
            _plan_for(cand), context, profile_steps=profile_steps,
        )
        cand.step_time_s = (
            result.step_time_s if result.ok else float("inf")
        )
        cand.peak_bytes, cand.error = result.device_peak_bytes, result.error
        logger.info(
            "candidate %s: ok=%s step=%.4fs (profile)",
            cand.describe(), result.ok, cand.step_time_s,
        )
        return cand.step_time_s

    def evaluate(cand: Candidate) -> float:
        if rank_mode == "cost_model":
            cand.step_time_s = eval_cost(cand)
            return cand.step_time_s
        return eval_profile(cand)

    if rank_mode == "hybrid":
        # static tier ranks the space; the chip only pays for the
        # top-k (reference pitch: the engine's analyzers prune
        # before the dry-runner executes —
        # atorch/auto/engine/acceleration_engine.py:13)
        to_cost = cands
        if cost_budget and len(cands) > cost_budget:
            # even deterministic subsample across the generated order
            # (which walks the factorization x precision x remat grid)
            stride = len(cands) / cost_budget
            to_cost = [
                cands[int(i * stride)] for i in range(cost_budget)
            ]
            logger.info(
                "hybrid search: cost-ranking %d of %d candidates",
                len(to_cost), len(cands),
            )
        for cand in to_cost:
            eval_cost(cand)
        ranked = sorted(
            (
                c for c in cands
                if c.est_step_time_s is not None
                and math.isfinite(c.est_step_time_s)
            ),
            key=lambda c: c.est_step_time_s,
        )
        # profile down the ranking until top-k have SUCCEEDED (a
        # candidate that compiles but OOMs on-chip must not end the
        # search); on-chip work stays bounded at top_k + 2 attempts
        want = max(1, profile_top_k)
        attempts = 0
        ok_profiles = 0
        for cand in ranked:
            if ok_profiles >= want or attempts >= want + 2:
                break
            attempts += 1
            if math.isfinite(eval_profile(cand)):
                ok_profiles += 1
        measured = list(cands)
    elif len(cands) <= dry_run_budget:
        for cand in cands:
            evaluate(cand)
        measured = [c for c in cands if c.step_time_s is not None]
    else:
        params = [
            Parameter("log_fsdp", 0.0, math.log2(num_devices)),
            Parameter("log_tensor", 0.0, math.log2(num_devices)),
            Parameter("log_seq", 0.0, math.log2(num_devices)),
            Parameter("log_expert", 0.0, math.log2(num_devices)),
            Parameter("remat", 0.0, 1.0),
            Parameter("act_offload", 0.0, 1.0),
            Parameter("log_accum", 0.0, math.log2(max(grad_accums))),
            Parameter("half", 0.0, 1.0),
            Parameter("low_bit", 0.0, 1.0),
        ]
        bo = BayesianOptimizer(params, seed=seed)
        rng = np.random.default_rng(seed)
        remaining = list(cands)
        measured = []
        # seed with two random picks, then BO expected improvement
        for i in range(min(dry_run_budget, len(cands))):
            if i < 2:
                pick = remaining.pop(
                    int(rng.integers(len(remaining)))
                )
            else:
                suggestion = bo.suggest(1)[0]
                pick = min(
                    remaining,
                    key=lambda c: sum(
                        (c.features()[k] - suggestion[k]) ** 2
                        for k in suggestion
                    ),
                )
                remaining.remove(pick)
            t = evaluate(pick)
            measured.append(pick)
            reward = -t if math.isfinite(t) else -1e6
            bo.observe(pick.features(), reward)

    runnable = [
        c for c in measured
        if c.step_time_s is not None and math.isfinite(c.step_time_s)
    ]
    if not runnable and rank_mode == "hybrid":
        # no profile survived; fall back to the static ranking —
        # excluding candidates whose on-chip profile already FAILED
        # (returning a known-broken plan as best would be worse than
        # an untested one)
        runnable = [
            c for c in measured
            if c.est_step_time_s is not None
            and math.isfinite(c.est_step_time_s)
            and c.step_time_s is None
        ]
        if runnable:
            best = min(runnable, key=lambda c: c.est_step_time_s)
            logger.warning(
                "strategy search: no profiled candidate ran; best by "
                "cost model only: %s", best.describe(),
            )
            return SearchResult(best=best, evaluated=measured)
    if not runnable:
        raise RuntimeError(
            "strategy search: no candidate ran successfully"
        )
    best = min(runnable, key=lambda c: c.step_time_s)
    logger.info(
        "strategy search: best %s (%.4fs/step)",
        best.describe(), best.step_time_s,
    )
    return SearchResult(best=best, evaluated=measured)
