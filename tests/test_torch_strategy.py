"""The port's strategy engine against the JAX package's.

For device counts 1, 2, 4 and 8 and the same model and batch,
``generate_candidates`` gives the JAX package's list, ``describe()`` for
``describe()`` (with and without the int8-optimizer opt-in, under a
tight memory, with long-sequence variants); the analyses agree; a
strategy JSON saved by either package loads into equal ``AccelPlan``s
in the other.  Then the twins of ``tests/test_accelerate.py``'s cases
that are not JAX-only, on one CPU process (a world of one with no
process group shards nothing): the optimization library, semi-auto and
searched ``auto_accelerate``, the count tier (``estimate_plan``), the
three rank modes and the BO budget; that only running out of memory
fails a candidate while any other fault aborts the search; and the
port's ``Trainer`` with a strategy against the JAX ``Trainer``.
"""

import dataclasses
import json
import shutil
import tempfile
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.accel import Strategy as JaxStrategy
from dlrover_tpu.accel import analyser as jax_analyser
from dlrover_tpu.accel import strategy_search as jax_search
from dlrover_tpu.accel.model_context import ModelContext as JaxContext
from dlrover_tpu.accel.opt_lib import OptimizationLibrary as JaxLibrary
from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu_torch.accel import (
    ModelContext,
    OptimizationLibrary,
    Strategy,
    auto_accelerate,
)
from dlrover_tpu_torch.accel import analyser, dry_runner, strategy_search
from dlrover_tpu_torch.accel.accelerate import build_from_plan
from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.utils.convert import params_from_jax


def _batch(rows=8, seq=16, vocab=256, seed=0):
    data = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1),
                                                dtype=np.int32)
    return {"x": data[:, :-1], "y": data[:, 1:]}


def _port_loss(module, batch):
    return port_gpt.cross_entropy_loss(module(batch["x"]), batch["y"])


def _contexts(batch=None, search_optimizer=False, **cfg):
    batch = batch or _batch()
    extra = {"search_optimizer": search_optimizer}
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig.tiny(**cfg))

    def jloss(p, b, model=jmodel):
        return jax_gpt.cross_entropy_loss(model.apply({"params": p}, b["x"]),
                                          b["y"])

    jctx = JaxContext(model=jmodel, optim_factory=lambda: optax.adamw(1e-3),
                      loss_fn=jloss, sample_batch=jax.tree.map(jnp.asarray,
                                                               batch),
                      extra=extra)
    pmodel = port_gpt.GPT(port_gpt.GPTConfig.tiny(**cfg), device="cpu")
    pctx = ModelContext(model=pmodel, optim_factory=_adamw,
                        loss_fn=_port_loss, sample_batch=batch, extra=extra,
                        device=torch.device("cpu"))
    return jctx, pctx


def _adamw(params, lr=1e-3):
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _describe(cands):
    return [c.describe() for c in cands]


@pytest.mark.parametrize("search_optimizer", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_generate_candidates_match_jax(n, search_optimizer):
    jctx, pctx = _contexts(search_optimizer=search_optimizer)
    want = jax_search.generate_candidates(jctx, n)
    got = strategy_search.generate_candidates(pctx, n)
    assert _describe(got) == _describe(want)
    # same strategies too: on the CPU neither adds module_replace
    assert [c.strategy.opts for c in got] == [
        [(k, dict(v)) for k, v in c.strategy.opts] for c in want]


@pytest.mark.parametrize("n", [2, 8])
def test_candidates_under_tight_memory_match_jax(n, monkeypatch):
    """The memory model prunes alike: a device holding half the
    replicated state leaves only sharded or low-precision candidates."""
    jctx, pctx = _contexts(search_optimizer=True)

    def tight(real):
        def analyse(ctx):
            a = real(ctx)
            a.per_device_hbm = int(a.model_state_bytes() / 2)
            a.batch_bytes = 0
            return a
        return analyse

    got = strategy_search.generate_candidates(
        pctx, n, analysis=tight(analyser.analyse)(pctx))
    want = jax_search.generate_candidates(
        jctx, n, analysis=tight(jax_analyser.analyse)(jctx))
    assert _describe(got) == _describe(want)
    assert all(c.fsdp * c.tensor >= 2 or c.half for c in got)


def test_long_sequence_candidates_match_jax():
    batch = _batch(seq=32)
    jctx, pctx = _contexts(batch=batch, max_seq_len=64)
    want = jax_search.generate_candidates(jctx, 8, grad_accums=(1,),
                                          long_seq_threshold=16)
    got = strategy_search.generate_candidates(pctx, 8, grad_accums=(1,),
                                              long_seq_threshold=16)
    assert _describe(got) == _describe(want)
    assert any(c.sequence > 1 for c in got)


def test_analysis_matches_jax():
    jctx, pctx = _contexts()
    a, b = analyser.analyse(pctx), jax_analyser.analyse(jctx)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for args in [(1, 1, False), (2, 2, True), (1, 1, True)]:
        for kw in ({}, {"half": True}, {"low_bit_opt": True},
                   {"act_offload": True}):
            assert analyser.fits_in_hbm(a, *args, **kw) == \
                jax_analyser.fits_in_hbm(b, *args, **kw)
    for args in [(2, 1, 1), (1, 4, 2), (4, 2, 1, 2, 2)]:
        assert analyser.comm_cost_s(a, *args) > 0
    assert strategy_search.mesh_factorizations(8) == \
        jax_search.mesh_factorizations(8)


def _plan_fields(plan):
    d = dataclasses.asdict(plan)
    d["mesh_config"] = dataclasses.asdict(plan.mesh_config)
    for key in ("param_rules", "opt_state_rules"):
        rules = getattr(plan, key)
        d[key] = None if rules is None else (
            [(r, tuple(s)) for r, s in rules.rules], tuple(rules.default))
    return d


STRATEGIES = [
    [("fsdp", {"size": 4}), ("checkpoint", {}),
     ("module_replace", {"attention": "flash"}), ("amp_native", {})],
    [("zero1", {"size": 4})],
    [("zero2", {}), ("half", {})],
    [("mixed_parallel", {"tensor": 2, "fsdp": 2, "data": -1}),
     ("low_bit_opt", {"bits": 8}), ("offload_activation", {})],
    [("tensor_parallel", {"size": 2}), ("offload_opt", {})],
    [("parallel_mode", {}), ("amp_native", {"dtype": "float32"})],
]


@pytest.mark.parametrize("opts", STRATEGIES)
def test_strategy_json_crosses_packages_into_equal_plans(opts, tmp_path):
    jctx, pctx = _contexts()
    for saver, loader in ((JaxStrategy, Strategy), (Strategy, JaxStrategy)):
        path = str(tmp_path / f"{saver.__module__}.json")
        saver(opts=opts).save(path)
        loaded = loader.load(path)
        assert json.loads(loaded.to_json()) == json.loads(
            saver(opts=opts).to_json())
        got = OptimizationLibrary().apply_strategy(
            Strategy.load(path), pctx)
        want = JaxLibrary().apply_strategy(JaxStrategy.load(path), jctx)
        assert _plan_fields(got) == _plan_fields(want)


# -- twins of tests/test_accelerate.py ----------------------------------------


def test_opt_library_builds_plans():
    lib = OptimizationLibrary()
    assert "fsdp" in lib and "tensor_parallel" in lib
    plan = lib.apply_strategy(Strategy(opts=STRATEGIES[0]))
    assert plan.mesh_config.fsdp == 4 and plan.remat is True
    assert plan.attention_impl == "flash"
    assert plan.compute_dtype == "bfloat16"


def test_zero1_shards_only_opt_state():
    plan = OptimizationLibrary().apply_strategy(
        Strategy(opts=[("zero1", {"size": 4})]))
    assert plan.param_rules.rules == []
    assert plan.opt_state_rules is not None
    assert plan.effective_opt_rules().rules


def test_strategy_json_roundtrip(tmp_path):
    s = Strategy(opts=[("fsdp", {"size": 8}), ("checkpoint", {})])
    path = str(tmp_path / "strategy.json")
    s.save(path)
    s2 = Strategy.load(path)
    assert s2.names() == ["fsdp", "checkpoint"]
    assert s2.opts[0][1] == {"size": 8}


def test_analyser_reports_model_size():
    _, pctx = _contexts()
    a = analyser.analyse(pctx)
    assert a.num_params > 10_000
    assert a.opt_state_bytes == 2 * a.num_params * 4
    assert a.batch_size == 8 and a.seq_len == 16
    assert analyser.fits_in_hbm(a, 1, 1, False)
    a.per_device_hbm = 1024
    assert not analyser.fits_in_hbm(a, 1, 1, False)


@pytest.mark.parametrize("name", ["sequence_parallel", "expert_parallel",
                                  "pipeline_parallel", "fp8"])
def test_optimizations_of_slice_5_raise(name):
    """Those of slice 5.2 apply since it landed (the reference's default
    size 2), and so do the pipeline (size 2, 4 microbatches, GPipe) and
    fp8 since slice 5.3: none raises."""
    plan = OptimizationLibrary().apply_strategy(Strategy(opts=[(name, {})]))
    if name == "fp8":
        assert plan.fp8 is True
        return
    axis = name.split("_")[0]
    assert getattr(plan.mesh_config, axis) == 2
    if name == "pipeline_parallel":
        assert (plan.pipeline_microbatches, plan.pipeline_schedule) == \
            (4, "gpipe")


def test_auto_accelerate_semiauto_fsdp_on_one_device():
    """One process, no process group: the fsdp axis absorbs the one
    device and nothing is sharded (the reference's one-device mesh)."""
    _, pctx = _contexts()
    result = auto_accelerate(
        pctx.model, _adamw, _port_loss, pctx.sample_batch,
        strategy=Strategy(opts=[("fsdp", {}), ("amp_native", {})]),
        device="cpu")
    assert result.mesh.shape["fsdp"] == 1 and not result.mesh.distributed
    state, metrics = result.train_step(
        result.state, result.place_batch(pctx.sample_batch))
    assert np.isfinite(float(metrics["loss"]))
    assert result.model.config.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="not divisible"):
        auto_accelerate(pctx.model, _adamw, _port_loss, pctx.sample_batch,
                        strategy=Strategy(opts=[("fsdp", {"size": 4})]),
                        device="cpu")


def test_auto_accelerate_search_picks_runnable():
    _, pctx = _contexts()
    result = auto_accelerate(pctx.model, _adamw, _port_loss,
                             pctx.sample_batch, dry_run_candidates=False,
                             device="cpu")
    _, metrics = result.train_step(result.state,
                                   result.place_batch(pctx.sample_batch))
    assert np.isfinite(float(metrics["loss"]))
    assert result.strategy.names() == ["parallel_mode", "amp_native"]


def test_auto_accelerate_grad_accum():
    _, pctx = _contexts(dtype=torch.float32)
    results = []
    for accum in (1, 2):
        model = port_gpt.GPT(pctx.model.config, device="cpu", seed=4)
        result = auto_accelerate(
            model, lambda ps: torch.optim.SGD(ps, lr=1e-2), _port_loss,
            pctx.sample_batch, strategy=Strategy(opts=[
                ("parallel_mode", {}), ("amp_native", {"dtype": "float32"})]),
            grad_accum=accum, device="cpu")
        assert result.plan.grad_accum == accum
        _, m = result.train_step(result.state,
                                 result.place_batch(pctx.sample_batch))
        results.append(m["loss"])
    torch.testing.assert_close(results[1], results[0])


def test_plan_rebuilds_model_config_keeping_the_weights():
    _, pctx = _contexts()
    result = auto_accelerate(pctx.model, _adamw, _port_loss,
                             pctx.sample_batch,
                             strategy=Strategy(opts=[("checkpoint", {})]),
                             device="cpu")
    assert result.model.config.remat is True
    assert result.model is not pctx.model
    for (n, a), (_, b) in zip(result.model.named_parameters(),
                              pctx.model.named_parameters()):
        assert torch.equal(a, b), n
    # half: bf16 storage, the layernorms kept fp32 as the model builds them
    half = auto_accelerate(pctx.model, _adamw, _port_loss, pctx.sample_batch,
                           strategy=Strategy(opts=[("half", {})]),
                           device="cpu")
    assert half.model.wte.weight.dtype == torch.bfloat16
    assert half.model.ln_f.weight.dtype == torch.float32


def test_offload_levers_degrade_on_cpu_with_the_references_notes():
    _, pctx = _contexts()
    result = auto_accelerate(
        pctx.model, _adamw, _port_loss, pctx.sample_batch,
        strategy=Strategy(opts=[("offload_opt", {}),
                                ("offload_activation", {})]),
        device="cpu")
    assert "offload_opt degraded to no-op on cpu" in result.plan.notes
    assert ("offload_activation degraded to plain remat on cpu"
            in result.plan.notes)
    assert result.plan.remat_policy == "offload"
    assert result.model.config.remat_policy == "full"
    _, metrics = result.train_step(result.state,
                                   result.place_batch(pctx.sample_batch))
    assert np.isfinite(float(metrics["loss"]))


def test_low_bit_opt_swaps_in_q_adamw():
    from dlrover_tpu_torch.optim import QAdamW

    _, pctx = _contexts()
    result = auto_accelerate(
        pctx.model, _adamw, _port_loss, pctx.sample_batch,
        strategy=Strategy(opts=[("parallel_mode", {}),
                                ("low_bit_opt", {"bits": 8})]),
        device="cpu")
    opt = result.state.optimizer
    assert isinstance(opt, QAdamW)
    assert (opt.param_groups[0]["lr"], opt.param_groups[0]["weight_decay"]) \
        == (3e-4, 0.1)


def test_estimate_plan_counts_flops_bytes_and_remat():
    """The count tier: finite FLOPs and bytes, never a step; remat
    recomputes the forward in the backward; flash attention is counted
    by formula (4 b h s^2 d forward, halved causal, 2.5x backward)."""
    _, pctx = _contexts(max_seq_len=32)
    lib = OptimizationLibrary()
    plan = lib.apply_strategy(Strategy(opts=[("fsdp", {}),
                                             ("amp_native", {})]), pctx)
    r1 = dry_runner.estimate_plan(plan, pctx, num_devices=4)
    assert r1.ok and r1.flops > 0 and r1.bytes_accessed > 0
    assert r1.est_step_time_s > 0 and r1.step_time_s == 0.0
    plan2 = lib.apply_strategy(Strategy(opts=[
        ("fsdp", {}), ("amp_native", {}), ("checkpoint", {})]), pctx)
    r2 = dry_runner.estimate_plan(plan2, pctx, num_devices=4)
    assert r2.flops > 1.1 * r1.flops
    flash = lib.apply_strategy(Strategy(opts=[
        ("parallel_mode", {}), ("module_replace", {"attention": "flash"})]),
        pctx)
    plain = lib.apply_strategy(Strategy(opts=[("parallel_mode", {})]), pctx)
    c_flash = dry_runner.count_step(flash, pctx)["flops"]
    c_plain = dry_runner.count_step(plain, pctx)["flops"]
    cfg = pctx.model.config
    b, s = pctx.sample_batch["x"].shape
    fwd = 4 * b * cfg.num_heads * s * s * cfg.head_dim * 0.5
    # the plain attention's two einsums count the full square, forward
    # (2) and backward (4 products)
    plain_attn = 3 * 4 * b * cfg.num_heads * s * s * cfg.head_dim
    assert c_flash - c_plain == pytest.approx(
        cfg.num_layers * (3.5 * fwd - plain_attn))


def test_count_tier_knows_the_h100_and_refuses_other_cards(monkeypatch):
    """The roofline peaks come from the card's name; a card without an
    entry raises naming itself rather than borrowing the H100's."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert dry_runner._chip_spec(torch.device("cuda")) == \
        dry_runner._CHIP_SPECS["NVIDIA H100"]
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100-SXM4-80GB"):
        dry_runner._chip_spec(torch.device("cuda"))


def test_search_bo_respects_budget():
    _, pctx = _contexts(search_optimizer=True)
    result = strategy_search.search_strategy(pctx, 1, dry_run_budget=4,
                                             grad_accums=(1, 2))
    assert len(result.evaluated) <= 4
    assert result.best.step_time_s is not None


def test_search_strategy_cost_model_mode():
    _, pctx = _contexts(max_seq_len=32)
    result = strategy_search.search_strategy(pctx, 4, dry_run_budget=3,
                                             rank_mode="cost_model")
    assert np.isfinite(result.best.step_time_s)


def test_search_strategy_hybrid_profiles_top_k_only():
    _, pctx = _contexts(search_optimizer=True)
    result = strategy_search.search_strategy(
        pctx, 1, rank_mode="hybrid", profile_top_k=1, profile_steps=1,
        grad_accums=(1,), cost_budget=4)
    profiled = [c for c in result.evaluated if c.step_time_s is not None]
    ranked = [c for c in result.evaluated if c.est_step_time_s is not None]
    assert len(ranked) == 4 and len(profiled) == 1
    assert result.best in profiled and result.best.peak_bytes == 0


def _failing_loss(exc, when):
    def loss(module, batch):
        if when(module):
            raise exc
        return _port_loss(module, batch)
    return loss


def test_a_fault_that_is_not_oom_aborts_the_search():
    """A kernel's build or launch error must not hand the choice to
    another plan: the search raises it."""
    _, pctx = _contexts()
    pctx.loss_fn = _failing_loss(
        RuntimeError("CUDA kernel build failed"),
        lambda m: m.config.remat)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        strategy_search.search_strategy(pctx, 1, grad_accums=(1,))


def test_only_out_of_memory_fails_a_candidate():
    _, pctx = _contexts()
    pctx.loss_fn = _failing_loss(MemoryError("out of host memory"),
                                 lambda m: m.config.remat)
    result = strategy_search.search_strategy(pctx, 1, grad_accums=(1,))
    failed = [c for c in result.evaluated if not np.isfinite(c.step_time_s)]
    assert [c.describe() for c in failed] == [
        "data1xfsdp1xtp1+remat", "data1xfsdp1xtp1+remat+half"]
    assert all(c.error.startswith("out of memory") for c in failed)
    # the fastest of the two that ran (a timing: either may win)
    assert not result.best.remat and np.isfinite(result.best.step_time_s)


def test_entry_points_run_on_the_card_unless_told_otherwise(monkeypatch):
    _, pctx = _contexts()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        auto_accelerate(pctx.model, _adamw, _port_loss, pctx.sample_batch,
                        strategy=Strategy(opts=[("parallel_mode", {})]))
    plan = OptimizationLibrary().apply_strategy(
        Strategy(opts=[("parallel_mode", {})]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_from_plan(plan, dataclasses.replace(pctx, device=None))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dry_runner.profile_plan(plan, dataclasses.replace(pctx, device=None))


# -- Trainer with a strategy ---------------------------------------------------


@pytest.fixture()
def job(monkeypatch):
    from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

    sockets = tempfile.mkdtemp(prefix="dls")
    monkeypatch.setenv("DLROVER_JOB_NAME", f"test-{uuid.uuid4().hex[:12]}")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    yield
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    SharedMemoryHandler(0).unlink()
    shutil.rmtree(sockets, ignore_errors=True)


def _recording(trainer):
    losses = []
    check = trainer._check_loss_spike

    def record(step, loss):
        losses.append(float(loss))
        check(step, loss)

    trainer._check_loss_spike = record
    return losses


@pytest.mark.parametrize("opts", [
    [("parallel_mode", {}), ("amp_native", {"dtype": "float32"})],
    [("fsdp", {}), ("amp_native", {"dtype": "float32"}), ("checkpoint", {})],
])
def test_trainer_with_a_strategy_gives_the_jax_trainers_losses(
        job, tmp_path, opts):
    """Both Trainers build through their ``auto_accelerate`` from the
    JAX package's init (``PRNGKey(0)``), with ``dry_run_candidates``:
    four AdamW steps on one batch, losses within 1e-4."""
    from dlrover_tpu.trainer.trainer import Trainer as JaxTrainer
    from dlrover_tpu.trainer.trainer import (
        TrainingArguments as JaxArguments,
    )
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    batch = _batch()
    common = dict(max_steps=4, global_batch_size=8, micro_batch_size=8,
                  logging_steps=100, save_steps=100,
                  dry_run_candidates=True)
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig.tiny(dtype=jnp.float32))

    def jloss(p, b, model=jmodel):
        return jax_gpt.cross_entropy_loss(model.apply({"params": p}, b["x"]),
                                          b["y"])

    jt = JaxTrainer(jmodel, JaxArguments(
        output_dir=str(tmp_path / "jax"), strategy=JaxStrategy(opts=opts),
        **common), [batch], jloss)
    want = _recording(jt)
    jt.train()
    # the JAX package's train() leaves its snapshot writer thread running
    # (its engine is not closed); stop it here, so no thread of this test
    # outlives it into another test of this process
    jt._checkpointer.close()
    params = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0)))
    model = port_gpt.GPT(port_gpt.GPTConfig.tiny(dtype=torch.float32),
                         device="cpu")
    model.load_state_dict(params_from_jax(params))
    pt = Trainer(model, TrainingArguments(
        output_dir=str(tmp_path / "port"), strategy=Strategy(opts=opts),
        resume_from_checkpoint=False, **common), [batch], _port_loss,
        device="cpu")
    got = _recording(pt)
    result = pt.train()
    assert result["losses"] == got
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert pt.model.config.remat == ("checkpoint" in dict(opts))


def test_trainer_searches_a_plan_when_asked(job, tmp_path):
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    model = port_gpt.GPT(port_gpt.GPTConfig.tiny(), device="cpu")
    trainer = Trainer(model, TrainingArguments(
        output_dir=str(tmp_path), max_steps=3, global_batch_size=8,
        micro_batch_size=8, logging_steps=100, dry_run_candidates=True,
        resume_from_checkpoint=False), [_batch()], _port_loss,
        device="cpu")
    result = trainer.train()
    assert trainer._accel.search is not None
    assert trainer._accel.strategy is trainer._accel.search.best.strategy
    assert all(np.isfinite(result["losses"]))


def test_trainer_refuses_to_save_dtensor_params_naming_slice_4_2(
        job, tmp_path):
    """On a one-rank gloo group the fsdp plan makes the params DTensors
    (FSDP2).  Before the sharded checkpoint the first save raised naming
    its slice; now the plan trains, saves the local shards, and a second
    Trainer resumes onto its own DTensors at the saved step with the
    saved params, bit for bit."""
    import torch.distributed as dist

    from dlrover_tpu_torch.common.device import is_dtensor
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)

    def trainer(max_steps, resume):
        model = port_gpt.GPT(port_gpt.GPTConfig.tiny(dtype=torch.float32),
                             device="cpu")
        return Trainer(model, TrainingArguments(
            output_dir=str(tmp_path / "out"), max_steps=max_steps,
            global_batch_size=8, micro_batch_size=8, logging_steps=100,
            save_steps=2, resume_from_checkpoint=resume,
            strategy=Strategy(opts=[("fsdp", {}), ("amp_native",
                                                   {"dtype": "float32"})])),
            [_batch()], _port_loss, device="cpu")

    try:
        first = trainer(2, False)
        losses = _recording(first)
        first.train()
        assert all(is_dtensor(p) for p in first.model.parameters())
        assert len(losses) == 2 and all(np.isfinite(losses))
        saved = {n: p.full_tensor().clone()
                 for n, p in first.model.named_parameters()}
        second = trainer(2, True)
        result = second.train()
        assert result["steps"] == 2 and result["losses"] == []
        assert second.last_restore_phases["tier"] == "shm"
        for n, p in second.model.named_parameters():
            assert is_dtensor(p)
            assert torch.equal(p.full_tensor(), saved[n]), n
    finally:
        dist.destroy_process_group()
