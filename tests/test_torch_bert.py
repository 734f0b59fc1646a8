"""BERT of the PyTorch port against the JAX package's flax BERT: twins
of ``tests/test_bert.py`` and of the BERT case of
``tests/test_accelerate.py`` (``test_tp_rules_registry_resolution``).

Both models start from one flax init of ``BertConfig.tiny``, carried
into the port by ``params_from_jax``; the same numpy tokens, segment
ids, padding mask and MLM mask go to both.  Tolerances, by the norm of
the error relative to the reference's (``||got - want|| / ||want||``):
fp32 logits, MLM loss and every parameter gradient within 1e-5; bf16
within 2e-2 (the frameworks round at other places).  The tensor-
parallel forward and step (world 2 over gloo, one spawn of this file)
equal one rank's within fp32 rounding (rtol 1e-5, atol 1e-5: the
row-parallel partial sums add in another order).

Run as a script it prints the relative errors:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bert.py``.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_gloo import spawn  # noqa: E402

from dlrover_tpu.models import bert as jax_bert  # noqa: E402
from dlrover_tpu_torch.models import bert as port_bert  # noqa: E402
from dlrover_tpu_torch.utils.convert import (  # noqa: E402
    params_from_jax,
    params_to_jax,
)

BATCH, SEQ = 4, 16
REL = {"float32": 1e-5, "bfloat16": 2e-2}
ERRORS = {}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _close(name, got, want, rel):
    err = _rel(got, want)
    ERRORS[name] = max(err, ERRORS.get(name, 0.0))
    assert err <= rel, f"{name}: relative error {err:.3e} > {rel}"


def _batch(seed=0, vocab=256, padded=True):
    """Tokens, two segments (the second half of each row), 15% of
    positions masked for the MLM loss, and a padding mask on the last
    4 positions of half the rows."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32)
    segments = np.broadcast_to((np.arange(SEQ) >= SEQ // 2).astype(np.int32),
                               (BATCH, SEQ)).copy()
    mlm = rng.random((BATCH, SEQ)) < 0.15
    mlm[:, 0] = True  # at least one masked position a row
    mask = np.ones((BATCH, SEQ), np.int32)
    if padded:
        mask[: BATCH // 2, -4:] = 0
    return {"tokens": tokens, "segment_ids": segments, "mask": mask,
            "targets": rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32),
            "mlm_mask": mlm}


def _jax_params(num_labels=0, seed=0):
    model = jax_bert.Bert(jax_bert.BertConfig.tiny(
        dtype=jnp.float32, num_labels=num_labels))
    params = model.init_params(jax.random.PRNGKey(seed), seq_len=SEQ)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def flax_init():
    return {labels: _jax_params(labels) for labels in (0, 3)}


def _pair(params, dtype="float32", num_labels=0, remat=False):
    jcfg = jax_bert.BertConfig.tiny(dtype=getattr(jnp, dtype),
                                    num_labels=num_labels)
    pcfg = port_bert.BertConfig.tiny(dtype=getattr(torch, dtype),
                                     num_labels=num_labels, remat=remat)
    model = port_bert.Bert(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jax_bert.Bert(jcfg), model


def _port_inputs(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            if v.dtype != bool else torch.from_numpy(v)
            for k, v in batch.items()}


def _jax_loss(jmodel, batch, num_labels):
    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(batch["tokens"]),
                           jnp.asarray(batch["segment_ids"]),
                           jnp.asarray(batch["mask"]))
        if num_labels:
            return jnp.mean(out ** 2), out
        return jax_bert.mlm_loss(out, jnp.asarray(batch["targets"]),
                                 jnp.asarray(batch["mlm_mask"])), out

    return loss


def _port_loss(model, batch, num_labels):
    t = _port_inputs(batch)
    out = model(t["tokens"], t["segment_ids"], t["mask"])
    if num_labels:
        return (out ** 2).mean(), out
    return port_bert.mlm_loss(out, t["targets"], t["mlm_mask"]), out


def run_pair(params, dtype="float32", num_labels=0, padded=True,
             remat=False):
    """(port, JAX) loss, logits and ``{flax path: grad}``, the JAX side
    jitted."""
    jmodel, model = _pair(params, dtype, num_labels, remat)
    batch = _batch(padded=padded)
    grad_fn = jax.jit(jax.value_and_grad(
        _jax_loss(jmodel, batch, num_labels), has_aux=True))
    (jl, jout), jgrads = grad_fn(jax.tree.map(jnp.asarray, params))
    loss, out = _port_loss(model, batch, num_labels)
    loss.backward()
    grads = dict(_flat(params_to_jax(
        {n: p.grad for n, p in model.named_parameters()})))
    return ((loss.item(), float(jl)), (out.detach().numpy(), np.asarray(jout)),
            (grads, dict(_flat(jax.tree.map(np.asarray, jgrads)))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True])
def test_logits_loss_and_grads_match_jax(flax_init, dtype, padded):
    """MLM logits, ``mlm_loss`` and every parameter gradient against the
    JAX package, segment ids given, with and without a padding mask."""
    (loss, jl), (out, jout), (grads, jgrads) = run_pair(
        flax_init[0], dtype, padded=padded)
    assert out.dtype == np.float32 and out.shape == (BATCH, SEQ, 256)
    rel = REL[dtype]
    _close(f"logits_{dtype}", out, jout, rel)
    _close(f"loss_{dtype}", loss, jl, rel)
    assert sorted(grads) == sorted(jgrads)
    for name, g in jgrads.items():
        _close(f"grad_{dtype}", grads[name], g, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classifier_head_matches_jax(flax_init, dtype):
    """``num_labels > 0``: the [CLS] pooler (tanh in the compute dtype)
    and the fp32 classifier, outputs and gradients."""
    (loss, jl), (out, jout), (grads, jgrads) = run_pair(
        flax_init[3], dtype, num_labels=3)
    assert out.shape == (BATCH, 3) and out.dtype == np.float32
    _close(f"classifier_{dtype}", out, jout, REL[dtype])
    assert "pooler/kernel" in grads and "classifier/bias" in grads
    for name, g in jgrads.items():
        _close(f"classifier_grad_{dtype}", grads[name], g, REL[dtype])


def test_remat_gives_the_jax_gradients(flax_init):
    """``remat=True`` recomputes each block in the backward: the same
    gradients as the JAX package's (and as no remat)."""
    _, _, (grads, jgrads) = run_pair(flax_init[0], remat=True)
    for name, g in jgrads.items():
        _close("remat_grad", grads[name], g, REL["float32"])


def test_forward_shapes_and_finite_loss():
    """Twin of ``test_bert_forward_shapes``: MLM logits over the vocab,
    a finite MLM loss, the classifier's ``[batch, labels]``."""
    cfg = port_bert.BertConfig.tiny()
    batch = _port_inputs(_batch())
    logits = port_bert.Bert(cfg, device="cpu")(batch["tokens"])
    assert logits.shape == (BATCH, SEQ, cfg.vocab_size)
    assert logits.dtype == torch.float32
    loss = port_bert.mlm_loss(logits, batch["targets"], batch["mlm_mask"])
    assert torch.isfinite(loss)
    clf = port_bert.Bert(port_bert.BertConfig.tiny(num_labels=3),
                         device="cpu")
    assert clf(batch["tokens"]).shape == (BATCH, 3)


def test_attention_mask_blocks_padding(flax_init):
    """Twin of ``test_bert_attention_mask_blocks_padding``: changing the
    padding tokens does not change the valid positions' logits; both
    packages agree on the masked logits."""
    jmodel, model = _pair(flax_init[0])
    tokens = _batch()["tokens"]
    mask = np.ones((BATCH, SEQ), np.int32)
    mask[:, SEQ // 2:] = 0
    other = tokens.copy()
    other[:, SEQ // 2:] = 1
    with torch.no_grad():
        a, b = (model(torch.from_numpy(t).long(), mask=torch.from_numpy(mask))
                for t in (tokens, other))
    torch.testing.assert_close(a[:, :SEQ // 2], b[:, :SEQ // 2], rtol=0,
                               atol=1e-6)
    want = jmodel.apply({"params": jax.tree.map(jnp.asarray, flax_init[0])},
                        jnp.asarray(tokens), mask=jnp.asarray(mask))
    _close("masked_logits", a.numpy(), np.asarray(want), REL["float32"])


@pytest.mark.parametrize("all_masked", [False, True])
def test_mlm_loss_matches_jax(all_masked):
    """The masked mean over the MLM positions; no position masked gives
    0 (the denominator clamped at 1) in both packages."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (3, 7))
    mask = (np.zeros((3, 7), bool) if all_masked
            else rng.random((3, 7)) < 0.3)
    got = port_bert.mlm_loss(torch.from_numpy(logits),
                             torch.from_numpy(targets),
                             torch.from_numpy(mask))
    want = jax_bert.mlm_loss(jnp.asarray(logits), jnp.asarray(targets),
                             jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


def test_params_round_trip_is_bit_exact(flax_init):
    """``params_from_jax`` names every BERT leaf (``wse`` as an
    embedding, ``pooler``/``classifier`` as Dense layers): a strict load
    and an exact round trip."""
    for params in flax_init.values():
        sd = params_from_jax(params)
        model = port_bert.Bert(port_bert.BertConfig.tiny(
            num_labels=3 if "classifier" in params else 0), device="cpu")
        assert sorted(sd) == sorted(model.state_dict())
        model.load_state_dict(sd, strict=True)
        back = dict(_flat(params_to_jax(model.state_dict())))
        for name, want in _flat(params):
            np.testing.assert_array_equal(back[name], want)


def test_config_and_init_follow_the_reference():
    cfg, ref = port_bert.BertConfig.base(), jax_bert.BertConfig.base()
    for field in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
                  "hidden_dim", "mlp_ratio", "num_segments", "remat",
                  "num_labels", "head_dim"):
        assert getattr(cfg, field) == getattr(ref, field), field
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    model = port_bert.Bert(port_bert.BertConfig.tiny(), device="cpu", seed=1)
    assert model.blocks[0].ln_attn.eps == 1e-6
    for table in (model.wte, model.wpe, model.wse):
        std = float(table.weight.std())
        assert abs(std - 64 ** -0.5) < 0.3 * 64 ** -0.5
    again = port_bert.Bert(port_bert.BertConfig.tiny(), device="cpu", seed=1)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


def _loss_fn(module, batch):
    logits = module(batch["tokens"], batch["segment_ids"], batch["mask"])
    return port_bert.mlm_loss(logits, batch["targets"], batch["mlm_mask"])


def _sgd(params):
    return torch.optim.SGD(params, lr=1e-2)


def test_trains_through_auto_accelerate_as_the_jax_package(flax_init):
    """The reference's BERT step through the port's ``auto_accelerate``
    (``checkpoint`` and fp32 ``amp_native``; the plan rebuilds the model
    with remat and touches no field BERT's config lacks): three SGD
    steps' losses and the updated parameters against the JAX package's
    SGD on the same params."""
    from dlrover_tpu_torch.accel import Strategy, auto_accelerate

    _, model = _pair(flax_init[0])
    batch = _batch()
    result = auto_accelerate(
        model, _sgd, _loss_fn, _port_inputs(batch), device="cpu",
        strategy=Strategy(opts=[("amp_native", {"dtype": "float32"}),
                                ("checkpoint", {})]))
    assert result.model.config.remat is True
    state, losses = result.state, []
    for _ in range(3):
        state, metrics = result.train_step(
            state, result.place_batch(_port_inputs(batch)))
        losses.append(float(metrics["loss"]))
    jmodel = jax_bert.Bert(jax_bert.BertConfig.tiny(dtype=jnp.float32,
                                                    remat=True))
    loss_fn = _jax_loss(jmodel, batch, 0)
    opt = optax.sgd(1e-2)
    params = jax.tree.map(jnp.asarray, flax_init[0])
    opt_state = opt.init(params)
    step = jax.jit(jax.value_and_grad(lambda p: loss_fn(p)[0]))
    jlosses = []
    for _ in range(3):
        loss, grads = step(params)
        jlosses.append(float(loss))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = dict(_flat(params_to_jax(dict(result.model.named_parameters()))))
    for name, want in _flat(jax.tree.map(np.asarray, params)):
        _close("sgd_params", got[name], want, REL["float32"])


def test_tp_rules_registry_resolution():
    """Twin of ``tests/test_accelerate.py::test_tp_rules_registry_
    resolution``: BERT resolves to the shared transformer contract
    (``gpt_tp_rules``); a registered family overrides it, and the opt
    library picks the registration up through the context."""
    from dlrover_tpu_torch.accel import (
        ModelContext,
        OptimizationLibrary,
        Strategy,
    )
    from dlrover_tpu_torch.parallel.registry import (
        register_tp_rules,
        rules_for_model,
        unregister_tp_rules,
    )
    from dlrover_tpu_torch.parallel.sharding import (
        PartitionRules,
        gpt_tp_rules,
    )

    bert = port_bert.Bert(port_bert.BertConfig.tiny(), device="cpu")
    assert rules_for_model(bert).rules == gpt_tp_rules().rules
    custom = PartitionRules(rules=[(r"special", ("tensor",))])
    register_tp_rules("Bert", custom)
    try:
        assert rules_for_model(bert) is custom
        ctx = ModelContext(model=bert, optim_factory=_sgd,
                           loss_fn=lambda m, b: 0.0, sample_batch={},
                           device="cpu")
        plan = OptimizationLibrary().apply_strategy(
            Strategy(opts=[("tensor_parallel", {"size": 2})]), ctx)
        assert plan.param_rules is custom
    finally:
        unregister_tp_rules("Bert")


# -- tensor parallelism: a gloo world of 2 -----------------------------------


TP_STRATEGY = [("mixed_parallel", {"tensor": 2, "data": 1}),
               ("amp_native", {"dtype": "float32"})]


def _whole(t):
    from dlrover_tpu_torch.common.device import is_dtensor

    return (t.full_tensor() if is_dtensor(t) else t).detach().numpy()


def _worker(rank, world, port, in_path, out_path):
    """The BERT step under tensor 2: its logits, one SGD step's loss and
    the updated parameters, gathered."""
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    model = port_bert.Bert(port_bert.BertConfig.tiny(dtype=torch.float32),
                           device="cpu")
    model.load_state_dict(params_from_jax(job["params"]))
    batch = _port_inputs(job["batch"])
    result = auto_accelerate(model, _sgd, _loss_fn, batch, device="cpu",
                             strategy=Strategy(opts=TP_STRATEGY))
    out = {"placements": {n: str(p.placements) for n, p in
                          result.model.named_parameters()
                          if hasattr(p, "placements")}}
    with torch.no_grad():
        out["logits"] = _whole(result.model(
            batch["tokens"], batch["segment_ids"], batch["mask"]))
    _, metrics = result.train_step(result.state, result.place_batch(batch))
    out["loss"] = float(metrics["loss"])
    out["params"] = {n: _whole(p) for n, p in result.model.named_parameters()}
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tensor_world2(flax_init):
    job = {"params": flax_init[0], "batch": _batch()}
    return job, spawn(job, os.path.abspath(__file__), world=2)


def test_tensor_parallel_matches_one_rank(tensor_world2):
    """Twin of ``test_bert_tp_matches_single_device`` at world 2: qkv
    and fc_in column-split, o_proj and fc_out row-split, ``wte`` split
    by vocab (its logits a DTensor that ``mlm_loss`` reduces without a
    gather); the logits, the step's loss and the SGD-updated parameters
    equal one rank's."""
    job, got = tensor_world2
    placements = got["placements"]
    assert "Shard(dim=1)" in placements["blocks.0.qkv.weight"]
    assert "Shard(dim=0)" in placements["blocks.0.o_proj.weight"]
    assert "Shard(dim=0)" in placements["wte.weight"]
    model = port_bert.Bert(port_bert.BertConfig.tiny(dtype=torch.float32),
                           device="cpu")
    model.load_state_dict(params_from_jax(job["params"]))
    batch = _port_inputs(job["batch"])
    with torch.no_grad():
        logits = model(batch["tokens"], batch["segment_ids"], batch["mask"])
    np.testing.assert_allclose(got["logits"], logits.numpy(), rtol=1e-5,
                               atol=1e-5)
    opt = _sgd(model.parameters())
    loss = _loss_fn(model, batch)
    loss.backward()
    opt.step()
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(got["params"][name], p.detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, *sys.argv[5:7])
    else:
        sys.exit(pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
                 or print(ERRORS))
