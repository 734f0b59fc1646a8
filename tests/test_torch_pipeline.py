"""The port's pipeline parallelism against the JAX package's.

Twins of the 15 tests of ``tests/test_pipeline.py``, each run through
both packages on the same numpy inputs and weights: the JAX side on the
8 virtual CPU devices (``tests/conftest.py``), the port in its
in-process form (every stage in this process), or on gloo ranks where
the reference test uses ``data`` (one module-scoped spawn of this file,
world 4).  Loss, stage, head and input gradients agree within 1e-5 in
fp32 (rtol 1e-5, atol 1e-5 on the gradients, as the reference holds
itself to the sequential computation within 1e-4).

Then the pipelined models: ``PipelinedGPT`` and ``PipelinedLlama``
(tiny, both schedules, the uneven 10-over-4 split) against the JAX
package's, their parameters carried across by
:mod:`dlrover_tpu_torch.utils.convert` and one AdamW step taken on
each side; and in the same gloo spawn ``auto_accelerate`` at pipeline 4
and at pipeline 2 x data 2 under both schedules against the JAX
package's, the example twin under the launcher, and the pipelined state
through the flash checkpoint, restored bit for bit and crossing
between the packages.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.parallel import pipeline as port_pipe

TOL = dict(rtol=1e-5, atol=1e-5)
DIM = 8


def _stage_np(n=4, dim=DIM, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(dim, dim)) * 0.5).astype(np.float32),
             "b": (rng.normal(size=(dim,)) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _jax_stacked(stages):
    import jax.numpy as jnp

    from dlrover_tpu.parallel.pipeline import stack_stage_params

    return stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                               for s in stages])


def _port_stacked(stages, requires_grad=False):
    stacked = port_pipe.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
    return {k: v.requires_grad_(requires_grad) for k, v in stacked.items()}


def _jax_stage_fn(params, x):
    import jax.numpy as jnp

    return jnp.tanh(x @ params["w"] + params["b"])


def _port_stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _jax_mse(out, y_mb):
    import jax.numpy as jnp

    return jnp.mean((out - y_mb) ** 2)


def _port_mse(out, y_mb):
    return torch.mean((out - y_mb) ** 2)


def _jax_ce(hp, out, y_mb):
    import jax
    import jax.numpy as jnp

    logp = jax.nn.log_softmax(out @ hp["w"], axis=-1)
    return -jnp.take_along_axis(logp, y_mb[:, None], axis=-1).mean()


def _port_ce(hp, out, y_mb):
    return torch.nn.functional.cross_entropy(out @ hp["w"], y_mb.long())


def _mesh(**axes):
    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh

    return build_mesh(MeshConfig(data=-1, **axes))


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


# -- twins of tests/test_pipeline.py (in process) ---------------------------------


@pytest.mark.parametrize("micro,batch,seeds", [(4, 8, (0, 1)), (1, 4, (2, 3))],
                         ids=["matches_sequential", "single_microbatch"])
def test_pipeline_apply_matches_the_reference(micro, batch, seeds):
    """Twins of ``test_pipeline_matches_sequential`` and
    ``test_pipeline_single_microbatch``: GPipe's output over 4 stages."""
    from dlrover_tpu.parallel.pipeline import pipeline_apply

    stages, x = _stage_np(seed=seeds[0]), _normal(seeds[1], (batch, DIM))
    want = pipeline_apply(_jax_stage_fn, _jax_stacked(stages), x,
                          _mesh(pipeline=4), num_microbatches=micro)
    got = port_pipe.pipeline_apply(_port_stage_fn, _port_stacked(stages),
                                   torch.from_numpy(x),
                                   num_microbatches=micro)
    _close(got, want)


def test_pipeline_gradients_match():
    """Twin of ``test_pipeline_gradients_match``: autograd through the
    GPipe schedule, the input's gradient too."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.parallel.pipeline import pipeline_apply

    stages, x = _stage_np(seed=4), _normal(5, (8, DIM))
    mesh = _mesh(pipeline=4)

    def loss(stacked, xin):
        out = pipeline_apply(_jax_stage_fn, stacked, xin, mesh,
                             num_microbatches=2)
        return (out ** 2).sum()

    want_g, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        _jax_stacked(stages), jnp.asarray(x))
    stacked = _port_stacked(stages, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = port_pipe.pipeline_apply(_port_stage_fn, stacked, xt,
                                   num_microbatches=2)
    (out ** 2).sum().backward()
    for k in ("w", "b"):
        _close(stacked[k].grad, want_g[k])
    _close(xt.grad, want_x)


def _jax_1f1b(stages, x, y, mesh, micro, head=None, loss=None, **kw):
    from dlrover_tpu.parallel.pipeline import pipeline_train_step_1f1b

    return pipeline_train_step_1f1b(
        _jax_stage_fn, loss or (_jax_ce if head else _jax_mse),
        _jax_stacked(stages), x, y, mesh, num_microbatches=micro,
        head_params=head, **kw)


def _port_1f1b(stages, x, y, micro, head=None, **kw):
    return port_pipe.pipeline_train_step_1f1b(
        _port_stage_fn, _port_ce if head else _port_mse,
        _port_stacked(stages), torch.from_numpy(x), torch.from_numpy(y),
        num_microbatches=micro, head_params=head, **kw)


def _check_1f1b(got, want, head=False, inputs=False):
    _close(got.loss, want.loss, rtol=1e-5, atol=0)
    for k in ("w", "b"):
        _close(got.stage_grads[k], want.stage_grads[k])
    if head:
        _close(got.head_grads["w"], want.head_grads["w"])
    if inputs:
        _close(got.input_grads, want.input_grads)


@pytest.mark.parametrize("stages_n,micro,batch,seed", [
    (4, 4, 8, 7), (4, 16, 32, 50), (8, 12, 24, 60)],
    ids=["matches_sequential", "many_microbatches", "eight_stages"])
def test_1f1b_matches_the_reference(stages_n, micro, batch, seed):
    """Twins of ``test_1f1b_matches_sequential_loss_and_grads``,
    ``test_1f1b_many_microbatches_exact`` and
    ``test_1f1b_eight_stages_exact``: loss, stage and input gradients of
    the interleaved schedule."""
    stages = _stage_np(n=stages_n, seed=seed)
    x, y = _normal(seed + 1, (batch, DIM)), _normal(seed + 2, (batch, DIM))
    want = _jax_1f1b(stages, x, y, _mesh(pipeline=stages_n), micro)
    got = _port_1f1b(stages, x, y, micro)
    _check_1f1b(got, want, inputs=True)


def test_1f1b_single_stage_degenerates():
    stages = _stage_np(n=1, seed=11)
    x, y = _normal(12, (4, DIM)), _normal(13, (4, DIM))
    want = _jax_1f1b(stages, x, y, _mesh(pipeline=1), 2)
    got = _port_1f1b(stages, x, y, 2)
    _check_1f1b(got, want, inputs=True)


def test_1f1b_stash_is_bounded_by_the_stages():
    """Twin of ``test_1f1b_activation_memory_independent_of_microbatches``:
    the reference reads XLA's temp bytes; the port counts the live
    stashed stage inputs, which stay at 2S - 1 however many microbatches
    run, where GPipe keeps a graph for every microbatch."""
    stages = _stage_np(seed=20)
    x, y = _normal(21, (64, DIM)), _normal(22, (64, DIM))
    peaks = {m: _port_1f1b(stages, x, y, m).stash_peak for m in (4, 32, 64)}
    # min(M, 2S - 1): every microbatch when there are fewer
    assert peaks == {4: 4, 32: 7, 64: 7}, peaks

    kept = {}
    for m in (4, 32):
        stacked = _port_stacked(stages, requires_grad=True)
        out = port_pipe.pipeline_apply(_port_stage_fn, stacked,
                                       torch.from_numpy(x),
                                       num_microbatches=m)
        # the autograd node is the schedule's context: its graphs, one
        # a stage and microbatch, live until the backward
        kept[m] = sum(len(g) for g in out.grad_fn.run.graphs.values())
        out.sum().backward()
    assert kept == {4: 16, 32: 128}, kept


def test_1f1b_full_lm_segment_with_head_and_embed():
    """embed -> 4 stages -> head: head grads from the last stage's
    turn-around, embed grads through ``input_grads``."""
    import jax
    import jax.numpy as jnp

    vocab = 16
    stages = _stage_np(seed=40)
    table = _normal(41, (vocab, DIM), 0.5)
    head = _normal(42, (DIM, vocab), 0.5)
    rng = np.random.default_rng(42)
    tokens = rng.integers(0, vocab, (8,)).astype(np.int32)
    labels = rng.integers(0, vocab, (8,)).astype(np.int32)

    x_act, embed_vjp = jax.vjp(lambda t: t[tokens], jnp.asarray(table))
    want = _jax_1f1b(stages, x_act, jnp.asarray(labels), _mesh(pipeline=4),
                     4, head={"w": jnp.asarray(head)})
    (want_embed,) = embed_vjp(want.input_grads)

    emb = torch.from_numpy(table).requires_grad_()
    x = emb[torch.from_numpy(tokens).long()]
    got = port_pipe.pipeline_train_step_1f1b(
        _port_stage_fn, _port_ce, _port_stacked(stages), x,
        torch.from_numpy(labels), num_microbatches=4,
        head_params={"w": torch.from_numpy(head)})
    x.backward(got.input_grads)
    _check_1f1b(got, want, head=True, inputs=True)
    _close(emb.grad, want_embed)


def test_1f1b_equals_gpipe_in_process():
    """The two schedules give one loss and one gradient (the reference's
    ``test_auto_accelerate_1f1b_schedule_matches_gpipe`` at the level of
    the functions; the auto_accelerate twin runs on gloo)."""
    stages = _stage_np(seed=70)
    x, y = _normal(71, (8, DIM)), _normal(72, (8, DIM))
    stacked = _port_stacked(stages, requires_grad=True)
    xt = torch.from_numpy(x)
    out = port_pipe.pipeline_apply(_port_stage_fn, stacked, xt,
                                   num_microbatches=4)
    loss = torch.stack([_port_mse(o, t) for o, t in zip(
        out.reshape(4, 2, DIM), torch.from_numpy(y).reshape(4, 2, DIM))]
        ).mean()
    loss.backward()
    got = _port_1f1b(stages, x, y, 4)
    np.testing.assert_allclose(float(got.loss), float(loss), rtol=1e-6)
    for k in ("w", "b"):
        _close(got.stage_grads[k], stacked[k].grad, rtol=1e-6, atol=1e-7)


# -- the pipelined models (in process) --------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init(name, num_layers):
    """(JAX model, flax params) of one family in fp32, drawn once."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models import gpt as jax_gpt
    from dlrover_tpu.models import llama as jax_llama

    if name == "gpt":
        jm = jax_gpt.GPT(jax_gpt.GPTConfig.tiny(dtype=jnp.float32,
                                                num_layers=num_layers))
    else:
        # the reference's preset takes no num_layers
        jm = jax_llama.Llama(dataclasses.replace(
            jax_llama.LlamaConfig.tiny(dtype=jnp.float32),
            num_layers=num_layers))
    params = jax.tree.map(np.asarray, jax.jit(jm.init_params)(
        jax.random.PRNGKey(0)))
    return jm, params


def _families(name, num_layers):
    """(JAX model, port model, flax params) of one family in fp32 from
    the JAX init, the weights carried across."""
    from dlrover_tpu_torch.models import gpt as port_gpt
    from dlrover_tpu_torch.models import llama as port_llama
    from dlrover_tpu_torch.utils.convert import params_from_jax

    jm, params = _jax_init(name, num_layers)
    if name == "gpt":
        pm = port_gpt.GPT(port_gpt.GPTConfig.tiny(
            dtype=torch.float32, num_layers=num_layers), device="cpu")
    else:
        pm = port_llama.Llama(port_llama.LlamaConfig.tiny(
            dtype=torch.float32, num_layers=num_layers), device="cpu")
    pm.load_state_dict(params_from_jax(params))
    return jm, pm, params


def _tokens(vocab, batch, seq, seed=1):
    tok = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _jax_flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _port_flat(module, what="grad"):
    from dlrover_tpu_torch.utils.convert import flax_path

    out = {}
    for n, p in module.named_parameters():
        t = p.grad if what == "grad" else p
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        out["/".join(flax_path(n))] = t.detach().numpy()
    return out


def _jax_pipelined(family, jm, stages, micro):
    from dlrover_tpu.models import gpt as jax_gpt
    from dlrover_tpu.models import llama as jax_llama

    return (jax_gpt.PipelinedGPT(jm, stages, micro) if family == "gpt"
            else jax_llama.PipelinedLlama(jm, stages, micro))


def _jax_pipeline_step(family, jm, params, stages, micro, schedule, x, y,
                       lr=1e-3):
    """The JAX package's pipelined loss, gradients and one AdamW step
    (``optax.adamw``, the port's ``OptaxAdamW`` twin) on its own
    pipeline mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.models import gpt as jax_gpt
    from dlrover_tpu.models.gpt import partition_pipeline_params
    from dlrover_tpu.parallel.mesh import set_global_mesh

    set_global_mesh(_mesh(pipeline=stages))
    pmodel = _jax_pipelined(family, jm, stages, micro)
    pp = partition_pipeline_params(jax.tree.map(jnp.asarray, params),
                                   stages, jm.config.num_layers)
    opt = optax.adamw(lr, weight_decay=0.1)

    @jax.jit
    def step(pp, xj, yj):
        if schedule == "1f1b":
            loss, grads = pmodel.loss_and_grads_1f1b(pp, xj, yj)
        else:
            loss, grads = jax.value_and_grad(
                lambda p: jax_gpt.cross_entropy_loss(
                    pmodel.apply({"params": p}, xj), yj))(pp)
        updates, _ = opt.update(grads, opt.init(pp), pp)
        return loss, grads, optax.apply_updates(pp, updates)

    loss, grads, new = step(pp, jnp.asarray(x), jnp.asarray(y))
    return float(loss), _jax_flat(grads), _jax_flat(new)


def _port_pipeline_step(pmodel, schedule, x, y, lr=1e-3):
    from dlrover_tpu_torch.models.gpt import cross_entropy_loss
    from dlrover_tpu_torch.optim import OptaxAdamW

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    if schedule == "1f1b":
        loss = pmodel.loss_and_grads_1f1b(xt, yt)
    else:
        loss = cross_entropy_loss(pmodel(xt), yt)
        loss.backward()
    grads = _port_flat(pmodel)
    OptaxAdamW(pmodel.parameters(), lr=lr, weight_decay=0.1).step()
    return float(loss), grads, _port_flat(pmodel, "param")


def _check_tree(got, want, what, grads=None, lr=1e-3):
    """Equal within TOL; after an Adam step, an element whose reference
    gradient was below 1e-7 (summation noise, which Adam's first step
    turns into a step of up to lr either way) is held to 2 lr."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        if grads is None:
            np.testing.assert_allclose(got[k], want[k],
                                       err_msg=f"{what} {k}", **TOL)
            continue
        noise = np.abs(grads[k]) < 1e-7
        np.testing.assert_allclose(got[k][~noise], want[k][~noise],
                                   err_msg=f"{what} {k}", **TOL)
        assert np.abs(got[k][noise] - want[k][noise]).max(initial=0) \
            <= 2 * lr, (what, k)


@pytest.mark.parametrize("family,layers,stages,schedule", [
    ("gpt", 10, 4, "1f1b"), ("gpt", 10, 4, "gpipe"),
    ("llama", 4, 2, "1f1b"), ("llama", 4, 2, "gpipe")],
    ids=["gpt_uneven_1f1b", "gpt_uneven_gpipe", "llama_1f1b",
         "llama_gpipe"])
def test_pipelined_models_match_the_reference(family, layers, stages,
                                              schedule):
    """Twin of ``test_pipelined_gpt_uneven_layer_split`` (10 layers over
    4 stages, 3+3+3+1: padded slots zero, their gradients exactly zero)
    and the pipelined GPT and Llama under both schedules: loss, every
    gradient and the parameters after one AdamW step against the JAX
    package's ``PipelinedGPT`` / ``PipelinedLlama``, in fp32."""
    micro = 2
    jm, pm, params = _families(family, num_layers=layers)
    x, y = _tokens(pm.config.vocab_size, 8, 32)
    want = _jax_pipeline_step(family, jm, params, stages, micro, schedule,
                              x, y)
    from dlrover_tpu_torch.models.gpt import cross_entropy_loss

    with torch.no_grad():
        dense = float(cross_entropy_loss(pm(torch.from_numpy(x)),
                                         torch.from_numpy(y)))
    # embed and head modules are shared with the unpipelined model
    pmodel = pm.to_pipelined(stages, micro)
    got = _port_pipeline_step(pmodel, schedule, x, y)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[0], dense, rtol=1e-5)
    _check_tree(got[1], want[1], "grad")
    _check_tree(got[2], want[2], "param after AdamW", grads=want[1])
    if layers % stages:
        per = -(-layers // stages)
        pad = per * stages - layers
        for name, g in got[1].items():
            if name.startswith("blocks/"):
                assert not np.abs(g[-1, per - pad:]).any(), name
                assert not np.abs(got[2][name][-1, per - pad:]).any(), name


def test_pipelined_guards_reject_unsupported_configs():
    """Twin of ``test_pipelined_guards_reject_unsupported_configs``: the
    pipeline's guards raise the reference's ``ValueError``, reached
    through a stand-in holding the config and, since slice 7 brought
    decode and the value head, through the real models too."""
    from types import SimpleNamespace

    from dlrover_tpu_torch.models import gpt as port_gpt
    from dlrover_tpu_torch.models import llama as port_llama

    cases = [
        (port_gpt.PipelinedGPT, port_gpt.GPTConfig.tiny(decode=True),
         "decode"),
        (port_llama.PipelinedLlama,
         port_llama.LlamaConfig.tiny(decode=True), "decode"),
        (port_gpt.PipelinedGPT, port_gpt.GPTConfig.tiny(head="value"),
         "lm head"),
    ]
    for cls, cfg, match in cases:
        with pytest.raises(ValueError, match=match):
            cls(SimpleNamespace(config=cfg), 2, 2)
    for cls, cfg, match in cases:
        family = port_gpt.GPT if cls is port_gpt.PipelinedGPT \
            else port_llama.Llama
        with pytest.raises(ValueError, match=match):
            family(cfg, device="cpu").to_pipelined(2, 2)
    with pytest.raises(ValueError, match="MoE"):
        port_gpt.GPT(port_gpt.GPTConfig.tiny(moe_experts=2),
                     device="cpu").to_pipelined(2, 2)
    for impl in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="sequence-parallel"):
            port_gpt.GPT(port_gpt.GPTConfig.tiny(attention_impl=impl),
                         device="cpu").to_pipelined(2, 2)


def test_convert_carries_the_stage_stacked_layout():
    """``params_from_jax`` / ``params_to_jax`` and the q-AdamW state
    converters carry the JAX package's stage-stacked tree (10 layers
    over 4 stages, the padded slots included) both ways, bit for bit;
    the port's own partition of the same weights is that tree."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models.gpt import partition_pipeline_params
    from dlrover_tpu.optim.low_bit import q_adamw as jax_q_adamw
    from dlrover_tpu_torch.optim import q_adamw
    from dlrover_tpu_torch.utils.convert import (
        params_from_jax,
        params_to_jax,
        qadamw_state_from_jax,
        qadamw_state_to_jax,
    )

    _, pm, params = _families("gpt", num_layers=10)
    pp = jax.tree.map(np.asarray, partition_pipeline_params(
        jax.tree.map(jnp.asarray, params), 4, 10))
    pmodel = pm.to_pipelined(4, 2)
    mine = pmodel.state_dict()
    theirs = params_from_jax(pp)
    assert set(mine) == set(theirs)
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k
    _check_tree(_jax_flat(params_to_jax(mine)), _jax_flat(pp), "params")
    for k, v in _jax_flat(params_to_jax(mine)).items():
        assert v.tobytes() == _jax_flat(pp)[k].tobytes(), k

    opt = jax_q_adamw(1e-3, weight_decay=0.1)
    grads = jax.tree.map(lambda p: jnp.asarray(p) * 0.01 + 1e-3, pp)
    _, state = jax.jit(opt.update)(grads, jax.jit(opt.init)(pp), pp)
    state = jax.tree.map(np.asarray, state)
    port_opt = q_adamw(pmodel.parameters(), lr=1e-3, weight_decay=0.1)
    port_opt.load_state_dict(qadamw_state_from_jax(state, pmodel))
    back = qadamw_state_to_jax(port_opt, pmodel)
    assert int(back["count"]) == int(np.asarray(state.count))
    for which in ("mu", "nu"):
        want = {k: v for k, v in _jax_flat(
            {k: {"values": q.values, "scales": q.scales} for k, q in
             _leaves(getattr(state, which))}).items()}
        got = _jax_flat({k: {"values": q.values, "scales": q.scales}
                         for k, q in _leaves(back[which])})
        assert set(got) == set(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), (which, k)


def _leaves(tree, prefix=()):
    """``(path, QMoment)`` pairs of a moment tree."""
    for k, v in tree.items():
        if hasattr(v, "values") and hasattr(v, "scales") and not \
                isinstance(v, dict):
            yield "/".join(prefix + (k,)), v
        else:
            yield from _leaves(v, prefix + (k,))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_trainer_takes_a_pipeline_plan(schedule, tmp_path, monkeypatch):
    """``Trainer`` builds a pipeline plan through ``auto_accelerate`` (in
    process: no process group), trains it with int8 q-AdamW, saves the
    stage-stacked state and a second Trainer resumes it: the resumed
    parameters equal the saved ones bit for bit."""
    import shutil
    import tempfile
    import uuid

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
    from dlrover_tpu_torch.models.gpt import PipelinedGPT
    from dlrover_tpu_torch.optim import q_adamw
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    sockets = tempfile.mkdtemp(prefix="dlpt")
    monkeypatch.setenv("DLROVER_JOB_NAME", f"pt-{uuid.uuid4().hex[:12]}")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    data = np.random.default_rng(0).integers(0, 256, (8, 33), dtype=np.int32)
    train = [{"x": data[:, :-1], "y": data[:, 1:]}]

    def trainer(steps, resume):
        args = TrainingArguments(
            output_dir=str(tmp_path), max_steps=steps, global_batch_size=8,
            micro_batch_size=8, save_steps=2, resume_from_checkpoint=resume,
            strategy=Strategy(opts=[("pipeline_parallel", {
                "size": 2, "microbatches": 2, "schedule": schedule})]))
        return Trainer(GPT(GPTConfig.tiny(max_seq_len=32), device="cpu",
                           seed=1), args, train,
                       lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]),
                       optim_factory=lambda ps: q_adamw(ps, lr=1e-3),
                       device="cpu")

    try:
        first = trainer(4, False)
        result = first.train()
        assert isinstance(first.state.module, PipelinedGPT)
        assert result["final_loss"] < result["losses"][0]
        saved = {n: p.detach().clone()
                 for n, p in first.state.module.named_parameters()}
        second = trainer(4, True)
        second.train()  # resumes at step 4: nothing left to run
        got = dict(second.state.module.named_parameters())
        assert set(got) == set(saved)
        for n, p in saved.items():
            assert torch.equal(got[n].detach(), p), n
    finally:
        AsyncCheckpointSaver.reset()
        SharedMemoryHandler(0).unlink()
        shutil.rmtree(sockets, ignore_errors=True)
