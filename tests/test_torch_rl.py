"""Twins of ``tests/test_rl.py`` for the port (slice 7, with 5.4's
decode): the PPO math, the KV-cache decode of GPT and Llama, greedy
generation, the four-role engine's experience and PPO step, and the
hybrid rollout engine.

Every comparison with the JAX package runs in this process on inputs
and weights made from numpy seeds and carried over by
``dlrover_tpu_torch.utils.convert``:

- GAE, the clipped policy loss, the critic loss, KL and
  ``token_logprobs`` against the JAX functions, fp32, atol 1e-6;
- GPT's and Llama's decode (prefill + single-token steps through the
  cache) against their own full forward and against the JAX package's
  prefill and decode logits with its cache (the JAX cache carried into
  the port by ``cache_from_jax`` too), fp32, rtol 1e-5 / atol 1e-5;
- greedy ``generate`` token for token equal to the JAX package's, the
  logprobs within 1e-5;
- one four-role ``make_experience`` (greedy) plus ``train_on_batch``
  against the JAX package's: the batch (tokens equal; logprobs,
  advantages and returns), the two losses and the updated actor and
  critic parameters (SGD on both sides), fp32, rtol 1e-4 / atol 1e-5;
- the reward-improves runs are the port's own (the reference's tests,
  ``torch.Generator`` sampling);
- :class:`HybridRolloutEngine` on a gloo world of 2 (one spawn of this
  file): the actor trains data-parallel and generates tensor-parallel 2
  (a decode copy whose Dense layers are DTensors), greedy sequences
  equal to world 1's, one reshard per experience phase under
  ``PPOTrainer``; a frozen ref in a tensor-sliced layout is refreshed
  from the actor (twins of ``test_ppo_trainer_hybrid_reshards_once_
  per_phase`` and ``test_per_role_strategies_and_reshard_accounting``).

Run as a script it prints the max-abs errors:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_rl.py``.
"""

import dataclasses
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

from dlrover_tpu.accel import Strategy as JStrategy  # noqa: E402
from dlrover_tpu.models import gpt as jax_gpt  # noqa: E402
from dlrover_tpu.models import llama as jax_llama  # noqa: E402
from dlrover_tpu.rl import generation as jax_generation  # noqa: E402
from dlrover_tpu.rl import model_engine as jax_engine  # noqa: E402
from dlrover_tpu.rl import ppo as jax_ppo  # noqa: E402
from dlrover_tpu.rl import rollout as jax_rollout  # noqa: E402
from dlrover_tpu_torch.accel import Strategy  # noqa: E402
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig  # noqa: E402
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig  # noqa: E402
from dlrover_tpu_torch.rl import ppo  # noqa: E402
from dlrover_tpu_torch.rl.generation import (  # noqa: E402
    decode_variant,
    generate,
    rollout_params,
)
from dlrover_tpu_torch.rl.model_engine import (  # noqa: E402
    ModelRole,
    RLModelEngine,
    RoleSpec,
)
from dlrover_tpu_torch.rl.rollout import (  # noqa: E402
    make_actor_loss,
    make_critic_loss,
    make_experience,
    ppo_iteration,
    sample_rollout_batch,
    train_on_batch,
)
from dlrover_tpu_torch.utils.convert import (  # noqa: E402
    cache_from_jax,
    params_from_jax,
)

ATOL = 1e-6
DEC_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
PROMPT_LEN, MAX_NEW, VOCAB = 4, 8, 32
ERRORS = {}


def _record(name, got, want):
    err = float(np.max(np.abs(np.asarray(got, np.float64)
                              - np.asarray(want, np.float64))))
    ERRORS[name] = max(err, ERRORS.get(name, 0.0))
    return err


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(name, got, want, **tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    _record(name, got, want)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


# -- the PPO math ------------------------------------------------------------


def test_gae_single_step_matches_closed_form():
    rewards, values, dones = [[1.0]], [[0.4]], [[1.0]]
    adv, ret = ppo.gae_advantages(_t(np.float32(rewards)),
                                  _t(np.float32(values)),
                                  _t(np.float32(dones)))
    np.testing.assert_allclose(ret.numpy(), [[1.0]], atol=ATOL)
    j_adv, j_ret = jax_ppo.gae_advantages(
        jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones))
    _close("gae_closed_form", adv, j_adv, atol=ATOL)
    _close("gae_closed_form", ret, j_ret, atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 3), (6, 9)])
def test_gae_propagates_backwards(shape):
    """The reference's discounted-returns case, then random rewards,
    values and episode ends against the JAX scan."""
    if shape == (1, 3):
        rewards = np.array([[0.0, 0.0, 1.0]], np.float32)
        values = np.zeros((1, 3), np.float32)
        dones = np.array([[0.0, 0.0, 1.0]], np.float32)
        gamma, lam = 0.9, 1.0
    else:
        rng = np.random.default_rng(3)
        rewards = rng.standard_normal(shape).astype(np.float32)
        values = rng.standard_normal(shape).astype(np.float32)
        dones = (rng.random(shape) < 0.2).astype(np.float32)
        gamma, lam = 0.99, 0.95
    adv, ret = ppo.gae_advantages(_t(rewards), _t(values), _t(dones),
                                  gamma=gamma, lam=lam)
    if shape == (1, 3):
        np.testing.assert_allclose(ret.numpy()[0], [0.81, 0.9, 1.0],
                                   atol=1e-5)
    j_adv, j_ret = jax_ppo.gae_advantages(
        jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones),
        gamma=gamma, lam=lam)
    _close("gae", adv, j_adv, atol=ATOL)
    _close("gae", ret, j_ret, atol=ATOL)


def test_ppo_policy_loss_clipping():
    """The reference's clip bounds, then random ratios (masked and not)
    against the JAX loss."""
    old, adv = torch.zeros(2, 4), torch.ones(2, 4)
    l_small = ppo.ppo_policy_loss(torch.full((2, 4), 0.1), old, adv)
    l_big = ppo.ppo_policy_loss(torch.full((2, 4), 5.0), old, adv)
    assert float(l_big) >= -1.21
    assert float(l_small) > float(l_big) - 1.2
    rng = np.random.default_rng(4)
    lp, olp, a = (rng.standard_normal((5, 7)).astype(np.float32) * 0.3
                  for _ in range(3))
    mask = (rng.random((5, 7)) < 0.7).astype(np.float32)
    for m in (None, mask):
        got = ppo.ppo_policy_loss(_t(lp), _t(olp), _t(a),
                                  mask=None if m is None else _t(m))
        want = jax_ppo.ppo_policy_loss(
            jnp.asarray(lp), jnp.asarray(olp), jnp.asarray(a),
            mask=None if m is None else jnp.asarray(m))
        _close("policy_loss", got, want, atol=ATOL)


def test_critic_loss_and_kl():
    v, r = torch.tensor([[1.0, 2.0]]), torch.tensor([[1.5, 1.5]])
    assert float(ppo.ppo_critic_loss(v, r)) > 0
    kl = ppo.kl_penalty(torch.tensor([0.0]), torch.tensor([-1.0]), 0.1)
    np.testing.assert_allclose(kl.numpy(), [0.1], atol=ATOL)
    rng = np.random.default_rng(5)
    vals, rets, old = (rng.standard_normal((3, 6)).astype(np.float32)
                       for _ in range(3))
    mask = (rng.random((3, 6)) < 0.6).astype(np.float32)
    for kw in (dict(), dict(old_values=old), dict(old_values=old,
                                                  mask=mask)):
        got = ppo.ppo_critic_loss(
            _t(vals), _t(rets), **{k: _t(v) for k, v in kw.items()})
        want = jax_ppo.ppo_critic_loss(
            jnp.asarray(vals), jnp.asarray(rets),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        _close("critic_loss", got, want, atol=ATOL)
    _close("kl", ppo.kl_penalty(_t(vals), _t(rets), 0.05),
           jax_ppo.kl_penalty(jnp.asarray(vals), jnp.asarray(rets), 0.05),
           atol=ATOL)


def test_token_logprobs_shape():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    tokens = rng.integers(0, 11, (2, 5)).astype(np.int32)
    lp = ppo.token_logprobs(_t(logits), _t(tokens))
    assert lp.shape == (2, 5) and (lp.numpy() <= 0).all()
    _close("token_logprobs", lp,
           jax_ppo.token_logprobs(jnp.asarray(logits), jnp.asarray(tokens)),
           atol=ATOL)


# -- decode ------------------------------------------------------------------


def _jax_model(family, **kw):
    if family == "gpt":
        return jax_gpt.GPT(jax_gpt.GPTConfig.tiny(dtype=jnp.float32, **kw))
    return jax_llama.Llama(jax_llama.LlamaConfig.tiny(dtype=jnp.float32,
                                                      **kw))


def _port_model(family, params, **kw):
    if family == "gpt":
        model = GPT(GPTConfig.tiny(dtype=torch.float32, **kw), device="cpu")
    else:
        model = Llama(LlamaConfig.tiny(dtype=torch.float32, **kw),
                      device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.fixture(scope="module", params=["gpt", "llama"])
def decode_pair(request):
    """A tiny fp32 model of the family in both packages (one flax init),
    its decode variants, and 10 tokens of 2 rows."""
    family = request.param
    jmodel = _jax_model(family)
    params = jmodel.init_params(jax.random.PRNGKey(0), seq_len=16)
    model = _port_model(family, params)
    dec = _port_model(family, params, decode=True)
    toks = np.random.default_rng(0).integers(
        0, model.config.vocab_size, (2, 10), dtype=np.int32)
    return family, jmodel, params, model, dec, toks


def test_kv_cache_decode_matches_full_forward(decode_pair):
    """Prefill + single-token decode steps reproduce the full-forward
    logits: the port's own cache against its own full forward."""
    family, _, _, model, dec, toks = decode_pair
    x = _t(toks)
    with torch.no_grad():
        full = model(x)
        dec.reset_cache()
        pre = dec(x[:, :8])
        _close(f"{family}_decode_vs_full", pre, full[:, :8].numpy(),
               **DEC_TOL)
        for i in (8, 9):
            step = dec(x[:, i:i + 1])
            _close(f"{family}_decode_vs_full", step[:, 0],
                   full[:, i].numpy(), **DEC_TOL)
        assert dec.blocks[0].attn.cache.cache_index == 10
        dec.reset_cache()
        assert dec.blocks[0].attn.cache.cached_key is None


def test_kv_cache_decode_matches_jax(decode_pair):
    """The port's prefill and decode logits against the JAX package's
    with its cache; the JAX cache after the prefill, carried into a
    fresh port cache, holds the port's own and decodes the same step."""
    family, jmodel, params, _, dec, toks = decode_pair
    jdec = jax_generation.decode_variant(jmodel)
    x = _t(toks)
    jpre, jvars = jdec.apply({"params": params}, jnp.asarray(toks[:, :8]),
                             mutable=["cache"])
    jcache = jvars["cache"]
    with torch.no_grad():
        dec.reset_cache()
        _close(f"{family}_prefill_vs_jax", dec(x[:, :8]), jpre, **DEC_TOL)
        other = _port_model(family, params, decode=True)
        other.reset_cache()
        cache_from_jax(other, jcache)
        for a, b in zip(dec.modules(), other.modules()):
            if hasattr(a, "cached_key") and a.cached_key is not None:
                _close(f"{family}_cache_vs_jax", a.cached_key,
                       b.cached_key.numpy(), **DEC_TOL)
                _close(f"{family}_cache_vs_jax", a.cached_value,
                       b.cached_value.numpy(), **DEC_TOL)
                assert a.cache_index == b.cache_index == 8
        for i in (8, 9):
            jstep, jvars = jdec.apply(
                {"params": params, "cache": jcache},
                jnp.asarray(toks[:, i:i + 1]), mutable=["cache"])
            jcache = jvars["cache"]
            _close(f"{family}_decode_vs_jax", dec(x[:, i:i + 1]), jstep,
                   **DEC_TOL)
            _close(f"{family}_decode_vs_jax", other(x[:, i:i + 1]), jstep,
                   **DEC_TOL)


def test_greedy_generate_matches_jax(decode_pair):
    """Greedy generation (temperature 0) through the cache: the same
    tokens as the JAX package's, the logprobs within 1e-5; the prompt
    plus the new tokens may not pass max_seq_len."""
    family, jmodel, params, model, _, toks = decode_pair
    prompts = toks[:, :6]
    jseq, jlp = jax_generation.generate(
        jax_generation.decode_variant(jmodel), params,
        jnp.asarray(prompts), jax.random.PRNGKey(0), max_new_tokens=12,
        temperature=0.0)
    seq, lp = generate(decode_variant(model), rollout_params(model),
                       _t(prompts), None, max_new_tokens=12,
                       temperature=0.0)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    _close(f"{family}_generate_logprobs", lp, jlp, atol=1e-5)
    with pytest.raises(ValueError, match="max_seq_len"):
        generate(decode_variant(model), rollout_params(model), _t(prompts),
                 None, max_new_tokens=model.config.max_seq_len,
                 temperature=0.0)


def test_value_head_matches_jax():
    """``head="value"``: the critic's fp32 scalar head over the final
    layernorm, against the JAX package's (its ``value_head`` carried
    over by the Dense rule)."""
    jmodel = _jax_model("gpt", head="value")
    params = jmodel.init_params(jax.random.PRNGKey(3), seq_len=16)
    model = _port_model("gpt", params, head="value")
    toks = np.random.default_rng(1).integers(0, 256, (2, 12),
                                             dtype=np.int32)
    with torch.no_grad():
        got = model(_t(toks))
    assert got.shape == (2, 12) and got.dtype == torch.float32
    _close("value_head", got, jmodel.apply({"params": params},
                                           jnp.asarray(toks)), **DEC_TOL)


# -- the four-role engine ----------------------------------------------------

FP32 = [("parallel_mode", {}), ("amp_native", {"dtype": "float32"})]


def _jax_engine(prompts, lr_actor=0.1, lr_critic=0.1):
    """The reference's four roles in fp32 with SGD (an Adam step turns
    the summation noise of a near-zero gradient into a step of up to
    lr: SGD keeps every parameter comparable at the stated tolerance)."""
    cfg = jax_gpt.GPTConfig.tiny(max_seq_len=64, vocab_size=VOCAB,
                                 dtype=jnp.float32)
    actor = jax_gpt.GPT(cfg)
    critic = jax_gpt.GPT(dataclasses.replace(cfg, head="value"))
    ref_params = actor.init_params(jax.random.PRNGKey(1))
    sample = jax_rollout.sample_rollout_batch(jnp.asarray(prompts), MAX_NEW)
    strategy = JStrategy(opts=FP32)
    return jax_engine.RLModelEngine(sample, {
        ModelRole.ACTOR: jax_engine.RoleSpec(
            model=actor,
            loss_fn=jax_rollout.make_actor_loss(actor, PROMPT_LEN),
            optim_factory=lambda: optax.sgd(lr_actor), strategy=strategy),
        ModelRole.CRITIC: jax_engine.RoleSpec(
            model=critic,
            loss_fn=jax_rollout.make_critic_loss(critic, PROMPT_LEN),
            optim_factory=lambda: optax.sgd(lr_critic), strategy=strategy),
        ModelRole.REF: jax_engine.RoleSpec(model=actor, params=ref_params),
    }).build(), ref_params


def _port_engine(prompts, actor_params=None, critic_params=None,
                 ref_params=None, strategy=None, critic_spec=None,
                 lr_actor=5e-3, lr_critic=1e-3, seed=1, sgd=False):
    cfg = GPTConfig.tiny(max_seq_len=64, vocab_size=VOCAB,
                         dtype=torch.float32)
    actor = GPT(cfg, device="cpu", seed=seed)
    critic = GPT(dataclasses.replace(cfg, head="value"), device="cpu",
                 seed=seed + 1)
    ref = GPT(cfg, device="cpu", seed=seed + 2)
    for model, params in ((actor, actor_params), (critic, critic_params)):
        if params is not None:
            model.load_state_dict(params_from_jax(params))
    strategy = strategy or Strategy(opts=FP32)
    critic_kw = critic_spec or dict(strategy=strategy)
    opt = torch.optim.SGD if sgd else torch.optim.Adam
    return RLModelEngine(sample_rollout_batch(_t(prompts), MAX_NEW), {
        ModelRole.ACTOR: RoleSpec(
            model=actor, loss_fn=make_actor_loss(actor, PROMPT_LEN),
            optim_factory=lambda ps: opt(ps, lr=lr_actor),
            strategy=strategy),
        ModelRole.CRITIC: RoleSpec(
            model=critic, loss_fn=make_critic_loss(critic, PROMPT_LEN),
            optim_factory=lambda ps: opt(ps, lr=lr_critic),
            **critic_kw),
        ModelRole.REF: RoleSpec(
            model=ref, params=(None if ref_params is None
                               else params_from_jax(ref_params))),
    }, device="cpu").build()


def _reward(sequences):
    resp = sequences[:, PROMPT_LEN:]
    return (resp < VOCAB // 2).float().mean(dim=1)


def _jax_reward(sequences):
    resp = sequences[:, PROMPT_LEN:]
    return (resp < VOCAB // 2).mean(axis=1).astype(jnp.float32)


def _prompts(seed=0, b=8):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, PROMPT_LEN),
                                                dtype=np.int32)


def test_four_role_experience_and_ppo_step_match_jax():
    """One greedy experience phase (rollout, ref KL, reward, critic
    values, GAE) and one actor + critic PPO step on its batch, in both
    packages from the same weights: the batch, the losses and the
    updated parameters agree in fp32."""
    prompts = _prompts()
    jeng, ref_params = _jax_engine(prompts)
    actor0 = jeng.state(ModelRole.ACTOR).params
    critic0 = jeng.state(ModelRole.CRITIC).params
    eng = _port_engine(prompts, actor0, critic0, ref_params, lr_actor=0.1,
                       lr_critic=0.1, sgd=True)
    jbatch, jm = jax_rollout.make_experience(
        jeng, jnp.asarray(prompts), jax.random.PRNGKey(2),
        max_new_tokens=MAX_NEW, temperature=0.0, kl_coef=0.05,
        reward_fn=_jax_reward)
    batch, m = make_experience(eng, _t(prompts), None,
                               max_new_tokens=MAX_NEW, temperature=0.0,
                               kl_coef=0.05, reward_fn=_reward)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  np.asarray(jbatch["tokens"]))
    for key in ("old_logprobs", "advantages", "returns"):
        _close(f"experience_{key}", batch[key], jbatch[key], **STEP_TOL)
    for key in ("mean_reward", "mean_kl"):
        _close(f"experience_{key}", m[key], jm[key], **STEP_TOL)
    for k in ("rollout_s", "score_s", "gae_s"):
        assert m[k] >= 0
    jlosses = jax_rollout.train_on_batch(jeng, jbatch)
    losses = train_on_batch(eng, batch)
    for key in ("actor_loss", "critic_loss"):
        _close(key, losses[key], jlosses[key], **STEP_TOL)
    for role in ModelRole.TRAINABLE:
        want = params_from_jax(jeng.state(role).params)
        got = dict(eng.state(role).module.named_parameters())
        assert set(got) == set(want)
        for name, w in want.items():
            _close(f"{role}_params", got[name], w.numpy(), **STEP_TOL)
        assert eng.state(role).step == 1


def test_rl_engine_four_roles_and_ref_sync():
    """The frozen roles infer and the trainable roles step; the ref
    refresh is a real copy of the actor's parameters, not an alias."""
    prompts = _prompts()
    eng = _port_engine(prompts)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, VOCAB, (8, 12), dtype=np.int32))
    assert eng.infer(ModelRole.REF, tokens).shape == (8, 12, VOCAB)
    batch = {"tokens": tokens, "old_logprobs": torch.zeros(8, MAX_NEW),
             "advantages": torch.ones(8, MAX_NEW),
             "returns": torch.ones(8, MAX_NEW)}
    losses = train_on_batch(eng, batch)
    assert all(np.isfinite(v) for v in losses.values())
    eng.sync_ref_from_actor()
    actor = dict(eng.state(ModelRole.ACTOR).module.named_parameters())
    ref = eng.frozen_params(ModelRole.REF)
    for name, p in actor.items():
        torch.testing.assert_close(ref[name], p.detach(), rtol=0, atol=0)
        assert ref[name].data_ptr() != p.data_ptr()
    report = eng.role_report()
    assert report[ModelRole.REF] == {"kind": "frozen",
                                     "layout": "replicated",
                                     "reshards": 1,
                                     "mean_reshard_s":
                                     report[ModelRole.REF]["mean_reshard_s"]}


def test_ppo_iteration_improves_reward():
    """Tiny end-to-end RLHF: the reward is the share of response tokens
    in the low half of the vocab; PPO iterations raise it (generation,
    ref KL, GAE, actor and critic steps all through the engine)."""
    prompts = _prompts()
    eng = _port_engine(prompts, strategy=Strategy(
        opts=[("parallel_mode", {})]))
    gen = torch.Generator().manual_seed(2)
    rewards = []
    for _ in range(12):
        metrics = ppo_iteration(eng, _t(prompts), gen,
                                max_new_tokens=MAX_NEW, kl_coef=0.01,
                                reward_fn=_reward)
        rewards.append(metrics["mean_reward"])
    assert np.mean(rewards[-3:]) > np.mean(rewards[:3]) + 0.05, rewards


def test_replay_buffer_minibatches():
    from dlrover_tpu_torch.rl.trainer import ReplayBuffer

    buf = ReplayBuffer()
    for i in range(3):
        buf.add({"a": np.full((4, 2), i),
                 "b": torch.arange(4) + 10 * i})
    assert buf.num == 12
    rng = np.random.default_rng(0)
    mbs = list(buf.minibatches(5, rng))
    assert len(mbs) == 2  # 12 // 5, remainder dropped
    seen = np.concatenate([mb["b"] for mb in mbs])
    assert len(set(seen.tolist())) == 10
    buf.reset()
    assert buf.num == 0 and not list(buf.minibatches(2, rng))
    with pytest.raises(ValueError, match="ragged"):
        buf.add({"a": np.zeros((4, 2)), "b": np.zeros(3)})


def test_rl_train_config_yaml(tmp_path):
    from dlrover_tpu_torch.rl.trainer import RLTrainConfig

    p = tmp_path / "rl.yaml"
    p.write_text(
        "epochs: 2\nnum_rollouts: 16\nppo_epochs: 3\n"
        "train_batch_size: 4\nkl_coef: 0.01\nlogdir: /tmp/x\n"
    )
    cfg = RLTrainConfig.from_yaml(str(p))
    assert cfg.epochs == 2 and cfg.num_rollouts == 16
    assert cfg.ppo_epochs == 3 and cfg.kl_coef == 0.01
    assert cfg.extra == {"logdir": "/tmp/x"}


def test_ppo_trainer_buffer_cycle_improves_reward():
    """The reference trainer's shape: fill the replay buffer with
    several rollouts, then PPO epochs over shuffled minibatches; the
    reward improves across cycles, the buffer resets per phase, and the
    critic SEARCHES its own strategy (cost model, a budget of 3)."""
    from dlrover_tpu_torch.rl.trainer import PPOTrainer, RLTrainConfig

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (8, PROMPT_LEN), dtype=np.int32)
               for _ in range(4)]
    eng = _port_engine(
        prompts[0], strategy=Strategy(opts=[("parallel_mode", {})]),
        critic_spec=dict(search=True, rank_mode="cost_model",
                         cost_budget=3))
    report = eng.role_report()
    assert report[ModelRole.CRITIC]["searched"] is True
    assert report[ModelRole.ACTOR]["strategy"] == ["parallel_mode"]
    with pytest.raises(ValueError, match="train_batch_size"):
        PPOTrainer(eng, RLTrainConfig(train_batch_size=4))
    trainer = PPOTrainer(
        eng, RLTrainConfig(epochs=4, num_rollouts=16, ppo_epochs=2,
                           train_batch_size=8, max_new_tokens=MAX_NEW,
                           kl_coef=0.01),
        reward_fn=_reward)
    history = trainer.train(prompts)
    # 4 prompt batches x 8 = 32 rollouts an epoch -> 2 training phases
    # an epoch x 4 epochs
    assert len(history) == 8, history
    assert all(h["ppo_steps"] == 4 for h in history)
    rewards = [h["mean_reward"] for h in history]
    assert np.mean(rewards[-2:]) > np.mean(rewards[:2]), rewards
    assert trainer.replay_buffer.num == 0


def test_rl_entry_points_need_the_card_unless_the_cpu_is_named():
    """No GPU and no explicit device: the engine raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RLModelEngine({}, {})
    from dlrover_tpu_torch.rl.elastic import lease_rng

    with pytest.raises(RuntimeError, match="no CUDA device"):
        lease_rng(2, 0)


# -- the hybrid rollout engine on gloo --------------------------------------


def _whole(t):
    from dlrover_tpu_torch.common.device import is_dtensor

    return (t.full_tensor() if is_dtensor(t) else t).detach().numpy()


def _worker(rank, world, port, in_path, out_path):
    """World 2: the actor trains data-parallel, generates tensor-
    parallel 2; the ref frozen in a tensor-2 layout."""
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.rl.hybrid_engine import HybridRolloutEngine
    from dlrover_tpu_torch.rl.trainer import PPOTrainer, RLTrainConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    prompts = job["prompts"]
    tp = build_mesh(MeshConfig(data=1, tensor=world), device_type="cpu")
    eng = _port_engine(prompts[0])
    # a tensor-sliced frozen ref (its own copy of the module)
    cfg = GPTConfig.tiny(max_seq_len=64, vocab_size=VOCAB,
                         dtype=torch.float32)
    ref = GPT(cfg, device="cpu", seed=3)
    eng._roles[ModelRole.REF] = RoleSpec(model=ref, mesh=tp)
    eng._build_frozen(ModelRole.REF, eng._roles[ModelRole.REF])
    hybrid = HybridRolloutEngine(eng, tp)
    out = {}
    params = hybrid.reshard_actor_for_rollout()
    out["rollout_placements"] = {
        n: str(p.placements) for n, p in params.items()
        if hasattr(p, "placements")}
    seq, lp = generate(hybrid.rollout_model, params, _t(prompts[0]), None,
                       max_new_tokens=MAX_NEW, temperature=0.0)
    out["greedy"] = (seq.numpy(), lp.numpy())
    out["ref_logits"] = _whole(eng.infer(ModelRole.REF, seq[:, :-1]))
    trainer = PPOTrainer(
        eng, RLTrainConfig(epochs=2, num_rollouts=24, ppo_epochs=1,
                           train_batch_size=8, max_new_tokens=MAX_NEW),
        reward_fn=_reward, hybrid=hybrid)
    history = trainer.train(prompts)
    out["history"] = len(history)
    out["stats"] = hybrid.stats()
    out["rollout_params_dropped"] = trainer._rollout_params is None
    eng.sync_ref_from_actor()
    ref_params = eng.frozen_params(ModelRole.REF)
    actor = dict(eng.state(ModelRole.ACTOR).module.named_parameters())
    out["ref_sync_err"] = max(
        float(np.abs(_whole(ref_params[n]) - _whole(actor[n])).max())
        for n in actor)
    out["report"] = eng.role_report()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def hybrid_world2():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (8, PROMPT_LEN), dtype=np.int32)
               for _ in range(3)]
    return prompts, spawn({"prompts": prompts}, os.path.abspath(__file__),
                          world=2)


def test_hybrid_rollout_greedy_matches_world_one(hybrid_world2):
    """The tensor-2 rollout copy (column- and row-sliced Dense layers)
    generates, greedily, exactly what one process generates with the
    same actor (fp32 plans: the row-parallel partial sums round in
    another order); the tensor-sliced ref scores as one process does."""
    prompts, got = hybrid_world2
    eng = _port_engine(prompts[0])
    actor = eng.state(ModelRole.ACTOR).module
    seq, lp = generate(decode_variant(actor), rollout_params(actor),
                       _t(prompts[0]), None, max_new_tokens=MAX_NEW,
                       temperature=0.0)
    np.testing.assert_array_equal(got["greedy"][0], seq.numpy())
    _close("hybrid_greedy_logprobs", got["greedy"][1], lp.numpy(),
           atol=1e-5)
    assert any("Shard" in p for p in got["rollout_placements"].values())
    ref = GPT(GPTConfig.tiny(max_seq_len=64, vocab_size=VOCAB,
                             dtype=torch.float32), device="cpu", seed=3)
    with torch.no_grad():
        want = ref(seq[:, :-1])
    _close("hybrid_ref_logits", got["ref_logits"], want.numpy(), atol=1e-5)


def test_ppo_trainer_hybrid_reshards_once_per_phase(hybrid_world2):
    """The phase hook amortizes the layout copy: one reshard per
    experience phase (3 batches x 8 = 24 rollouts = one phase an epoch,
    2 epochs) plus the greedy check's, reused by every rollout of the
    phase and dropped after it; the refreshed tensor-sliced ref holds
    the actor's parameters and every transition is accounted per
    role."""
    _, got = hybrid_world2
    assert got["history"] == 2
    assert got["stats"]["reshards"] == 3, got["stats"]
    assert got["rollout_params_dropped"]
    assert got["ref_sync_err"] == 0.0
    report = got["report"]
    assert report[ModelRole.ACTOR]["reshards"] == 3
    assert report[ModelRole.REF]["layout"] == "sharded"
    assert report[ModelRole.REF]["reshards"] == 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, *sys.argv[5:7])
    else:
        sys.exit(pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
                 or print(ERRORS))
