"""Flax GPT and Llama params and q-AdamW state <-> the port's models
and optimizers.

Reference: ``dlrover_tpu/utils/torch_compat.py`` (``gpt2_params_to_torch``
maps the same flax tree onto HF GPT-2 names) and the ``QAdamWState``
of ``dlrover_tpu/optim/low_bit.py``.  Here the targets are
:class:`dlrover_tpu_torch.models.gpt.GPT` and
:class:`dlrover_tpu_torch.models.llama.Llama`, whose module names follow
the flax tree and whose Dense weights keep flax's ``[in, out]``
layout, so the map is by rule:

- ``block_i`` is ``blocks.i``;
- a pipelined model's stage-stacked tree (the reference's
  ``{"embed", "blocks", "head"}``, ``blocks`` leaves ``[stages,
  layers/stage, ...]``, padded slots included) is ``embed.*``,
  ``blocks.<name>`` and ``head.*`` of
  :class:`~dlrover_tpu_torch.models.gpt.PipelinedDecoder`, by the same
  rules (the optimizer-state converters follow the params);
- ``Dense.kernel`` is ``Dense.weight``, same layout (GPT's fused
  ``qkv``; Llama's ``q_proj``/``k_proj``/``v_proj``/``o_proj`` and
  ``gate``/``up``/``down``; the untied ``lm_head``);
- ``LayerNorm.scale``, Llama's ``RMSNorm.scale`` (any ``ln_*``) and
  ``Embed.embedding`` are ``weight``;
- ``bias`` is ``bias``;
- an MoE block's ``moe/router/kernel`` is ``moe.router.weight`` and its
  expert kernels ``moe/experts_w_{in,gate,out}`` (``[e, in, out]``) are
  parameters of the same names on ``moe``;
- the critic's ``value_head/{kernel,bias}`` is ``value_head.{weight,
  bias}`` (the Dense rule);
- DeepFM's dense tower ``dense_i/{w,b}`` is ``dense_i.{weight,bias}``
  (:func:`deepfm_dense_from_jax`).

The decode ``cache`` collection of the JAX package (``block_i/attn/
{cached_key, cached_value, cache_index}`` and GPT's ``pos_index``) goes
into a decode-mode model's caches with :func:`cache_from_jax`.

Both directions copy values exactly (bf16 leaves too, and the fp32
norm scales a bf16 model keeps), so a round trip is bit-exact.  The
trees are matched by name, never by position: JAX flattens a dict with
its keys sorted (``block_10`` before ``block_2``, ``k_proj`` before
``q_proj``), the port's modules in their own order.  The flax side is a nested dict of numpy arrays
(``np.asarray`` of each leaf).  A bf16 leaf going to the flax side
needs numpy's ``bfloat16`` dtype, which ``ml_dtypes`` registers (JAX
imports it).

Because every leaf flattens in the same order on both sides, the
blockwise moments of q-AdamW (int8 codes ``[rows, block]`` and fp32
scales ``[rows, 1]`` per leaf) carry over code for code, and so does a
``torch.optim.AdamW``'s state laid out as optax ``adamw``'s
(:func:`adamw_state_tree`, :func:`adamw_state_from_tree`): a
``{"params", "opt_state"}`` checkpoint of the JAX package's elastic
example resumes the port's, sharded or not, and the other way round.
"""

from collections import namedtuple
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_EMBEDDINGS = ("wte", "wpe")
# the MoE expert kernels: flax params of their own name, not a kernel
_EXPERTS = "experts_w_"


def _flat(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_name(path) -> str:
    """flax leaf path -> the port's parameter name."""
    *module, leaf = path
    expert = leaf.startswith(_EXPERTS)
    if leaf not in ("kernel", "scale", "embedding", "bias") and not expert:
        raise KeyError(f"unknown flax leaf {'/'.join(path)}")
    parts = []
    for p in module:
        if p.startswith("block_") and p[len("block_"):].isdigit():
            parts += ["blocks", p[len("block_"):]]
        else:
            parts.append(p)
    if expert:
        return ".".join(parts + [leaf])
    return ".".join(parts + ["bias" if leaf == "bias" else "weight"])


def flax_path(name: str) -> Tuple[str, ...]:
    """The port's parameter name -> the flax leaf path (the one the
    partition rules of :mod:`dlrover_tpu_torch.parallel.sharding`
    match)."""
    *module, last = name.split(".")
    path = []
    i = 0
    while i < len(module):
        if module[i] == "blocks" and module[i + 1].isdigit():
            path.append(f"block_{module[i + 1]}")
            i += 2
        else:
            path.append(module[i])
            i += 1
    if last.startswith(_EXPERTS):
        return tuple(path) + (last,)
    parent = path[-1]
    if last == "bias":
        leaf = "bias"
    elif parent in _EMBEDDINGS:
        leaf = "embedding"
    elif parent.startswith("ln"):
        leaf = "scale"
    else:
        leaf = "kernel"
    return tuple(path) + (leaf,)


def _tensor(value) -> torch.Tensor:
    arr = np.array(value, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _numpy(tensor: torch.Tensor) -> np.ndarray:
    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as e:
            raise TypeError(
                "a bfloat16 leaf needs numpy's bfloat16 dtype: import "
                "ml_dtypes first"
            ) from e
        return t.view(torch.int16).numpy().copy().view(bf16)
    return t.numpy().copy()


def _set(tree: Dict[str, Any], path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax GPT params (nested dict of arrays) -> GPT state dict."""
    return {_torch_name(path): _tensor(value) for path, value in _flat(params)}


def cache_from_jax(model: torch.nn.Module, cache: Mapping[str, Any]):
    """The JAX package's decode ``cache`` collection (after a prefill or
    a step) into the caches of ``model``, a decode-mode GPT or Llama of
    the same shape, in place: each layer's ``cached_key`` and
    ``cached_value`` (``[b, max_len, kv_heads, d]`` there, ``[b,
    kv_heads, max_len, d]`` here) and ``cache_index``, and GPT's
    ``pos_index``, on the model's device."""
    device = next(model.parameters()).device
    for path, value in _flat(cache):
        if path == ("pos_index",):
            model.pos_index = int(np.asarray(value))
            continue
        *module, leaf = path
        name = _torch_name(tuple(module) + ("kernel",)).rsplit(".", 1)[0]
        layer = model.get_submodule(name).cache
        if leaf == "cache_index":
            layer.cache_index = int(np.asarray(value))
        else:
            setattr(layer, leaf,
                    _tensor(value).transpose(1, 2).contiguous().to(device))


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """GPT state dict -> flax GPT params (nested dict of numpy)."""
    params: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        _set(params, flax_path(key), _numpy(tensor))
    return params


def params_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's parameters themselves (no copies) nested under their
    flax paths: the ``params`` of a checkpoint that the JAX package's
    ``Trainer`` reads, and a template for
    :func:`dlrover_tpu_torch.checkpoint.checkpointer.restore_to_template`."""
    params: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        _set(params, flax_path(name), p)
    return params


# -- q-AdamW state ------------------------------------------------------------


def _field(state, name: str):
    return state[name] if isinstance(state, Mapping) else getattr(state, name)


def qadamw_state_from_jax(state, model: torch.nn.Module) -> Dict[str, Any]:
    """The reference's ``QAdamWState`` (``count``, ``mu``/``nu`` trees
    of ``QMoment(values, scales)`` shaped as the params, ``nu_domain``;
    numpy leaves, as a namedtuple or a dict) -> a state dict for
    :meth:`dlrover_tpu_torch.optim.low_bit.QAdamW.load_state_dict`.

    Parameters are indexed in ``model.named_parameters()`` order, the
    order of an optimizer built from ``model.parameters()``.  The dict
    carries no ``param_groups``: the optimizer keeps its own
    hyperparameters."""
    index = {name: i for i, (name, _) in enumerate(model.named_parameters())}
    count = int(np.asarray(_field(state, "count")))
    moments = {}
    for which in ("mu", "nu"):
        tree = dict(_flat(_field(state, which)))
        moments[which] = {_torch_name(path): qm for path, qm in tree.items()}
        if moments[which].keys() != index.keys():
            raise KeyError(
                f"{which} leaves {sorted(moments[which])} are not the "
                f"model's parameters {sorted(index)}"
            )
    out = {}
    for name, i in index.items():
        mu, nu = moments["mu"][name], moments["nu"][name]
        out[i] = {"step": count,
                  "mu_values": _tensor(mu[0]), "mu_scales": _tensor(mu[1]),
                  "nu_values": _tensor(nu[0]), "nu_scales": _tensor(nu[1])}
    return {"state": out,
            "nu_domain": int(np.asarray(_field(state, "nu_domain")))}


def qadamw_state_tree(optimizer, model: torch.nn.Module) -> Dict[str, Any]:
    """The port's q-AdamW state in the reference's ``QAdamWState``
    layout, its codes and scales the optimizer's own tensors (no
    copies): ``{"count", "mu", "nu", "nu_domain"}`` with ``count`` and
    ``nu_domain`` as 0-d int32 tensors and ``mu``/``nu`` nested like
    the flax params with ``QMoment(values, scales)`` leaves — the
    ``opt_state`` of a checkpoint, laid out as the JAX package lays
    out its own."""
    from dlrover_tpu_torch.optim.low_bit import NU_DOMAIN_SQRT_V1, QMoment

    tree = {"mu": {}, "nu": {}}
    steps = set()
    for name, p in model.named_parameters():
        st = optimizer.state[p]
        steps.add(int(st["step"]))
        for which in ("mu", "nu"):
            _set(tree[which], flax_path(name), QMoment(
                values=st[f"{which}_values"], scales=st[f"{which}_scales"],
            ))
    if len(steps) != 1:
        raise ValueError(f"parameters at different step counts: {steps}")
    return {"count": torch.tensor(steps.pop(), dtype=torch.int32),
            "mu": tree["mu"], "nu": tree["nu"],
            "nu_domain": torch.tensor(NU_DOMAIN_SQRT_V1, dtype=torch.int32)}


def qadamw_state_to_jax(optimizer, model: torch.nn.Module) -> Dict[str, Any]:
    """The port's q-AdamW state -> the reference's ``QAdamWState``
    layout as a dict of numpy: ``{"count", "mu", "nu", "nu_domain"}``,
    ``mu``/``nu`` nested like the flax params with ``QMoment(values,
    scales)`` leaves."""
    from dlrover_tpu_torch.optim.low_bit import QMoment

    sd = optimizer.state_dict()
    names = [name for name, _ in model.named_parameters()]
    steps = {int(sd["state"][i]["step"]) for i in range(len(names))}
    if len(steps) != 1:
        raise ValueError(f"parameters at different step counts: {steps}")
    tree = {"mu": {}, "nu": {}}
    for i, name in enumerate(names):
        st = sd["state"][i]
        for which in ("mu", "nu"):
            _set(tree[which], flax_path(name), QMoment(
                values=_numpy(st[f"{which}_values"]),
                scales=_numpy(st[f"{which}_scales"]),
            ))
    return {"count": np.asarray(steps.pop(), np.int32), "mu": tree["mu"],
            "nu": tree["nu"],
            "nu_domain": np.asarray(sd["nu_domain"], np.int32)}


# -- the optimizers of slice 4.1 ----------------------------------------------


def _moment_state(state):
    """The first node of an optax state (a namedtuple, or a tuple of
    them) with ``count``/``mu``/``nu`` fields (``ScaleByAdamState``,
    ``AGDState``), or with a ``trace`` (SGD momentum)."""
    if hasattr(state, "_fields"):
        if {"count", "mu", "nu"} <= set(state._fields) or \
                "trace" in state._fields:
            return state
    if isinstance(state, (tuple, list)):
        for node in state:
            found = _moment_state(node)
            if found is not None:
                return found
    return None


def _by_name(tree, model) -> Dict[str, torch.Tensor]:
    leaves = {_torch_name(path): _tensor(v) for path, v in _flat(tree)}
    names = [name for name, _ in model.named_parameters()]
    if set(leaves) != set(names):
        raise KeyError(f"leaves {sorted(leaves)} are not the model's "
                       f"parameters {sorted(names)}")
    return leaves


def optimizer_state_from_jax(opt_state, optimizer, model: torch.nn.Module
                             ) -> Dict[str, Any]:
    """A JAX ``TrainState.opt_state`` (numpy leaves) of the reference's
    ``optax.adamw``, ``adamw_bf16``, ``agd``, ``with_fp32_master(...)``,
    ``offload(...)`` or ``wsam(optax.sgd(...))`` -> a state dict for
    ``optimizer.load_state_dict``, where ``optimizer`` is the port's
    counterpart (``torch.optim.AdamW`` or :class:`~dlrover_tpu_torch.
    optim.OptaxAdamW`, :class:`~dlrover_tpu_torch.optim.AGD`,
    :class:`~dlrover_tpu_torch.optim.Fp32Master`,
    :class:`~dlrover_tpu_torch.optim.Offload`,
    :class:`~dlrover_tpu_torch.optim.WSAM` over ``torch.optim.SGD``)
    built over ``model.parameters()``.  The parameters are indexed in
    ``model.named_parameters()`` order; the optimizer keeps its own
    hyperparameters."""
    from dlrover_tpu_torch.optim import AGD, WSAM, Fp32Master, OptaxAdamW
    from dlrover_tpu_torch.optim.offload import Offload

    names = [name for name, _ in model.named_parameters()]
    groups = optimizer.state_dict().get("param_groups")
    if isinstance(optimizer, Offload):
        return optimizer_state_from_jax(opt_state, optimizer.inner, model)
    if isinstance(optimizer, Fp32Master):
        master = _by_name(_field(opt_state, "master"), model)
        return {"master": [master[n] for n in names],
                "inner": optimizer_state_from_jax(
                    _field(opt_state, "inner"), optimizer.inner, model)}
    if isinstance(optimizer, WSAM):
        return {"wsam": optimizer.state_dict()["wsam"],
                "base": optimizer_state_from_jax(opt_state, optimizer.base,
                                                 model)}
    node = _moment_state(opt_state)
    state: Dict[int, Dict[str, Any]] = {}
    if node is not None and "trace" in node._fields:
        trace = _by_name(node.trace, model)
        state = {i: {"momentum_buffer": trace[n]}
                 for i, n in enumerate(names)}
    elif node is not None:
        count = int(np.asarray(node.count))
        mu, nu = _by_name(node.mu, model), _by_name(node.nu, model)
        for i, n in enumerate(names):
            if isinstance(optimizer, (AGD, OptaxAdamW)):
                state[i] = {"step": count, "mu": mu[n], "nu": nu[n]}
            else:  # torch.optim.AdamW
                state[i] = {"step": torch.tensor(float(count)),
                            "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    return {"state": state, "param_groups": groups}


# -- AdamW state under optax adamw's paths ------------------------------------

# optax.adamw's state: chain(scale_by_adam, add_decayed_weights,
# scale_by_learning_rate), ``(ScaleByAdamState(count, mu, nu), EmptyState(),
# EmptyState())``, flattened to ``0/count``, ``0/mu/<flax path>`` and
# ``0/nu/<flax path>``
ScaleByAdamState = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
EmptyState = namedtuple("EmptyState", [])


def init_adamw_state(optimizer: torch.optim.Optimizer):
    """Create the state of every parameter of a ``torch.optim.AdamW``
    (or ``Adam``) that has none yet, as its first step would: ``step``
    0, zero moments like the parameter (a DTensor parameter gets
    DTensor moments with its placements).  The state then exists before
    the first step, as optax's ``init`` makes it, so a checkpoint can
    be restored into it."""
    with torch.no_grad():
        for group in optimizer.param_groups:
            for p in group["params"]:
                st = optimizer.state[p]
                if st:
                    continue
                if group.get("capturable") or group.get("fused"):
                    st["step"] = torch.zeros((), dtype=torch.float32,
                                             device=p.device)
                else:
                    st["step"] = torch.tensor(0.0, dtype=torch.float32)
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                if group.get("amsgrad"):
                    st["max_exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)


def adamw_state_tree(optimizer: torch.optim.Optimizer,
                     model: torch.nn.Module):
    """A ``torch.optim.AdamW``'s state laid out as optax ``adamw``'s:
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``
    with ``mu``/``nu`` nested like the flax params and holding the
    optimizer's own ``exp_avg``/``exp_avg_sq`` tensors (no copies;
    DTensors under FSDP2) and ``count`` a 0-d int32 tensor.  The state
    is created first where it is missing (:func:`init_adamw_state`), so
    the tree is a restore target before the first step too."""
    init_adamw_state(optimizer)
    mu: Dict[str, Any] = {}
    nu: Dict[str, Any] = {}
    steps = set()
    for name, p in model.named_parameters():
        st = optimizer.state[p]
        steps.add(int(st["step"]))
        _set(mu, flax_path(name), st["exp_avg"])
        _set(nu, flax_path(name), st["exp_avg_sq"])
    if len(steps) != 1:
        raise ValueError(f"parameters at different step counts: {steps}")
    count = torch.tensor(steps.pop(), dtype=torch.int32)
    return (ScaleByAdamState(count=count, mu=mu, nu=nu), EmptyState(),
            EmptyState())


def _adam_node(tree):
    """The ``count``/``mu``/``nu`` node of an optax adamw state: a
    namedtuple, a tuple of them, or the nested dict an untargeted
    restore gives (``{"0": {"count", "mu", "nu"}}``)."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        if "0" in tree:
            return _adam_node(tree["0"])
    node = _moment_state(tree)
    if node is None:
        raise KeyError("no count/mu/nu node in the optimizer state")
    return node


def _copy_into(dst: torch.Tensor, value):
    """``dst`` (a moment, a DTensor under FSDP2) takes ``value``: the
    same tensor is left alone, a DTensor's local part copies from a
    DTensor's or from its box of a full tensor."""
    from dlrover_tpu_torch.checkpoint.sharded import is_dtensor, local_box

    if value is dst:
        return
    if not isinstance(value, torch.Tensor):
        value = _tensor(value)
    if tuple(value.shape) != tuple(dst.shape):
        raise ValueError(f"moment {tuple(value.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    if is_dtensor(dst):
        local = dst.to_local()
        if is_dtensor(value):
            value = value.to_local()
        else:
            value = value[tuple(slice(lo, hi) for lo, hi in local_box(dst))]
        dst = local
    dst.copy_(value.to(dst.dtype))


def adamw_state_from_tree(tree, optimizer: torch.optim.Optimizer,
                          model: torch.nn.Module):
    """Inverse of :func:`adamw_state_tree`: an optax adamw state (the
    port's tree restored in place, the JAX package's ``opt_state`` of
    numpy leaves, or an untargeted restore's nested dict) into a
    ``torch.optim.AdamW``'s state over ``model.parameters()``.  Each
    parameter's ``step`` becomes ``count``; a moment that is not
    already the optimizer's own tensor is copied in (DTensor-aware: a
    moment of a DTensor parameter keeps its placements and takes its
    own box)."""
    node = _adam_node(tree)
    count = int(np.asarray(_field(node, "count")))
    init_adamw_state(optimizer)
    mu = dict(_flat(_field(node, "mu")))
    nu = dict(_flat(_field(node, "nu")))
    with torch.no_grad():
        for name, p in model.named_parameters():
            path = flax_path(name)
            st = optimizer.state[p]
            _copy_into(st["exp_avg"], mu[path])
            _copy_into(st["exp_avg_sq"], nu[path])
            st["step"].fill_(float(count))


_DEEPFM_LEAVES = {"w": "weight", "b": "bias"}


def deepfm_dense_from_jax(params: Mapping[str, Any], tower: torch.nn.Module):
    """Load DeepFM's dense params of the JAX package (``{"dense_i":
    {"w", "b"}}``, ``w`` ``[in, out]``) into the port's
    :class:`~dlrover_tpu_torch.models.deepfm.DenseTower` (``dense_i.
    weight`` in the same layout, ``dense_i.bias``); values are copied
    exactly."""
    own = dict(tower.named_parameters())
    seen = set()
    with torch.no_grad():
        for (*module, leaf), value in _flat(params):
            name = ".".join([*module, _DEEPFM_LEAVES.get(leaf, leaf)])
            if name not in own:
                raise KeyError(f"DeepFM tower has no parameter {name!r}")
            own[name].copy_(_tensor(value).reshape(own[name].shape))
            seen.add(name)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"JAX params lack {missing}")
    return tower

