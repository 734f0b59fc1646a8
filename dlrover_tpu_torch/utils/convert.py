"""Flax GPT params and q-AdamW state <-> the port's GPT and optimizer.

Reference: ``dlrover_tpu/utils/torch_compat.py`` (``gpt2_params_to_torch``
maps the same flax tree onto HF GPT-2 names) and the ``QAdamWState``
of ``dlrover_tpu/optim/low_bit.py``.  Here the target is
:class:`dlrover_tpu_torch.models.gpt.GPT`, whose module names follow
the flax tree and whose Dense weights keep flax's ``[in, out]``
layout, so the map is by rule:

- ``block_i`` is ``blocks.i``;
- ``Dense.kernel`` is ``Dense.weight``, same layout;
- ``LayerNorm.scale`` and ``Embed.embedding`` are ``weight``;
- ``bias`` is ``bias``.

Both directions copy values exactly (bf16 leaves too), so a round trip
is bit-exact.  The flax side is a nested dict of numpy arrays
(``np.asarray`` of each leaf).  A bf16 leaf going to the flax side
needs numpy's ``bfloat16`` dtype, which ``ml_dtypes`` registers (JAX
imports it).

Because every leaf flattens in the same order on both sides, the
blockwise moments of q-AdamW (int8 codes ``[rows, block]`` and fp32
scales ``[rows, 1]`` per leaf) carry over code for code.
"""

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_EMBEDDINGS = ("wte", "wpe")


def _flat(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_name(path) -> str:
    """flax leaf path -> the port's parameter name."""
    *module, leaf = path
    if leaf not in ("kernel", "scale", "embedding", "bias"):
        raise KeyError(f"unknown flax leaf {'/'.join(path)}")
    parts = []
    for p in module:
        if p.startswith("block_") and p[len("block_"):].isdigit():
            parts += ["blocks", p[len("block_"):]]
        else:
            parts.append(p)
    return ".".join(parts + ["bias" if leaf == "bias" else "weight"])


def _flax_path(name: str) -> Tuple[str, ...]:
    """The port's parameter name -> flax leaf path."""
    *module, last = name.split(".")
    path = []
    i = 0
    while i < len(module):
        if module[i] == "blocks":
            path.append(f"block_{module[i + 1]}")
            i += 2
        else:
            path.append(module[i])
            i += 1
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


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """GPT state dict -> flax GPT params (nested dict of numpy)."""
    params: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        _set(params, _flax_path(key), _numpy(tensor))
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
            _set(tree[which], _flax_path(name), QMoment(
                values=_numpy(st[f"{which}_values"]),
                scales=_numpy(st[f"{which}_scales"]),
            ))
    return {"count": np.asarray(steps.pop(), np.int32), "mu": tree["mu"],
            "nu": tree["nu"],
            "nu_domain": np.asarray(sd["nu_domain"], np.int32)}
