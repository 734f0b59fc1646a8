"""Flax GPT params <-> the port's GPT state dict.

Reference: ``dlrover_tpu/utils/torch_compat.py`` (``gpt2_params_to_torch``
maps the same flax tree onto HF GPT-2 names).  Here the target is
:class:`dlrover_tpu_torch.models.gpt.GPT`, whose module names follow
the flax tree, so the map is by rule:

- ``block_i`` is ``blocks.i``;
- ``Dense.kernel`` ``[in, out]`` is ``nn.Linear.weight`` ``[out, in]``
  (transposed);
- ``LayerNorm.scale`` and ``Embed.embedding`` are ``weight``;
- ``bias`` is ``bias``.

Both directions copy values exactly, so a round trip is bit-exact.
The flax side is a nested dict of numpy arrays (``np.asarray`` of each
leaf of the flax params).
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

_EMBEDDINGS = ("wte", "wpe")


def _flat(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_module(path) -> str:
    parts = []
    for p in path:
        if p.startswith("block_") and p[len("block_"):].isdigit():
            parts += ["blocks", p[len("block_"):]]
        else:
            parts.append(p)
    return ".".join(parts)


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax GPT params (nested dict of arrays) -> GPT state dict."""
    sd = {}
    for path, value in _flat(params):
        *module, leaf = path
        value = np.array(value, copy=True)
        if leaf == "kernel":
            value = np.ascontiguousarray(value.T)
        elif leaf not in ("scale", "embedding", "bias"):
            raise KeyError(f"unknown flax leaf {'/'.join(path)}")
        name = "bias" if leaf == "bias" else "weight"
        sd[f"{_torch_module(module)}.{name}"] = torch.from_numpy(value)
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """GPT state dict -> flax GPT params (nested dict of numpy)."""
    params: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        parts = key.split(".")
        *module, name = parts
        path = []
        i = 0
        while i < len(module):
            if module[i] == "blocks":
                path.append(f"block_{module[i + 1]}")
                i += 2
            else:
                path.append(module[i])
                i += 1
        value = tensor.detach().cpu().numpy().copy()
        parent = path[-1]
        if name == "bias":
            leaf = "bias"
        elif parent in _EMBEDDINGS:
            leaf = "embedding"
        elif parent.startswith("ln"):
            leaf = "scale"
        else:
            leaf = "kernel"
            value = np.ascontiguousarray(value.T)
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return params
