"""Numeric health checks on trees of tensors.

Copy of ``dlrover_tpu/utils/numeric_checker.py`` (reference:
``atorch/utils/numberic_checker.py`` — guards against NaN/Inf and
silent dtype drift between two implementations).  A tree is a tensor,
a numpy array or a scalar, or a nested dict, list or tuple of them (a
state dict, ``dict(model.named_parameters())``); a leaf is read on the
host in fp32 (a DTensor by its local shard).  Leaves are named by their
keys joined with ``/``, dict keys in sorted order as a pytree flattens
them.
"""

from typing import Any, List, Tuple

import numpy as np


def tree_leaves(tree, path=()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf)]`` of a tree, dict keys sorted."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += tree_leaves(tree[key], path + (key,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, node in enumerate(tree):
            out += tree_leaves(node, path + (i,))
        return out
    return [(path, tree)]


def _host(leaf) -> np.ndarray:
    """A leaf as a host array; floating tensors as fp32 (numpy has no
    bfloat16)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "to_local"):
            t = t.to_local()
        if t.is_floating_point():
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def check_numerics(tree, name: str = "tree") -> List[str]:
    """Return a list of problems (empty = healthy)."""
    problems = []
    for path, leaf in tree_leaves(tree):
        arr = _host(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        key = "/".join([name] + [str(p) for p in path])
        finite = np.isfinite(arr.astype(np.float32))
        if not finite.all():
            bad = int((~finite).sum())
            problems.append(f"{key}: {bad} non-finite values")
        elif arr.size and float(np.abs(arr.astype(np.float32)).max()) > 1e8:
            problems.append(f"{key}: magnitude > 1e8")
    return problems


def compare_pytrees(a, b, rtol: float = 1e-4, atol: float = 1e-5) -> List[str]:
    """Structural + numeric diff of two trees (golden checks)."""
    flat_a, flat_b = tree_leaves(a), tree_leaves(b)
    if [p for p, _ in flat_a] != [p for p, _ in flat_b]:
        return ["pytree structures differ"]
    mism = []
    for (path, la), (_, lb) in zip(flat_a, flat_b):
        key = "/".join(str(p) for p in path)
        xa = _host(la).astype(np.float32)
        xb = _host(lb).astype(np.float32)
        if xa.shape != xb.shape:
            mism.append(f"{key}: shape {xa.shape} vs {xb.shape}")
        elif not np.allclose(xa, xb, rtol=rtol, atol=atol):
            mism.append(f"{key}: max abs diff {np.abs(xa - xb).max():.3e}")
    return mism
