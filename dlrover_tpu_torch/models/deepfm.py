"""DeepFM for sparse recsys workloads (criteo-class).

Copy of ``dlrover_tpu/models/deepfm.py`` (reference workload: DLRover's
system tests train criteo DeepFM/DeepRec jobs on TFPlus KvVariable
embeddings, ``.github/workflows/main.yml``
dlrover-system-test-criteo-*).  The model is split at the sparse/dense
boundary:

- sparse features -> :class:`~dlrover_tpu_torch.ops.kv_variable.KvVariable`
  host table (dynamic vocab, frequency counters), gathered on the host
  and copied to the card;
- the FM interaction and the deep tower are a :class:`DenseTower`
  ``nn.Module`` on the card (or on ``device="cpu"`` when the caller
  asks), its weights in the flax layout (``dense_i.weight`` is the
  reference's ``dense_i/w``, ``[in, out]``; ``dense_i.bias`` its
  ``b``), so :func:`~dlrover_tpu_torch.utils.convert.deepfm_dense_from_jax`
  loads the JAX package's pytree one to one and the port's
  ``train_state_tree`` checkpoints it like any other module;
- embedding gradients come back to the host and the C++ group optimizer
  updates only the touched keys.

The JAX package computes the tower in plain ``jnp`` outside any Pallas
kernel, so ATen's matmuls serve it here.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.ops.kv_variable import GroupAdamOptimizer, KvVariable


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor):
    """Numerically-stable binary cross entropy with logits, the
    reference's formula term for term (``max(l, 0) - l*y +
    log1p(exp(-|l|))``, averaged)."""
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


@dataclass(frozen=True)
class DeepFMConfig:
    num_sparse_fields: int = 26
    num_dense_features: int = 13
    embedding_dim: int = 16
    hidden_dims: Tuple[int, ...] = (128, 64)
    seed: int = 0

    @property
    def tower_dims(self) -> Tuple[int, ...]:
        """Widths of the deep tower, input first: the dense features
        beside every field's embedding, the hidden layers, one logit."""
        return ((self.num_dense_features
                 + self.num_sparse_fields * self.embedding_dim,)
                + tuple(self.hidden_dims) + (1,))


class _Dense(nn.Module):
    """``h @ weight + bias`` with ``weight`` in the flax layout
    ``[in, out]``."""

    def __init__(self, din: int, dout: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(din, dout, device=device))
        self.bias = nn.Parameter(torch.zeros(dout, device=device))

    def forward(self, h):
        return h @ self.weight + self.bias


class DenseTower(nn.Module):
    """The device half of DeepFM: FM second-order interaction plus the
    ReLU tower over ``[dense_x, flattened embeddings]``; the logit is
    their sum.  Layers are named ``dense_i`` like the reference's
    pytree."""

    def __init__(self, config: DeepFMConfig, device, gen: torch.Generator):
        super().__init__()
        dims = config.tower_dims
        self.num_layers = len(dims) - 1
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            layer = _Dense(din, dout, device)
            # the reference's He-normal draw: normal * sqrt(2 / din)
            with torch.no_grad():
                layer.weight.normal_(generator=gen).mul_(
                    (2.0 / din) ** 0.5)
            self.add_module(f"dense_{i}", layer)

    def forward(self, emb: torch.Tensor, dense_x: torch.Tensor):
        """emb ``[b, fields, dim]``, dense_x ``[b, num_dense]`` ->
        logits ``[b]``."""
        sum_emb = emb.sum(dim=1)
        fm = 0.5 * ((sum_emb ** 2).sum(-1) - (emb ** 2).sum(dim=(1, 2)))
        h = torch.cat([dense_x, emb.reshape(emb.shape[0], -1)], dim=-1)
        for i in range(self.num_layers):
            h = getattr(self, f"dense_{i}")(h)
            if i < self.num_layers - 1:
                h = torch.relu(h)
        return h[:, 0] + fm


class DeepFM:
    """Hybrid host-sparse / device-dense model.

    ``dense`` is the :class:`DenseTower` on ``device`` (the card unless
    the caller names another; without a card it raises), drawn from a
    ``torch.Generator`` seeded with ``config.seed``; the sparse table
    and its GroupAdam live on the host.
    """

    def __init__(self, config: DeepFMConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.device = resolve_device(device)
        self.table = KvVariable(
            dim=config.embedding_dim, seed=config.seed, name="deepfm"
        )
        self.sparse_optimizer = GroupAdamOptimizer(
            self.table, learning_rate=1e-2
        )
        gen = torch.Generator(device=self.device).manual_seed(config.seed)
        self.dense = DenseTower(config, self.device, gen)

    def gather_embeddings(self, sparse_ids: np.ndarray) -> np.ndarray:
        """[batch, fields] int64 -> [batch, fields, dim] f32 (host)."""
        b, f = sparse_ids.shape
        flat = self.table.gather(sparse_ids.reshape(-1))
        return flat.reshape(b, f, self.config.embedding_dim)

    def apply(self, emb: torch.Tensor, dense_x: torch.Tensor):
        """Device-side forward: logits ``[b]``."""
        return self.dense(emb, dense_x)

    def loss_and_grads(self, sparse_ids, dense_x, labels):
        """One hybrid step's gradients: ``(loss, dense_grads,
        embedding_grads)``, the dense gradients by parameter name
        (``dense_i.weight``), the embedding gradients ``[b, fields, dim]``
        on the host.  The module's ``.grad`` fields are left as they
        were."""
        emb = torch.from_numpy(self.gather_embeddings(sparse_ids)).to(
            self.device).requires_grad_(True)
        dense_x = torch.as_tensor(dense_x, device=self.device)
        labels = torch.as_tensor(labels, device=self.device)
        params = dict(self.dense.named_parameters())
        loss = bce_with_logits(self.apply(emb, dense_x), labels)
        grads = torch.autograd.grad(loss, [emb, *params.values()])
        dense_grads: Dict[str, torch.Tensor] = dict(zip(params, grads[1:]))
        return loss.detach(), dense_grads, grads[0].cpu().numpy()

    def apply_sparse_gradients(self, sparse_ids, emb_grads):
        b, f = sparse_ids.shape
        self.sparse_optimizer.apply_gradients(
            sparse_ids.reshape(-1),
            np.asarray(emb_grads).reshape(b * f, self.config.embedding_dim),
        )

    # -- checkpoint --------------------------------------------------------

    def save_table(self, storage, path: str):
        """Persist the sparse table (reference: KvVariable export ops
        feeding TF checkpoints); the pickle is the JAX package's."""
        import pickle

        keys, values, freq = self.table.export()
        storage.write(
            pickle.dumps(
                {"keys": keys, "values": values, "freq": freq,
                 "dim": self.config.embedding_dim}
            ),
            path,
        )

    def load_table(self, storage, path: str) -> bool:
        import pickle

        raw = storage.read(path)
        if raw is None:
            return False
        data = pickle.loads(raw)
        self.table.import_(data["keys"], data["values"], data["freq"])
        return True
