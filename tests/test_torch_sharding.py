"""The port's partition rules against the JAX package's.

For every GPT parameter path under ``fsdp_rules`` and ``gpt_tp_rules``
on the meshes (data, fsdp, tensor) = (2, 2, 2), (1, 4, 1) and
(1, 2, 2), the port's placements (pure functions of the path, the
shape and the mesh shape; no process group) equal the specs of the
reference's ``sharding_tree`` on the 8-device CPU mesh, read as one
placement per mesh axis.  The GPT shapes are the tiny config, the tiny
config with a vocab of 250 (a dim the axes do not divide: replicated)
and GPT-2 small (``jax.eval_shape`` and the ``meta`` device: no
memory).
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from dlrover_tpu_torch.models import gpt as port_gpt
from dlrover_tpu_torch.parallel import mesh as port_mesh
from dlrover_tpu_torch.parallel import registry as port_registry
from dlrover_tpu_torch.parallel import sharding as port_sharding

MESHES = [(2, 2, 2), (1, 4, 1), (1, 2, 2)]
CONFIGS = {
    "tiny": dict(),
    "tiny_vocab250": dict(vocab_size=250),
    "gpt2_small": dict(num_layers=12, num_heads=12, hidden_dim=768,
                       vocab_size=50304, max_seq_len=1024),
}
RULES = ["fsdp_rules", "gpt_tp_rules", "replicated_rules"]


def _jax_specs(cfg_kw, mesh_shape, rules_name):
    """{flax path: spec} from the reference's ``sharding_tree`` over the
    GPT's abstract params."""
    import jax

    from dlrover_tpu.models import gpt as jax_gpt
    from dlrover_tpu.parallel import sharding as jax_sharding
    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh

    d, f, t = mesh_shape
    mesh = build_mesh(MeshConfig(data=d, fsdp=f, tensor=t),
                      devices=jax.devices()[:d * f * t])
    model = jax_gpt.GPT(jax_gpt.GPTConfig.tiny(**cfg_kw))
    shapes = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    tree = jax_sharding.sharding_tree(
        shapes, mesh, getattr(jax_sharding, rules_name)())
    flat = jax.tree_util.tree_leaves_with_path(tree)
    return {
        "/".join(jax_sharding._key_str(k) for k in path): tuple(s.spec)
        for path, s in flat
    }, dict(mesh.shape)


def _as_placements(spec):
    out = []
    for axis in port_mesh.TORCH_AXES:
        dims = [i for i, e in enumerate(spec) if e is not None and axis in (
            e if isinstance(e, tuple) else (e,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@pytest.mark.parametrize("rules_name", RULES)
@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_placements_equal_the_reference_specs(cfg, mesh_shape, rules_name):
    specs, jax_mesh_shape = _jax_specs(CONFIGS[cfg], mesh_shape, rules_name)
    d, f, t = mesh_shape
    sizes = port_mesh.MeshConfig(data=d, fsdp=f, tensor=t).axis_sizes(
        d * f * t)
    assert sizes == jax_mesh_shape
    model = port_gpt.GPT(port_gpt.GPTConfig.tiny(**CONFIGS[cfg]),
                         device="meta")
    got = port_sharding.param_placements(
        model, sizes, getattr(port_sharding, rules_name)())
    from dlrover_tpu_torch.utils.convert import flax_path

    by_path = {"/".join(flax_path(n)): pl for n, pl in got.items()}
    assert set(by_path) == set(specs)
    for path, spec in specs.items():
        assert by_path[path] == _as_placements(spec), (path, spec)


def test_rule_sets_and_batch_spec_are_the_references():
    from dlrover_tpu.parallel import sharding as jax_sharding

    for name in ("fsdp_rules", "gpt_tp_rules", "replicated_rules",
                 "pipeline_rules", "moe_rules"):
        mine, ref = (getattr(m, name)() for m in (port_sharding,
                                                   jax_sharding))
        assert mine.rules == ref.rules and mine.default == ref.default, name
    for seq in (False, True):
        assert port_sharding.batch_spec(seq) == tuple(
            jax_sharding.batch_spec(seq))


@pytest.mark.parametrize("spec,shape,mesh,want", [
    # an axis the mesh lacks is replicated
    (("fsdp", "nope"), (8, 8), {"fsdp": 2}, ("fsdp", None)),
    # a dim the axes do not divide is replicated
    (("fsdp",), (7, 4), {"fsdp": 2}, (None,)),
    # two axes on one dim
    ((("data", "fsdp"),), (8,), {"data": 2, "fsdp": 2}, (("data", "fsdp"),)),
    # the spec cut to the tensor's rank
    (("fsdp", None, "tensor"), (4, 4), {"fsdp": 2, "tensor": 2},
     ("fsdp", None)),
])
def test_fit_spec_matches_the_reference(spec, shape, mesh, want):
    import jax

    from dlrover_tpu.parallel import sharding as jax_sharding

    assert port_sharding.fit_spec(spec, shape, mesh) == want

    class _Mesh:  # the reference reads only mesh.shape
        def __init__(self, shape):
            self.shape = shape

    ref = jax_sharding._fit_spec(jax.sharding.PartitionSpec(*spec), shape,
                                 _Mesh(mesh))
    assert tuple(ref) == want


def test_batch_shard_splits_over_data_then_fsdp():
    """Rank (data i, fsdp j) of a (2, 2, 2) mesh takes rows
    ``(2 i + j) * 2 : +2`` of an 8-row batch; tensor ranks share them."""
    batch = {"x": np.arange(16).reshape(8, 2)}
    for (di, fi, ti) in [(0, 0, 0), (0, 1, 1), (1, 0, 0), (1, 1, 1)]:
        class _M:
            shape = {"data": 2, "fsdp": 2, "tensor": 2}

            @staticmethod
            def coordinate():
                return {"data": di, "fsdp": fi, "tensor": ti}

        rows = port_sharding.batch_shard(batch, _M)["x"][:, 0] // 2
        k = 2 * di + fi
        assert list(rows) == [2 * k, 2 * k + 1]


def test_mesh_axis_sizes_and_node_split_match_the_reference():
    from dlrover_tpu.parallel import mesh as jax_mesh

    for cfg in ({}, {"fsdp": 4}, {"fsdp": 2, "tensor": 2},
                {"data": 2, "fsdp": -1}):
        for n in (4, 8):
            mine = port_mesh.MeshConfig(**cfg).axis_sizes(n)
            assert mine == jax_mesh.MeshConfig(**cfg).axis_sizes(n)
            for nodes in (1, 2):
                try:
                    want = jax_mesh.split_axes_dcn_ici(mine, nodes)
                except ValueError:
                    with pytest.raises(ValueError):
                        port_mesh.split_axes_dcn_ici(mine, nodes)
                    continue
                assert port_mesh.split_axes_dcn_ici(mine, nodes) == want
    with pytest.raises(ValueError, match="only one axis"):
        port_mesh.MeshConfig(data=-1, fsdp=-1).axis_sizes(4)


def test_one_device_without_a_group_shards_nothing():
    mesh = port_mesh.build_mesh(port_mesh.MeshConfig(fsdp=-1, data=1),
                                device_type="cpu")
    assert mesh.shape["fsdp"] == 1 and not mesh.distributed
    assert mesh.coordinate() == {a: 0 for a in port_mesh.AXES}
    # the pipeline axis builds since slice 5.3: two ranks need a group
    with pytest.raises(ValueError, match="process group"):
        port_mesh.build_mesh(port_mesh.MeshConfig(data=-1, pipeline=2),
                             world_size=2, device_type="cpu")
    with pytest.raises(ValueError, match="process group"):
        port_mesh.build_mesh(port_mesh.MeshConfig(fsdp=2, data=1),
                             world_size=2, device_type="cpu")


def test_registry_resolves_families_like_the_reference():
    class Custom(torch.nn.Module):
        pass

    rules = port_sharding.PartitionRules(rules=[(r"special", ("tensor",))])
    assert port_registry.rules_for_model(Custom()).rules == \
        port_sharding.gpt_tp_rules().rules
    port_registry.register_tp_rules("Custom", rules)
    try:
        assert port_registry.rules_for_model(Custom()) is rules
        assert "custom" in port_registry.registered_families()
    finally:
        port_registry.unregister_tp_rules("Custom")
    assert port_registry.rules_for_model(None, use_moe=True).rules == \
        port_sharding.moe_rules().rules
