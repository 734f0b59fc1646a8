"""Low-bit optimizer state of the port under every placement, against
the JAX package's ``q_adamw`` on the whole arrays.

The reference quantizes each leaf flattened whole in blocks of
``block_size``, whatever GSPMD does with its shards.  The port keeps
that global grid over DTensor shards: a column-parallel shard
(``Shard(1)``) or an fsdp x tensor shard holds pieces of blocks that
other ranks share, and its split-block step reduces each block's
absmax over them (``optim/low_bit.py``, ``PieceGrid``).

- In one process: the split-block plain versions of B4, B5 and B6 over
  the pieces of simulated shards (tensor 2 and fsdp 2 x tensor 2
  boxes), max-reduced by block, against the whole-block plain versions
  on the whole tensor: codes, scales and the parameter bit for bit.
- On four gloo ranks (one spawn for the file): int8 and 4-bit q-AdamW
  over DTensors placed at tensor 2 (column ``Shard(1)``, row
  ``Shard(0)``, a replicated bias) and at fsdp 2 x tensor 2 (the same
  modules wrapped in FSDP2 over the tensor-parallel placements), two
  steps on the same numpy params and gradients as the reference's
  ``q_adamw`` under ``jax.jit`` and as the port's own q-AdamW on the
  whole (plain) tensors.  Every leaf's codes, scales and parameter,
  gathered onto the global grid, equal the unsharded port's bit for
  bit, and the ranks that share a block hold one scale of it.  Against
  the reference: the codes are equal, the scales within ``SCALE_RTOL``
  (XLA's own roundings move a scale by up to 2 ulps, the unsharded
  port's too), fp32 parameters within 1e-5 and bf16 ones within one
  bf16 ulp.
"""

import os
import pickle
import sys

import numpy as np
import pytest

BLOCK = 64
STEPS = 2
LR = 1e-2
# XLA rounds the reference's moments differently from the port's one
# rounding per operation (contractions into FMAs): a block's scale
# differs by up to 2 fp32 ulps, unsharded too
SCALE_RTOL = 5e-7
# name -> (shape, dtype, tensor-parallel placement on the tensor axis)
TREE = {
    "col": ((24, 40), "float32", "Shard(1)"),
    "col_bf16": ((18, 22), "bfloat16", "Shard(1)"),
    "row": ((40, 18), "float32", "Shard(0)"),
    "bias": ((38,), "float32", "Replicate()"),
}
CASES = [(mesh, bits) for mesh in ("tensor2", "fsdp2_tensor2")
         for bits in (8, 4)]


def _tree_arrays(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(shape).astype(np.float32)
              for k, (shape, _, _) in TREE.items()}
    grads = [{k: rng.standard_normal(shape).astype(np.float32)
              for k, (shape, _, _) in TREE.items()} for _ in range(STEPS)]
    return params, grads


# -- one process: split-block plain versions against whole-block ones ----------


def _boxes(shape, splits):
    """The boxes of ranks cutting ``shape`` in ``splits[d]`` chunks on
    dim d (torch.chunk), row-major over the ranks."""
    import itertools

    per_dim = []
    for n, k in zip(shape, splits):
        c = -(-n // k)
        per_dim.append([(min(i * c, n), min((i + 1) * c, n))
                        for i in range(k)])
    return list(itertools.product(*per_dim))


@pytest.mark.parametrize("splits", [(1, 2), (2, 2), (2, 1)],
                         ids=["tensor2_col", "fsdp2_tensor2", "row2"])
def test_split_block_plain_versions_match_whole_blocks(splits):
    import torch

    from dlrover_tpu_torch.ops import quantization as pq
    from dlrover_tpu_torch.optim.low_bit import box_pieces

    shape = (30, 45)
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    total = -(-p.numel() // BLOCK)
    # whole-block plain versions (the state from a moment drawn at random)
    q_mu, mu_s, _ = pq.quantize_blockwise(m, BLOCK)
    q_nu, nu_s, _ = pq.quantize_blockwise(m.abs().sqrt(), BLOCK)
    whole = [t.clone() for t in (p, q_mu, mu_s, q_nu, nu_s)]
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, lr=LR, wd=0.1)
    pq.fused_qadam_update_(whole[0], g, *whole[1:], bc1=0.19, bc2=0.002,
                           **hyper)
    want_q4, want_s4, _ = pq.quantize_blockwise(m, BLOCK, qmax=7.0)

    shards, amax, amax4 = [], torch.zeros(total, 2), torch.zeros(total)
    for box in _boxes(shape, splits):
        sl = tuple(slice(a, b) for a, b in box)
        table, blocks, starts = box_pieces(shape, box, BLOCK)
        layout = pq.PieceLayout(table, int(np.prod([b - a for a, b in box])),
                                len(blocks))
        flat = torch.from_numpy(np.concatenate(
            [np.arange(s, s + n) for s, n in zip(starts, table["len"])]))
        local = [p[sl].reshape(-1).clone(), g[sl].reshape(-1).clone(),
                 q_mu.reshape(-1)[flat].clone(), mu_s[blocks].clone(),
                 q_nu.reshape(-1)[flat].clone(), nu_s[blocks].clone()]
        # B5 split mode against the whole-block dequantize
        deq = pq.dequantize_pieces(local[2], local[3], layout)
        assert torch.equal(deq, pq.dequantize_blockwise(
            q_mu, mu_s, shape)[sl].reshape(-1))
        a = pq.qadam_split_absmax(*local, layout, 0.19, 0.002, **hyper)
        idx = torch.from_numpy(blocks)
        amax[idx] = torch.maximum(amax[idx], a)
        a4 = pq.absmax_pieces(m[sl].reshape(-1), layout)
        amax4[idx] = torch.maximum(amax4[idx], a4)
        shards.append((sl, flat, layout, blocks, local))
    for sl, flat, layout, blocks, local in shards:
        idx = torch.from_numpy(blocks)
        new_mu, new_nu = pq.qadam_split_apply(
            *local, layout, amax[idx], 0.19, 0.002, **hyper)
        assert torch.equal(local[0], whole[0][sl].reshape(-1))
        assert torch.equal(local[2], whole[1].reshape(-1)[flat])
        assert torch.equal(local[4], whole[3].reshape(-1)[flat])
        assert torch.equal(new_mu, whole[2][idx])
        assert torch.equal(new_nu, whole[4][idx])
        # B4 split mode (4-bit's qmax) against the whole-block quantize
        q4, s4 = pq.quantize_pieces(m[sl].reshape(-1), layout, amax4[idx],
                                    qmax=7.0)
        assert torch.equal(q4, want_q4.reshape(-1)[flat])
        assert torch.equal(s4, want_s4[idx])


# -- four gloo ranks against the reference -------------------------------------


def _placement(text):
    from torch.distributed.tensor import Replicate, Shard  # noqa: F401

    return eval(text)


def _worker(rank, world, port, in_path, out_path):
    import torch
    import torch.distributed as dist
    from torch import nn
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    from dlrover_tpu_torch.optim.low_bit import PieceGrid, q_adamw

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("fsdp", "tensor"))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def local_of(p, global_array):
        shape, offset = compute_local_shape_and_global_offset(
            p.shape, p.device_mesh, p.placements)
        sl = tuple(slice(o, o + n) for o, n in zip(offset, shape))
        return torch.from_numpy(global_array[sl].copy()).to(p.dtype)

    results = {}
    for mesh_name, bits in job["cases"]:
        module = nn.Module()
        for k, (shape, dt, pl) in TREE.items():
            t = torch.from_numpy(job["params"][k].copy()).to(dtypes[dt])
            module.register_parameter(k, nn.Parameter(distribute_tensor(
                t, mesh["tensor"], [_placement(pl)])))
        if mesh_name == "fsdp2_tensor2":
            fully_shard(module, mesh=mesh["fsdp"])
        params = dict(module.named_parameters())
        placements = {k: str(p.placements) for k, p in params.items()}
        for k, p in params.items():
            with torch.no_grad():
                p.to_local().copy_(local_of(p, job["params"][k]))
            full = p.full_tensor().detach().float().numpy()
            want = job["params"][k].astype(
                np.float32 if TREE[k][1] == "float32" else np.float32)
            if TREE[k][1] == "bfloat16":
                want = torch.from_numpy(want).bfloat16().float().numpy()
            assert np.array_equal(full, want), (k, placements[k])
        opt = q_adamw(list(params.values()), lr=LR, weight_decay=0.1,
                      block_size=BLOCK, bits=bits)
        for step in range(STEPS):
            for k, p in params.items():
                g = local_of(p, job["grads"][step][k])
                p.grad = DTensor.from_local(g, p.device_mesh, p.placements,
                                            shape=p.shape, stride=p.stride())
            opt.step()
        mine = {}
        for k, p in params.items():
            st, grid = opt.state[p], opt._layout(p)
            n = p.to_local().numel()
            codes = {}
            for m in ("mu", "nu"):
                v = st[f"{m}_values"]
                if bits == 4:
                    v = torch.stack([v & 0xF, (v >> 4) & 0xF],
                                    -1).reshape(-1)
                v = v.reshape(-1)
                if isinstance(grid, PieceGrid):
                    flat = np.concatenate([
                        np.arange(s, s + ln) for s, ln in
                        zip(grid.starts, grid.layout.table["len"])])
                    codes[m] = (flat, v[:n].numpy().astype(np.int32),
                                grid.blocks,
                                st[f"{m}_scales"].reshape(-1).numpy())
                else:  # ShardGrid: codes at their global column
                    off = grid.start - grid.row0 * BLOCK
                    codes[m] = (np.arange(grid.start, grid.start + n),
                                v[off:off + n].numpy().astype(np.int32),
                                np.arange(grid.row0, grid.row0 + grid.rows),
                                st[f"{m}_scales"].reshape(-1).numpy())
            mine[k] = {"codes": codes, "layout": type(grid).__name__,
                       "param": p.full_tensor().detach().float().numpy()}
        gathered = [None] * world
        dist.all_gather_object(gathered, mine)
        results[(mesh_name, bits)] = {"ranks": gathered,
                                      "placements": placements}
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)


def _reference(bits, params, grads):
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.optim import low_bit as jlb

    dts = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    jp = {k: jnp.asarray(v, dts[TREE[k][1]]) for k, v in params.items()}
    opt = jlb.q_adamw(LR, weight_decay=0.1, block_size=BLOCK, bits=bits)
    state = opt.init(jp)

    @jax.jit
    def step(g, state, p):
        upd, state = opt.update(g, state, p)
        return optax.apply_updates(p, upd), state

    for g in grads:
        jp, state = step({k: jnp.asarray(v, jp[k].dtype)
                          for k, v in g.items()}, state, jp)
    out = {}
    for k in TREE:
        out[k] = {"param": np.asarray(jp[k].astype(jnp.float32))}
        for m in ("mu", "nu"):
            q = getattr(state, m)[k]
            values = np.asarray(q.values)
            if bits == 4:  # the raw nibbles, element 2i low
                values = np.stack([values & 0xF, (values >> 4) & 0xF], -1)
            out[k][m] = (values.reshape(-1).astype(np.int32),
                         np.asarray(q.scales, np.float32).reshape(-1))
    return out


def _port_whole(bits, params, grads):
    """The port's q-AdamW on the whole (plain) tensors: codes as raw
    nibbles at 4 bits, scales and params."""
    import torch

    from dlrover_tpu_torch.optim.low_bit import q_adamw

    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(
        dts[TREE[k][1]])) for k, v in params.items()}
    opt = q_adamw(list(ps.values()), lr=LR, weight_decay=0.1,
                  block_size=BLOCK, bits=bits)
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k]).to(p.dtype)
        opt.step()
    out = {}
    for k, p in ps.items():
        st = opt.state[p]
        out[k] = {"param": p.detach().float().numpy()}
        for m in ("mu", "nu"):
            v = st[f"{m}_values"]
            if bits == 4:
                v = torch.stack([v & 0xF, (v >> 4) & 0xF], -1)
            out[k][m] = (v.reshape(-1).numpy().astype(np.int32),
                         st[f"{m}_scales"].reshape(-1).numpy())
    return out


@pytest.fixture(scope="module")
def runs():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_gloo import spawn

    params, grads = _tree_arrays()
    port = spawn({"params": params, "grads": grads, "cases": CASES},
                 os.path.abspath(__file__), world=4)
    want = {bits: _reference(bits, params, grads) for bits in (8, 4)}
    whole = {bits: _port_whole(bits, params, grads) for bits in (8, 4)}
    return port, want, whole


@pytest.mark.parametrize("case", CASES, ids=[f"{m}_int{b}"
                                             for m, b in CASES])
def test_qadamw_state_is_the_references_under_placements(runs, case):
    port, want, whole = runs
    mesh_name, bits = case
    got = port[case]
    for k, (shape, dt, _) in TREE.items():
        numel = int(np.prod(shape))
        ref, mine = want[bits][k], whole[bits][k]
        for m in ("mu", "nu"):
            codes = np.full(numel, -999, np.int64)
            scales = np.full(-(-numel // BLOCK), np.nan, np.float32)
            for rank in got["ranks"]:
                flat, v, blocks, s = rank[k]["codes"][m]
                codes[flat] = v
                seen = ~np.isnan(scales[blocks])
                # the ranks that share a block hold one scale of it
                assert np.array_equal(scales[blocks][seen], s[seen]), k
                scales[blocks] = s
            # the unsharded port's step, bit for bit
            assert np.array_equal(codes, mine[m][0][:numel]), (
                k, m, got["placements"][k])
            assert np.array_equal(scales, mine[m][1]), (
                k, m, got["placements"][k])
            # the reference's codes; its scales to XLA's rounding
            ref_codes, ref_scales = ref[m]
            assert np.array_equal(codes, ref_codes[:numel]), (
                k, m, got["placements"][k],
                int((codes != ref_codes[:numel]).sum()))
            np.testing.assert_allclose(scales, ref_scales, rtol=SCALE_RTOL,
                                       err_msg=f"{k} {m}")
        param = got["ranks"][0][k]["param"]
        assert np.array_equal(param, mine["param"]), k
        if dt == "float32":
            np.testing.assert_allclose(param, ref["param"], atol=1e-5,
                                       err_msg=k)
        else:
            ulp = np.spacing(np.abs(ref["param"])) * 2.0 ** 16
            assert (np.abs(param - ref["param"]) <= ulp).all(), k
    # the placements that need the split-block mode took it
    layouts = got["ranks"][0]
    assert layouts["col"]["layout"] == "PieceGrid"
    if mesh_name == "fsdp2_tensor2":
        assert "," in got["placements"]["col"]  # two mesh dims


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, sys.argv[5], sys.argv[6])
