"""Quantization kernels of the PyTorch port against the JAX package.

The same numpy inputs go through the JAX functions (the Pallas kernels
in interpret mode, each under ``jax.jit`` as training runs them) and
the port's plain versions, the code the port runs on the CPU and holds
its CUDA kernels against on the card.  Tolerances and their reasons:

- scales within rtol 1e-6; in practice equal, since both sides take a
  row's absmax times fp32(1/qmax);
- int8 codes identical, except that at most 1 in 10^4 may differ by
  exactly 1: XLA's CPU backend contracts ``b1 * mu + (1 - b1) * g``
  (and nu's sum) into FMAs, which the port does not, so a moment can
  differ by an ulp and land on the other side of a .5 boundary.  The
  quantize and dequantize kernels have no such sum and are exact;
- the fp32 update within atol 1e-6, rtol 1e-5 (the same FMAs); a bf16
  update within one bf16 ulp, in at most 1 in 10^3 elements (the fp32
  update differs by a few ulps, and each crosses a bf16 rounding
  boundary with probability 2^-16);
- 4-bit packing and the sqrt-domain 4-bit codec byte-exact.

The CUDA kernels themselves are held against the plain versions on
the card by the ``cuda``-marked tests here and by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import quantization as jq
from dlrover_tpu_torch.ops import quantization as pq

HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-3, wd=0.01)
# (rows, block): rows no multiple of the reference's 128-row tile
SHAPES = [(37, 64), (130, 128), (21, 2048)]
TIE_SCALE = 2.0 ** -10


def _tiles(rows, block, seed=0):
    """Rows of random magnitudes, one all-zero row, and one row of
    exact .5 ties: its absmax is qmax * 2^-10, so its scale is 2^-10
    and every other element is an odd multiple of half a code."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, block)) * rng.uniform(1e-4, 10, (rows, 1))
    x[1] = 0.0
    return x.astype(np.float32)


def _tie_row(x, qmax):
    block = x.shape[1]
    k = np.arange(block) % int(qmax)  # k + .5 ties between codes k, k + 1
    sign = np.where(np.arange(block) % 3 == 0, -1.0, 1.0)
    x[2] = sign * (k + 0.5) * TIE_SCALE
    x[2, 0] = qmax * TIE_SCALE
    return x


def _as(x, dtype):
    if dtype == "bfloat16":
        return (jnp.asarray(x, jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


def code_mismatches(got, want):
    """Count of codes that differ; fails if any differs by more than 1
    or more than 1 in 10^4 differ."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1
    n = int((diff != 0).sum())
    assert n <= max(1, got.size // 10_000), f"{n} of {got.size} codes differ"
    return n


@pytest.mark.parametrize("rows,block", SHAPES)
@pytest.mark.parametrize("qmax", [127.0, 7.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax(rows, block, qmax, dtype):
    x = _tie_row(_tiles(rows, block), qmax)
    jx, tx = _as(x, dtype)
    jcodes, jscales = jq._quantize_tiles(jx, block, qmax)
    codes, scales = pq.quantize_plain(tx, qmax)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert scales[2, 0].item() == TIE_SCALE  # the tie row is exact
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales),
                               rtol=1e-6)
    assert code_mismatches(codes.numpy(), jcodes) == 0
    # zero row: scale floor, zero codes; ties round half to even
    assert scales[1, 0].item() == np.float32(1e-12)
    assert not codes[1].any()
    want_ties = np.clip(np.round(x[2] / TIE_SCALE), -qmax, qmax)
    np.testing.assert_array_equal(codes[2].numpy(), want_ties)


@pytest.mark.parametrize("rows,block", SHAPES)
def test_dequantize_matches_jax(rows, block):
    rng = np.random.default_rng(1)
    codes = rng.integers(-127, 128, (rows, block), dtype=np.int8)
    scales = rng.uniform(1e-6, 1.0, (rows, 1)).astype(np.float32)
    want = np.asarray(jq._dequantize_tiles(jnp.asarray(codes),
                                           jnp.asarray(scales)))
    got = pq.dequantize_plain(torch.from_numpy(codes),
                              torch.from_numpy(scales))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,block", [((1000,), 64), ((33, 7), 128),
                                         ((3, 5000), 2048)])
def test_blockwise_round_trip_matches_jax(shape, block):
    """``quantize_blockwise`` pads a ragged leaf to whole rows with
    zeros; ``dequantize_blockwise`` cuts it back."""
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jcodes, jscales, _ = jax.jit(jq.quantize_blockwise,
                                 static_argnums=1)(jnp.asarray(x), block)
    codes, scales, got_shape = pq.quantize_blockwise(torch.from_numpy(x),
                                                     block)
    assert got_shape == shape
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    np.testing.assert_array_equal(
        pq.dequantize_blockwise(codes, scales, shape).numpy(),
        np.asarray(jq.dequantize_blockwise(jcodes, jscales, shape)),
    )
    np.testing.assert_array_equal(
        pq.to_block_tiles(torch.from_numpy(x), block).numpy(),
        np.asarray(jq.to_block_tiles(jnp.asarray(x), block)),
    )


def qadam_pair(rows, block, dtype, count=3, seed=3):
    """(port, JAX) outputs of one fused quantized-Adam step on the same
    tiles, moments and bias corrections."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((rows, block)) * 1e-2).astype(np.float32)
    p = rng.standard_normal((rows, block)).astype(np.float32)
    g[1] = p[1] = 0.0  # zero row: zero moments, scale floor
    mu = (rng.standard_normal((rows, block)) * 1e-3).astype(np.float32)
    nu = (rng.standard_normal((rows, block)) ** 2 * 1e-5).astype(np.float32)
    qm, ms = jq._quantize_tiles(jnp.asarray(mu), block, 127.0)
    qn, ns = jq._quantize_tiles(jnp.sqrt(jnp.asarray(nu)), block, 127.0)
    qm, ms, qn, ns = (np.array(a) for a in (qm, ms, qn, ns))
    qm[1] = qn[1] = 0
    bc1, bc2 = pq.bias_corrections(HYPER["b1"], HYPER["b2"], count)
    jg, tg = _as(g, dtype)
    jp, tp = _as(p, dtype)
    want = jq.fused_qadam_step(
        jg, jp, jnp.asarray(qm), jnp.asarray(ms), jnp.asarray(qn),
        jnp.asarray(ns), jnp.asarray([[bc1, bc2]], jnp.float32), **HYPER,
    )
    got = pq.fused_qadam_step_plain(
        tg, tp, *(torch.from_numpy(a) for a in (qm, ms, qn, ns)), bc1, bc2,
        **HYPER,
    )
    return ([t.float().numpy() for t in got],
            [np.asarray(jnp.asarray(w, jnp.float32)) for w in want])


@pytest.mark.parametrize("rows,block", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qadam_step_matches_jax(rows, block, dtype):
    (upd, qm, ms, qn, ns), (jupd, jqm, jms, jqn, jns) = qadam_pair(
        rows, block, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(upd, jupd, atol=1e-6, rtol=1e-5)
    else:
        ulp = np.spacing(np.abs(jupd)) * 2.0 ** 16
        off = np.abs(upd - jupd) > 0
        assert (np.abs(upd - jupd) <= ulp).all()
        assert off.sum() <= max(1, upd.size // 1_000)
    for got, want in ((ms, jms), (ns, jns)):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    print(f"qadam {rows}x{block} {dtype}: codes off by one: mu "
          f"{code_mismatches(qm, jqm)}, nu {code_mismatches(qn, jqn)} of "
          f"{qm.size}")
    assert not qm[1].any() and not qn[1].any()
    assert ms[1, 0] == ns[1, 0] == np.float32(1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_blocks_match_jax(dtype):
    """A block of 16384, past the 8192 that the CUDA kernels hold in
    registers: the plain versions, which the two-pass kernels are held
    to, against the JAX package."""
    rows, block = 3, 16384
    x = _tie_row(_tiles(rows, block), 127.0)
    jx, tx = _as(x, dtype)
    jcodes, jscales = jq._quantize_tiles(jx, block, 127.0)
    codes, scales = pq.quantize_plain(tx, 127.0)
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales),
                               rtol=1e-6)
    assert code_mismatches(codes.numpy(), jcodes) == 0
    np.testing.assert_array_equal(
        pq.dequantize_plain(codes, scales).numpy(),
        np.asarray(jq._dequantize_tiles(jcodes, jscales)))
    (upd, qm, ms, qn, ns), (jupd, jqm, jms, jqn, jns) = qadam_pair(
        rows, block, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(upd, jupd, atol=1e-6, rtol=1e-5)
    else:
        ulp = np.spacing(np.abs(jupd)) * 2.0 ** 16
        assert (np.abs(upd - jupd) <= ulp).all()
        assert (np.abs(upd - jupd) > 0).sum() <= max(1, upd.size // 1_000)
    for got, want in ((ms, jms), (ns, jns)):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    code_mismatches(qm, jqm)
    code_mismatches(qn, jqn)


def test_bias_corrections_match_jax():
    counts = jnp.arange(1, 41, dtype=jnp.int32)
    want = jax.jit(lambda c: jnp.stack(
        [1 - 0.9 ** c.astype(jnp.float32),
         1 - 0.999 ** c.astype(jnp.float32)], axis=-1))(counts)
    got = [pq.bias_corrections(0.9, 0.999, int(c)) for c in counts]
    # the port raises b to the count with numpy's powf, the reference
    # with XLA's pow; the two may differ by one ulp of b**count (2^-24
    # just under 1), which the update sees as ~3e-6 relative at most
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want),
                               rtol=0, atol=2.0 ** -24)


@pytest.mark.parametrize("shape,block", [((1000,), 64), ((17, 9), 128)])
def test_4bit_codecs_byte_exact(shape, block):
    """The 4-bit packing around the quantize/dequantize kernels and the
    sqrt-domain 4-bit codec (plain tensor ops on both sides), under
    ``jax.jit`` as the reference's training step runs them."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    sq = x * x
    for jfn, pfn, arg in (
        (jq.quantize_blockwise_4bit, pq.quantize_blockwise_4bit, x),
        (jq.quantize_blockwise_4bit_sqrt, pq.quantize_blockwise_4bit_sqrt,
         sq),
    ):
        jpacked, jscales, _ = jax.jit(jfn, static_argnums=1)(
            jnp.asarray(arg), block)
        packed, scales, _ = pfn(torch.from_numpy(arg), block)
        assert packed.dtype == torch.uint8
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    for jfn, pfn in (
        (jq.dequantize_blockwise_4bit, pq.dequantize_blockwise_4bit),
        (jq.dequantize_blockwise_4bit_sqrt, pq.dequantize_blockwise_4bit_sqrt),
    ):
        rows = -(-int(np.prod(shape)) // block)
        packed = rng.integers(0, 256, (rows, block // 2), dtype=np.uint8)
        if pfn is pq.dequantize_blockwise_4bit:
            packed &= 0xEE  # signed nibbles hold 0..14
        scales = rng.uniform(1e-4, 1.0, (rows, 1)).astype(np.float32)
        want = jax.jit(jfn, static_argnums=2)(
            jnp.asarray(packed), jnp.asarray(scales), shape)
        got = pfn(torch.from_numpy(packed), torch.from_numpy(scales), shape)
        assert got.shape == shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_update_in_place_is_plain_step_plus_apply():
    """On the CPU the in-place update is the plain step followed by
    ``p + upd`` in p's dtype, as the reference's update and
    ``optax.apply_updates`` give; the state is replaced in place."""
    rng = np.random.default_rng(5)
    for dtype in (torch.float32, torch.bfloat16):
        p = torch.from_numpy(rng.standard_normal((7, 45)).astype(
            np.float32)).to(dtype)
        g = torch.from_numpy(rng.standard_normal((7, 45)).astype(
            np.float32) * 1e-2).to(dtype)
        qm, ms, _ = pq.quantize_blockwise(torch.zeros(7, 45), 64)
        qn, ns, _ = pq.quantize_blockwise(torch.zeros(7, 45), 64)
        upd, *new = pq.fused_qadam_step_plain(
            pq.to_block_tiles(g, 64), pq.to_block_tiles(p, 64), qm, ms, qn,
            ns, 0.1, 0.001, out_dtype=dtype, **HYPER)
        want = p + upd.reshape(-1)[:p.numel()].reshape(p.shape)
        pq.reset_launch_counts()
        pq.fused_qadam_update_(p, g, qm, ms, qn, ns, bc1=0.1, bc2=0.001,
                               **HYPER)
        assert torch.equal(p, want) and p.dtype == dtype
        for state, value in zip((qm, ms, qn, ns), new):
            assert torch.equal(state, value)
    assert pq.LAUNCHES == {"quantize": 0, "dequantize": 0, "qadam": 0}


@pytest.mark.parametrize("call,match", [
    (lambda: pq.quantize_cuda(torch.zeros(64, dtype=torch.float16), 64),
     "bfloat16 or float32"),
    (lambda: pq.quantize_cuda(torch.zeros(64), 0), "block_size"),
    (lambda: pq.quantize_cuda(torch.zeros(8, 8).t(), 64), "contiguous"),
    (lambda: pq.qadam_step_cuda(
        torch.zeros(100), torch.zeros(100, dtype=torch.bfloat16),
        *pq.quantize_plain(torch.zeros(2, 64)),
        *pq.quantize_plain(torch.zeros(2, 64)), bc1=0.1, bc2=0.1, **HYPER),
     "gradient"),
    (lambda: pq.qadam_step_cuda(
        torch.zeros(100), torch.zeros(100),
        *pq.quantize_plain(torch.zeros(3, 64)),
        *pq.quantize_plain(torch.zeros(3, 64)), bc1=0.1, bc2=0.1, **HYPER),
     "state rows"),
])
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_params_struct_covers_the_cuda_struct():
    """The ctypes mirror of ``QAdamParams`` names every field of the C
    struct, in order."""
    assert _c_struct_fields("QAdamParams") == [
        f[0] for f in pq._QAdamParams._fields_]


# -- the multi-tensor q-AdamW step: one launch over many leaves -------------

# element counts of a parameter group's leaves: empty, ragged, whole rows
MULTI_NUMELS = [0, 5, 64, 65, 0, 1, 200, 2048 * 3 + 7]
# block -> each leaf's first row, then the total
MULTI_STARTS = {64: [0, 0, 1, 2, 4, 4, 5, 9, 106],
                2048: [0, 0, 1, 2, 3, 3, 4, 5, 9]}


@pytest.mark.parametrize("block", sorted(MULTI_STARTS))
def test_leaf_rows_and_the_leaf_of_every_row(block):
    """Prefix sums of the leaves' rows, and the kernel's search (the
    last leaf whose first row is at or before the row) finds every
    row's leaf among the leaves that have rows (the table leaves out
    the empty ones)."""
    starts = pq.leaf_rows(MULTI_NUMELS, block)
    assert starts.dtype == np.int64 and starts.tolist() == MULTI_STARTS[block]
    kept = [i for i, n in enumerate(MULTI_NUMELS) if n]
    row0 = starts[kept]
    want = [i for i in kept for _ in range(pq.num_rows(MULTI_NUMELS[i],
                                                        block))]
    got = [kept[np.searchsorted(row0, r, side="right") - 1]
           for r in range(int(starts[-1]))]
    assert got == want


def _leaf(numel, dtype, block, count, rng):
    """A parameter of ``numel`` elements with its gradient and moments
    (random codes and scales, as after some steps), at step ``count``."""
    p = torch.from_numpy(rng.standard_normal(numel).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal(numel) * 1e-2).astype(
        np.float32))
    rows = pq.num_rows(numel, block)
    qm, ms = pq.quantize_plain(torch.from_numpy(
        (rng.standard_normal((rows, block)) * 1e-3).astype(np.float32)))
    qn, ns = pq.quantize_plain(torch.from_numpy(
        (np.abs(rng.standard_normal((rows, block))) * 3e-3).astype(
            np.float32)))
    bc1, bc2 = pq.bias_corrections(HYPER["b1"], HYPER["b2"], count)
    return pq.QAdamLeaf(p.to(dtype), g.to(dtype), qm, ms, qn, ns, bc1, bc2)


def _c_struct_fields(name):
    src = (Path(pq.__file__).parent.parent / "csrc"
           / "quantization.cu").read_text()
    body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [n.strip() for n in re.sub(
                r"^(?:const\s+)?(?:long long|void\s*\*|int|float)\s*", "",
                decl,
            ).split(",")]
    return names


def test_leaf_table_layout_and_contents():
    """``LEAF_DTYPE`` is the C ``QAdamLeaf`` field for field (80 bytes);
    the table lists the leaves that have elements, in order, with their
    tensors' addresses, first rows, bias corrections and dtypes."""
    assert list(pq.LEAF_DTYPE.names) == _c_struct_fields("QAdamLeaf")
    assert pq.LEAF_DTYPE.itemsize == 80
    rng = np.random.default_rng(8)
    dtypes = [torch.float32, torch.bfloat16]
    leaves = [_leaf(n, dtypes[i % 2], 64, i + 1, rng)
              for i, n in enumerate(MULTI_NUMELS)]
    table, rows = pq.leaf_table(leaves, 64)
    kept = [leaf for leaf in leaves if leaf.p.numel()]
    assert rows == MULTI_STARTS[64][-1] and len(table) == len(kept)
    assert table["row0"].tolist() == [
        r for r, n in zip(MULTI_STARTS[64], MULTI_NUMELS) if n]
    for entry, leaf in zip(table, kept):
        for name in ("p", "g", "q_mu", "mu_scales", "q_nu", "nu_scales"):
            assert entry[name] == getattr(leaf, name).data_ptr(), name
        assert entry["numel"] == leaf.p.numel()
        assert (entry["bc1"], entry["bc2"]) == (np.float32(leaf.bc1),
                                                np.float32(leaf.bc2))
        assert entry["dtype"] == (1 if leaf.p.dtype == torch.bfloat16 else 0)


# (numel, dtype, step count) of one parameter group's leaves, in units of
# the block where they scale with it
MULTI_LEAVES = [(lambda b: 3 * b + 5, "float32", 1),
                (lambda b: 7, "bfloat16", 3),
                (lambda b: b, "bfloat16", 2),
                (lambda b: 0, "float32", 1),
                (lambda b: 2 * b + 33, "float32", 5),
                (lambda b: 5 * b, "bfloat16", 1)]


def _noncontiguous(t):
    """``t``'s values in a transposed layout."""
    return t.t().contiguous().t() if t.dim() == 2 else t[::1]


# a leaf's fault -> the check that refuses it: the state's on the launch
# when no owner checked it, the parameter's and gradient's on every launch
LEAF_FAULTS = {
    "state rows": (lambda l: l._replace(q_mu=l.q_mu[:-1]), "state"),
    "code dtype": (lambda l: l._replace(q_nu=l.q_nu.to(torch.uint8)),
                   "state"),
    "scale shape": (lambda l: l._replace(mu_scales=l.mu_scales.reshape(-1)),
                    "state"),
    "strided codes": (lambda l: l._replace(q_mu=_noncontiguous(l.q_mu)),
                      "state"),
    "fp16 parameter": (lambda l: l._replace(p=l.p.half(), g=l.g.half()),
                       "step"),
    "gradient dtype": (lambda l: l._replace(g=l.g.to(torch.bfloat16)),
                       "step"),
    "gradient shape": (lambda l: l._replace(g=l.g[:-1]), "step"),
    "strided gradient": (lambda l: l._replace(
        p=l.p.reshape(10, 20), g=_noncontiguous(l.g.reshape(10, 20))),
        "step"),
}


@pytest.mark.parametrize("fault", list(LEAF_FAULTS))
def test_qadam_checks_refuse_a_bad_leaf(fault):
    """The launch's checks pass a well-formed leaf and refuse each
    fault, in the check that owns it."""
    rng = np.random.default_rng(12)
    leaf = _leaf(200, torch.float32, 64, 1, rng)
    pq._check_qadam_state(leaf.p, *leaf[2:6], 64)
    pq._check_step([leaf], leaf.p.device)
    make, check = LEAF_FAULTS[fault]
    bad = make(leaf)
    with pytest.raises(ValueError):
        if check == "state":
            pq._check_qadam_state(bad.p, *bad[2:6], 64)
        else:
            pq._check_step([leaf, bad], leaf.p.device)


def _clone_leaf(leaf):
    return pq.QAdamLeaf(*(t.clone() for t in leaf[:6]), *leaf[6:])


@pytest.mark.parametrize("block", [64, 2048])
def test_multi_update_matches_per_leaf_and_jax(block):
    """One multi-tensor step over leaves of mixed sizes, dtypes and step
    counts equals the per-leaf step bit for bit on the CPU, and each
    leaf equals the JAX package's ``fused_qadam_step`` within the
    tolerances above (XLA's FMA contraction moves a moment by an ulp)."""
    rng = np.random.default_rng(9)
    leaves = [_leaf(n(block), getattr(torch, dt), block, count, rng)
              for n, dt, count in MULTI_LEAVES]
    before = [_clone_leaf(leaf) for leaf in leaves]
    per_leaf = [_clone_leaf(leaf) for leaf in leaves]
    pq.reset_launch_counts()
    pq.fused_qadam_update_multi_(leaves, **HYPER)
    for leaf in per_leaf:
        pq.fused_qadam_update_(*leaf[:6], bc1=leaf.bc1, bc2=leaf.bc2,
                               **HYPER)
    assert pq.LAUNCHES["qadam"] == 0
    for got, want in zip(leaves, per_leaf):
        for a, b in zip(got[:6], want[:6]):
            assert torch.equal(a, b)
    for got, old, (_, dt, _) in zip(leaves, before, MULTI_LEAVES):
        if not old.p.numel():
            continue
        jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
        g_t, p_t = (jnp.asarray(pq.to_block_tiles(t, block).numpy(), jdt)
                    for t in (old.g, old.p))
        jupd, jqm, jms, jqn, jns = jq.fused_qadam_step(
            g_t, p_t, *(jnp.asarray(t.numpy()) for t in old[2:6]),
            jnp.asarray([[old.bc1, old.bc2]], jnp.float32), **HYPER)
        for a, b in ((got.mu_scales, jms), (got.nu_scales, jns)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        code_mismatches(got.q_mu.numpy(), jqm)
        code_mismatches(got.q_nu.numpy(), jqn)
        upd = torch.from_numpy(np.array(jnp.asarray(jupd, jnp.float32)))
        want = (old.p + upd.reshape(-1)[:old.p.numel()].to(old.p.dtype))
        want, new = want.float().numpy(), got.p.float().numpy()
        if dt == "float32":
            np.testing.assert_allclose(new, want, atol=1e-6, rtol=1e-5)
        else:
            ulp = np.spacing(np.abs(want)) * 2.0 ** 16
            assert (np.abs(new - want) <= ulp).all()
            assert (new != want).sum() <= max(1, new.size // 1_000)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("numel,block", [(37 * 64 + 5, 64), (9 * 2048, 2048),
                                         (3 * 2048 + 700, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, numel, block, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(numel, generator=gen, device=cuda).to(dtype)
    for qmax in (127.0, 7.0):
        codes, scales = pq.quantize_cuda(x, block, qmax)
        want = pq.quantize_plain(pq.to_block_tiles(x, block), qmax)
        assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])
    assert torch.equal(pq.dequantize_cuda(codes, scales, (numel,)),
                       pq.dequantize_plain(codes, scales).reshape(-1)[:numel])
    g = (torch.randn(numel, generator=gen, device=cuda) * 1e-2).to(dtype)
    p = torch.randn(numel, generator=gen, device=cuda).to(dtype)
    qm, ms = pq.quantize_plain(pq.to_block_tiles(g, block))
    qn, ns = pq.quantize_plain(pq.to_block_tiles(g * g, block))
    upd, *new = pq.fused_qadam_step_plain(
        pq.to_block_tiles(g, block), pq.to_block_tiles(p, block), qm, ms,
        qn, ns, 0.271, 0.002997, out_dtype=dtype, **HYPER)
    want_p = p + upd.reshape(-1)[:numel]
    pq.qadam_step_cuda(p, g, qm, ms, qn, ns, bc1=0.271, bc2=0.002997,
                       **HYPER)
    torch.cuda.synchronize()
    assert torch.equal(p, want_p)
    for state, value in zip((qm, ms, qn, ns), new):
        assert torch.equal(state, value)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16384, 65536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_long_blocks_match_plain(cuda, block, dtype):
    """Blocks past the 8192 elements a CTA holds in registers take the
    two-pass kernels: zero mismatches against the plain versions."""
    test_cuda_kernels_match_plain(cuda, 3 * block + 700, block, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 2048])
def test_cuda_multi_launch_matches_per_leaf_launches(cuda, block):
    """One launch over a parameter group's leaves (mixed sizes, dtypes
    and step counts) against one launch per leaf, and the plain step."""
    rng = np.random.default_rng(10)
    leaves = [_leaf(n(block), getattr(torch, dt), block, count, rng)
              for n, dt, count in MULTI_LEAVES]
    leaves = [pq.QAdamLeaf(*(t.to(cuda) for t in leaf[:6]), *leaf[6:])
              for leaf in leaves]
    per_leaf = [_clone_leaf(leaf) for leaf in leaves]
    plain = [pq.QAdamLeaf(*(t.cpu() for t in leaf[:6]), *leaf[6:])
             for leaf in leaves]
    pq.reset_launch_counts()
    pq.fused_qadam_update_multi_(leaves, **HYPER)
    assert pq.LAUNCHES["qadam"] == 1
    for leaf in per_leaf:
        pq.qadam_step_cuda(*leaf[:6], bc1=leaf.bc1, bc2=leaf.bc2, **HYPER)
    pq.fused_qadam_update_multi_(plain, **HYPER)
    torch.cuda.synchronize()
    assert pq.LAUNCHES["qadam"] == 1 + sum(
        1 for leaf in leaves if leaf.p.numel())
    for got, a, b in zip(leaves, per_leaf, plain):
        for x, y, z in zip(got[:6], a[:6], b[:6]):
            assert torch.equal(x, y) and torch.equal(x.cpu(), z)


def parity_report():
    """Largest differences of the port's plain quantization kernels
    from the JAX package's on the cases above."""
    for rows, block in SHAPES:
        for dtype in ("float32", "bfloat16"):
            (upd, qm, ms, qn, ns), (jupd, jqm, jms, jqn, jns) = qadam_pair(
                rows, block, dtype)
            print(f"qadam {rows}x{block} {dtype}: update max_abs_err "
                  f"{np.abs(upd - jupd).max():.3e}, codes off by one mu "
                  f"{int((qm != jqm).sum())} nu {int((qn != jqn).sum())} of "
                  f"{qm.size}, scales max rel_err "
                  f"{max(np.abs(ms / jms - 1).max(), np.abs(ns / jns - 1).max()):.3e}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_quantization.py
    parity_report()
