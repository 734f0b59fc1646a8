"""B6 rows of Llama-3-8B's q-AdamW run on the card, replayed on the CPU.

``chip_smoke.py --only 11d`` trains Llama-3-8B (bf16 params, int8
q-AdamW, lr 3e-4, weight decay 0.1) for 12 steps on one batch; its
gradient norm spikes at steps 9 and 12 where torch's AdamW's does not
(ROADMAP §C 6).  At the optimizer's steps 8 and 9 it wrote out the four
rows of 2048 elements with the largest update of each step, before and
after the one B6 launch: the bf16 parameter and gradient, the int8
codes and fp32 scales of mu and sqrt(nu), the step count and the
hyperparameters (``tests/fixtures/qadam_rows_11d.json``, NVIDIA H100
80GB HBM3).  B6 updates each row from that row alone, so the rows
replay exactly:

- through the reference's ``fused_qadam_step`` (the Pallas kernel in
  interpret mode, under ``jax.jit`` as training runs it) and the port's
  plain B6: the new scales at rtol 1e-6, the codes equal but for at most
  1 in 10^4 off by one (XLA's CPU backend contracts the moments' sums
  into FMAs; ``tests/test_torch_quantization.py``), the bf16 updates
  within one bf16 ulp in at most 1 in 10^3 elements;
- the card's kernel against the port's plain B6 on the same row: codes,
  scales and the new parameter (``p + round_bf16(update)``) identical,
  as phase 3 holds B6 to its plain version.

The rows' updates equal the reference's: what 11d shows is the
reference's behaviour on that run, not a fault of the port.
"""

import base64
import json
import os

import numpy as np
import pytest
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "qadam_rows_11d.json")


def _load():
    with open(FIXTURE) as f:
        return json.load(f)


def _array(text, dtype, block):
    raw = np.frombuffer(base64.b64decode(text), dtype=dtype)
    return raw.reshape(1, block).copy()


def _bf16(text, block):
    """A bf16 row from its 16-bit patterns, as a torch tensor."""
    bits = _array(text, np.int16, block)
    return torch.from_numpy(bits).view(torch.bfloat16)


def _rows():
    data = _load()
    return [(data, i) for i in range(len(data["rows"]))]


def _replay(data, rec):
    import jax.numpy as jnp

    from dlrover_tpu.ops import quantization as jq
    from dlrover_tpu_torch.ops import quantization as pq

    block = data["block"]
    hyper = data["hyper"]
    p, g = _bf16(rec["p"], block), _bf16(rec["g"], block)
    mu, nu = (_array(rec[k], np.int8, block) for k in ("mu", "nu"))
    ms = np.array([[rec["mu_scale"]]], np.float32)
    ns = np.array([[rec["nu_scale"]]], np.float32)
    bc1, bc2 = pq.bias_corrections(hyper["b1"], hyper["b2"], rec["step"])
    port = pq.fused_qadam_step_plain(
        g, p, torch.from_numpy(mu), torch.from_numpy(ms),
        torch.from_numpy(nu), torch.from_numpy(ns), bc1, bc2, **hyper)

    def jbf16(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    ref = jq.fused_qadam_step(
        jbf16(g), jbf16(p), jnp.asarray(mu), jnp.asarray(ms),
        jnp.asarray(nu), jnp.asarray(ns),
        jnp.asarray([[bc1, bc2]], jnp.float32), **hyper)
    return p, port, [np.asarray(jnp.asarray(r, jnp.float32)) for r in ref]


@pytest.mark.parametrize("case", range(8))
def test_card_rows_replay_as_the_reference(case):
    from test_torch_quantization import code_mismatches

    data = _load()
    assert len(data["rows"]) == 8
    rec = data["rows"][case]
    assert rec["step"] in (8, 9)
    p, port, ref = _replay(data, rec)
    upd, qm, ms, qn, ns = (t.float().numpy() for t in port)
    jupd, jqm, jms, jqn, jns = ref
    for got, want in ((ms, jms), (ns, jns)):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    code_mismatches(qm, jqm)
    code_mismatches(qn, jqn)
    ulp = np.spacing(np.abs(jupd)) * 2.0 ** 16
    off = np.abs(upd - jupd) > 0
    assert (np.abs(upd - jupd) <= ulp).all()
    assert off.sum() <= max(1, upd.size // 1_000)
    # the card's kernel did what the port's plain B6 does
    block = data["block"]
    new_p = (p.float() + port[0].float()).to(torch.bfloat16)
    assert torch.equal(new_p.view(torch.int16),
                       _bf16(rec["p_new"], block).view(torch.int16))
    np.testing.assert_array_equal(
        port[1].numpy(), _array(rec["mu_new"], np.int8, block))
    np.testing.assert_array_equal(
        port[3].numpy(), _array(rec["nu_new"], np.int8, block))
    assert float(port[2][0, 0]) == np.float32(rec["mu_scale_new"])
    assert float(port[4][0, 0]) == np.float32(rec["nu_scale_new"])
