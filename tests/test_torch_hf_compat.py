"""HF state dicts <-> the port's GPT and Llama
(``dlrover_tpu_torch.utils.torch_compat``): twins of
``tests/test_torch_compat.py`` (which holds the JAX package's bridge).

The HF models come from a local ``GPT2Config``/``LlamaConfig`` with
random weights (``torch.manual_seed``), so nothing is downloaded.
Checked: the converted weights reproduce the HF model's logits (fp32,
atol/rtol 2e-3, the reference's tolerance), the converted state dict
is the JAX package's conversion carried over by ``params_from_jax``,
value for value, and loads strictly into the port's model; the export
round trip is exact and drives the HF model to the port's logits.
"""

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from dlrover_tpu.utils import torch_compat as jax_compat  # noqa: E402
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig  # noqa: E402
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig  # noqa: E402
from dlrover_tpu_torch.utils import torch_compat  # noqa: E402
from dlrover_tpu_torch.utils.convert import params_from_jax  # noqa: E402


def _hf_gpt2():
    return transformers.GPT2Config(
        vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)


def _hf_llama():
    return transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False, tie_word_embeddings=False)


def _gpt():
    return GPT(GPTConfig(vocab_size=256, max_seq_len=64, num_layers=2,
                         num_heads=4, hidden_dim=64, dtype=torch.float32,
                         tie_embeddings=True), device="cpu")


def _llama():
    return Llama(LlamaConfig(vocab_size=256, max_seq_len=64, num_layers=2,
                             num_heads=4, num_kv_heads=2, hidden_dim=64,
                             intermediate_dim=128, rope_theta=10000.0,
                             rms_eps=1e-5, dtype=torch.float32),
                 device="cpu")


FAMILIES = {
    "gpt2": (_hf_gpt2, transformers.GPT2LMHeadModel, _gpt,
             torch_compat.gpt2_params_from_torch,
             torch_compat.gpt2_params_to_torch,
             jax_compat.gpt2_params_from_torch),
    "llama": (_hf_llama, transformers.LlamaForCausalLM, _llama,
              torch_compat.llama_params_from_torch,
              torch_compat.llama_params_to_torch,
              jax_compat.llama_params_from_torch),
}


def _tokens(seed, s=16):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (2, s), dtype=np.int64))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_conversion_matches_hf_logits(family):
    """Twin of ``test_gpt2_torch_conversion_matches_hf_logits`` and
    ``test_llama_torch_conversion_matches_hf_logits_gqa``."""
    hf_cfg, hf_cls, make, from_torch, _, _ = FAMILIES[family]
    torch.manual_seed(0)
    hf = hf_cls(hf_cfg()).eval()
    model = make()
    model.load_state_dict(from_torch(hf.state_dict()))
    x = _tokens(1 if family == "llama" else 0)
    with torch.no_grad():
        ref = hf(x).logits.numpy()
        ours = model(x).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_conversion_is_the_jax_packages_and_loads_strictly(family):
    """Twin of ``test_converted_params_train_through_auto_accelerate``:
    the converted dict has the port model's own names and shapes (a
    strict load), and it is the JAX package's conversion carried over by
    ``params_from_jax``, value for value."""
    hf_cfg, hf_cls, make, from_torch, _, jax_from_torch = FAMILIES[family]
    torch.manual_seed(0)
    sd = hf_cls(hf_cfg()).state_dict()
    ours = from_torch(sd)
    model = make()
    native = model.state_dict()
    assert sorted(ours) == sorted(native)
    for name, t in ours.items():
        assert t.shape == native[name].shape, name
    model.load_state_dict(ours, strict=True)
    want = params_from_jax(jax.tree.map(np.asarray, jax_from_torch(sd)))
    assert sorted(want) == sorted(ours)
    for name, t in want.items():
        torch.testing.assert_close(ours[name], t, rtol=0, atol=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_roundtrip_to_torch_and_back(family):
    """Twin of ``test_roundtrip_to_torch_and_back``: ours -> HF state
    dict -> ours is exact, and the exported dict loads into the HF model
    with matching logits."""
    hf_cfg, hf_cls, make, from_torch, to_torch, _ = FAMILIES[family]
    model = make()
    params = model.state_dict()
    sd = to_torch(params)
    back = from_torch(sd)
    assert sorted(back) == sorted(params)
    for name, t in params.items():
        assert torch.equal(back[name], t), name
    hf = hf_cls(hf_cfg()).eval()
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not [m for m in missing if "rotary" not in m
                and "masked_bias" not in m and ".attn.bias" not in m
                ], missing
    assert not unexpected
    x = _tokens(2, s=12)
    with torch.no_grad():
        ref = hf(x).logits.numpy()
        ours = model(x).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-3, rtol=2e-3)


def test_bf16_checkpoints_keep_their_dtype():
    """A bf16 HF checkpoint converts to bf16 tensors, bit for bit (the
    reference goes through fp32 for numpy; the port needs no detour)."""
    torch.manual_seed(0)
    sd = {k: v.to(torch.bfloat16) for k, v in
          transformers.GPT2LMHeadModel(_hf_gpt2()).state_dict().items()
          if v.is_floating_point()}
    ours = torch_compat.gpt2_params_from_torch(sd)
    assert ours["wte.weight"].dtype == torch.bfloat16
    assert torch.equal(ours["blocks.1.attn.qkv.weight"],
                       sd["transformer.h.1.attn.c_attn.weight"])
