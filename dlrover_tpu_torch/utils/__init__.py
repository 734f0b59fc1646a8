"""Utilities: the converters between the JAX package's flax params and
the port's state dicts (``convert``, port-only), and the copies of
``dlrover_tpu/utils/``: timers, profiling, numeric checking, μP and
the HF state-dict bridge (reference: ``atorch/utils/`` — timer.py,
prof.py, parse_trace_json.py, numberic_checker.py)."""

from dlrover_tpu_torch.utils.numeric_checker import check_numerics
from dlrover_tpu_torch.utils.timer import Timer, Timers
from dlrover_tpu_torch.utils.torch_compat import (
    gpt2_params_from_torch,
    gpt2_params_to_torch,
    llama_params_from_torch,
    llama_params_to_torch,
)

__all__ = [
    "Timer",
    "Timers",
    "check_numerics",
    "gpt2_params_from_torch",
    "gpt2_params_to_torch",
    "llama_params_from_torch",
    "llama_params_to_torch",
]
