"""Partition-rule registry: model family -> partition rules.

Copy of ``dlrover_tpu/parallel/registry.py``; in the port the rules
become each parameter's placements (FSDP2 on ``fsdp``, DTensor on
``tensor``).  Reference of that file: ATorch's modules registry / TP compiler
(``modules/distributed_modules/modules_registry.py:1325``) maps HF
module classes to hand-written parallel replacements.  The TPU
equivalent is declarative: a family registers ONE PartitionRules set
(regexes over parameter paths), and any model whose parameter naming
matches is parallelized by GSPMD — no per-architecture module code.
``rules_for_model`` resolves a model instance to its family's rules,
falling back to the shared transformer naming contract
(``gpt_tp_rules``), which already covers GPT/Llama/BERT here.
Out-of-tree models register with :func:`register_tp_rules`.
"""

from typing import Callable, Dict, Optional, Union

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.sharding import (
    PartitionRules,
    gpt_tp_rules,
    moe_rules,
)

RulesLike = Union[PartitionRules, Callable[[], PartitionRules]]

_REGISTRY: Dict[str, RulesLike] = {}


def register_tp_rules(family: str, rules: RulesLike):
    """Register rules for a model family (class name, lowercase)."""
    _REGISTRY[family.lower()] = rules
    logger.info("registered TP rules for model family '%s'", family)


def _resolve(entry: RulesLike) -> PartitionRules:
    return entry() if callable(entry) else entry


def rules_for_model(model=None, use_moe: Optional[bool] = None
                    ) -> PartitionRules:
    """Model instance (or None) -> partition rules.

    Resolution: exact class-name registration, then MoE-aware shared
    rules (a config with ``moe_experts > 0`` needs the expert-axis
    placement), then the shared transformer contract.  ``model=None``
    uses the shared rules directly (``use_moe`` still selects the
    expert placement)."""
    if model is not None:
        family = type(model).__name__.lower()
        if family in _REGISTRY:
            return _resolve(_REGISTRY[family])
        if use_moe is None:
            cfg = getattr(model, "config", None)
            use_moe = bool(getattr(cfg, "moe_experts", 0))
    return moe_rules() if use_moe else gpt_tp_rules()


def unregister_tp_rules(family: str):
    _REGISTRY.pop(family.lower(), None)


def registered_families() -> Dict[str, RulesLike]:
    return dict(_REGISTRY)
