"""ModelContext: everything the strategy engine needs about a job.

Reference: ``dlrover_tpu/accel/model_context.py`` (itself the role of
ATorch's ``atorch/auto/model_context.py``).  The reference's model is a
flax module whose params the context initialises from a seed; a torch
module carries its weights, so here the model is the module itself,
``optim_factory(params)`` builds a torch optimizer over the parameters
it is given, ``loss_fn(module, batch)`` is a scalar, and ``device`` is
where the job runs (the card unless ``"cpu"`` is named).
"""

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch


@dataclass
class ModelContext:
    model: Any                              # torch module with its weights
    optim_factory: Callable[..., Any]       # (params) -> torch optimizer
    loss_fn: Callable                       # (module, batch) -> scalar
    sample_batch: Any                       # dict of arrays or tensors
    extra: Dict[str, Any] = field(default_factory=dict)
    device: Optional[torch.device] = None

    def optimizer(self, params):
        return self.optim_factory(params)
