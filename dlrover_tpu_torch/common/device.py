"""Where the port's entry points run.

Port-only module (JAX places arrays on its default backend).  The
entry points (``GPT``, ``Trainer``, ``make_train_step``) run on the
card unless the caller names another device; with no card and no
explicit device they raise instead of falling back to the CPU.
"""

from typing import Optional, Union

import torch


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed`` DTensor (the parameters
    and gradients that FSDP2 and tensor parallelism leave)."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a torch built without distributed
        return False
    return isinstance(x, DTensor)


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: dlrover_tpu_torch runs on the GPU unless "
                "device='cpu' is passed explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
