"""Where the port's entry points put their tensors.

Every public constructor and factory takes `device` and defaults to
``"cuda"``: the port is for the card.  A caller that wants the plain
PyTorch versions on the host passes ``device="cpu"`` explicitly; there is
no silent fallback.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device.  A CUDA device on a host without one
    raises here, at construction, rather than at the first launch."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: this host has no CUDA device "
            "(torch.cuda.is_available() is false); pass device='cpu' to run "
            "the plain PyTorch versions on the host")
    return dev
