"""Device resolution for the PyTorch port.

Every constructor and entry point of the port takes an explicit
`device`.  A request for CUDA on a machine without it raises: the port
never moves work to the CPU behind the caller's back, because the CPU
path runs the plain PyTorch twins of the kernels and its timings say
nothing about the card.  The CPU is used only when asked for by name.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for `device` ("cuda", "cuda:N" or "cpu").

    Raises RuntimeError for a CUDA device when CUDA is not available,
    and ValueError for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r} (use 'cuda' or 'cpu')")
