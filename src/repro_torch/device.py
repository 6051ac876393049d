"""Where the port runs: the card, unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; with no card, ``None`` raises.

    The CPU is taken only when the caller names it (the tests do), never as
    a silent stand-in for a missing card.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run "
                "the port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
