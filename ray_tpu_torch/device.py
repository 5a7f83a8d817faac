"""Device selection for the port's entry points.

Entry points run on the card by default. Without one they raise, unless
the caller asks for the CPU (``device="cpu"``), as the tests do: nothing
quietly carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card, and "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"the plain PyTorch path on the CPU")
    return dev
