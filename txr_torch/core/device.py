"""Where an entry point runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA device and raises when there is none.

    The port never carries on on the CPU because it found no GPU: the CPU is
    used only when the caller names it (``device="cpu"``), as the parity
    tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "txr_torch runs on a CUDA device and none is available; "
                "pass device='cpu' explicitly to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was requested but no CUDA device is "
            "available")
    return dev
