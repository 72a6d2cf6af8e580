"""Device resolution shared by every entry point of the port.

``None`` means ``"cuda"``.  There is no silent CPU path: a caller that
wants the CPU (the tests, a host-only tool) asks for it by name.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host"
        )
    return dev
