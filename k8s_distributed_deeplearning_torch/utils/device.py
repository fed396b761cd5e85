"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`. Entry points default to
    ``"cuda"`` and raise here when no CUDA device is present: the port
    never moves to the CPU on its own, a caller asks for it with
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the PyTorch port runs on an "
            "NVIDIA GPU by default; pass device='cpu' to run the plain "
            "PyTorch versions of its kernels on the CPU")
    return dev
