"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller names another device: with
no argument they resolve to ``cuda`` and raise when no GPU is present, so
a missing card is an error and never a silent CPU run. Tests and CPU
parity runs pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The torch device an entry point runs on (``cuda`` by default)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "h2o3_tpu_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
