"""Device selection for every entry point of the port.

``device=None`` means ``torch.device("cuda")``: the port runs on the card
unless the caller asks for the CPU, and it never carries on silently on
the host when there is no CUDA device.  ``"meta"`` makes tensors of shapes
and dtypes only (``init_cache_abstract``).
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The ``torch.device`` to run on; raises ``RuntimeError`` for a CUDA
    device (the default) when CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the host"
            )
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or 'meta' (shapes only)")
    return dev

