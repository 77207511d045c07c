"""Device selection for every entry point of the port.

``device=None`` means ``torch.device("cuda")``: the port runs on the card
unless the caller asks for the CPU, and it never carries on silently on
the host when there is no CUDA device.
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
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def no_mesh(value, what: str) -> None:
    """Raise for a ``mesh=``/``devices=`` argument that is not ``None``:
    the sharded solve is not ported yet."""
    if value is not None:
        raise NotImplementedError(
            f"{what} is the sharded solve, which repro_torch does not port "
            f"yet (ROADMAP.md queue 1, module 5); pass None"
        )
