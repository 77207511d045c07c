"""The analysis mesh: the devices the sharded λ-search spreads its rows over.

The port's copy of the part of ``repro.launch.sharding`` that the SNN
compiler's scoring uses: a one-dimensional :class:`Mesh` of
``torch.device``s, :func:`host_mesh` over the visible CUDA devices,
:func:`row_chunks` (the batch-axis sharding rule) and a thread-local
ambient mesh (:func:`use_mesh` / :func:`current_mesh`).  The sharding
rules of the LM substrate (``logical_shard`` and the parameter and cache
specs) wait for the distributed slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-dimensional mesh: ``devices`` along the axis ``axis_names[0]``.

    A device may repeat: ``Mesh((cuda:0,) * 4)`` spreads four row chunks
    over four streams of one card.
    """

    devices: tuple
    axis_names: tuple = ("data",)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError(
                f"the analysis mesh has one axis, got {tuple(self.axis_names)}"
            )
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))


def current_mesh() -> Optional[Mesh]:
    """The mesh entered by :func:`use_mesh` on this thread, else ``None``."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` this thread's ambient mesh (other threads do not see it)."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def mesh_devices(mesh: Optional[Mesh]) -> list:
    """Flat device list of ``mesh`` (row-major over its axes); ``[]`` if None.

    The sharded analysis path (:func:`repro_torch.core.engine.batch_execute`
    / ``batch_execute_fused``) chunks the EdgeStack batch axis over exactly
    this ordering, so chunk k always lands on the same device across calls.
    """
    return [] if mesh is None else list(mesh.devices)


def host_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D data mesh over the visible CUDA devices.

    ``n_devices`` clamps to what is actually visible; raises
    ``RuntimeError`` when no CUDA device is visible (build a :class:`Mesh`
    of ``torch.device("cpu")`` entries to shard on the host).
    """
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "host_mesh meshes CUDA devices and none is visible; build "
            "Mesh((torch.device('cpu'),) * k) to shard on the host"
        )
    if n_devices is not None:
        count = min(int(n_devices), count)
    return Mesh(tuple(torch.device("cuda", i) for i in range(count)))


def row_chunks(n_rows: int, n_parts: int) -> list[slice]:
    """Contiguous near-equal row slices: the batch-axis sharding rule.

    Mirrors ``np.array_split`` boundaries (first ``n_rows % n_parts``
    chunks get one extra row); empty chunks are dropped so every returned
    slice maps to real work on its device.
    """
    n_parts = max(1, min(int(n_parts), int(n_rows)))
    base, extra = divmod(int(n_rows), n_parts)
    out, start = [], 0
    for k in range(n_parts):
        size = base + (1 if k < extra else 0)
        if size:
            out.append(slice(start, start + size))
        start += size
    return out
