"""The LM meshes as ``torch.distributed`` ``DeviceMesh``es (the port of
``repro.launch.mesh``).

The production mesh is one pod of 256 devices as ``(16, 16)`` named
``("data", "model")``, or two pods as ``(2, 16, 16)`` named
``("pod", "data", "model")``; the pod axis extends data parallelism.  Both
need a process group of that many ranks, or the fake process group
(backend ``"fake"``), under which the specs and shapes of a production run
are worked out in one process.  :func:`make_local_mesh` is ``(1, 1)`` over
this rank's device, with the production axis names.

Importing this module touches no device and no process group; the meshes
are built inside the functions, after the caller has initialised the
group (``torch.distributed.init_process_group``).

:data:`HW` holds the per-device constants of the dry run's roofline terms
(``launch/dryrun.py``): NVIDIA H100 SXM data-sheet figures, not
measurements.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _need_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "an LM mesh needs a process group: call torch.distributed."
            "init_process_group first (backend 'nccl' on the card, 'gloo' on the host)"
        )


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` with ``"pod"``
    in front.  Raises unless the world has exactly that many ranks or the
    group is the fake one."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _need_group()
    world = dist.get_world_size()
    if world != math.prod(shape) and dist.get_backend() != "fake":
        raise ValueError(
            f"the production mesh {shape} needs {math.prod(shape)} ranks, the world has "
            f"{world}; pass a mesh of its own to a run of another size"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(device_type: str = "cuda"):
    """A ``(1, 1)`` mesh over this rank's device with the production axis
    names, in a world of one rank (single-device runs and smoke tests)."""
    from torch.distributed.device_mesh import DeviceMesh

    _need_group()
    if dist.get_world_size() != 1:
        raise ValueError(f"the local mesh is one rank's, the world has {dist.get_world_size()}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_local_mesh('cuda') needs a CUDA device; pass 'cpu' on the host")
    return DeviceMesh(device_type, [[dist.get_rank()]], mesh_dim_names=("data", "model"))


HW = {
    # NVIDIA H100 SXM (H100 Tensor Core GPU data sheet, SXM5 part) per-device
    # constants for the roofline terms; the keys are the reference's
    "peak_flops_bf16": 989e12,   # FLOP/s, dense bf16 on the tensor cores
    "hbm_bw": 3.35e12,           # B/s, HBM3
    "ici_bw": 450e9,             # B/s, NVLink 4 in one direction (900e9 both ways)
    "hbm_bytes": 80e9,           # capacity
}
