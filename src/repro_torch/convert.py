"""Carry state from the JAX reference package into the port.

The reference's objects read as numpy arrays and plain fields, so the port
never imports ``repro`` to convert them: each converter copies the fields
of the object it is given into the port's class of the same name.  The
compile-and-admit path has no weights; its arrays (the SNN, its
clustering, the chip model and its degradation, the dataflow graph, the
stacked edge arrays) are its state.  The LM substrate's parameter pytree
converts with :func:`lm_params`.  The tests feed both packages identical
inputs through it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import hardware, maxplus, partition, sdfg, snn
from .device import resolve

#: port classes by name: a reference dataclass converts into its namesake
_CLASSES = {
    cls.__name__: cls
    for cls in (
        snn.SNN,
        partition.Cluster,
        partition.ClusteredSNN,
        hardware.CrossbarConfig,
        hardware.TileConfig,
        hardware.HardwareConfig,
        sdfg.ChannelTable,
        sdfg.SDFG,
        maxplus.EdgeStack,
    )
}


def _value(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, (list, tuple)):
        return type(v)(_value(x) for x in v)
    if isinstance(v, dict):
        return {k: _value(x) for k, x in v.items()}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return convert(v)
    return v


def convert(obj):
    """The port's copy of a reference dataclass instance (recursively).

    Every ``init`` field is read by name from ``obj`` into the port class
    whose name matches ``type(obj).__name__``; arrays are copied.
    """
    name = type(obj).__name__
    if name == "ChipState":
        return chip_state(obj)
    cls = _CLASSES.get(name)
    if cls is None:
        raise TypeError(f"no port class for {name!r}; have {sorted(_CLASSES)}")
    kwargs = {
        f.name: _value(getattr(obj, f.name))
        for f in dataclasses.fields(cls)
        if f.init
    }
    return cls(**kwargs)


def chip_state(obj) -> hardware.ChipState:
    """The port's :class:`~repro_torch.core.hardware.ChipState` with the
    reference state's dead tiles, link throttles, drift and epoch."""
    cs = hardware.ChipState(convert(obj.hw))
    cs.dead = np.asarray(obj.dead, dtype=bool).copy()
    cs.link_throttle = dict(obj.link_throttle)
    cs.drift = dict(obj.drift)
    cs.epoch = int(obj.epoch)
    return cs


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16, which torch cannot read
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lm_params(tree, device=None):
    """The port's parameters from the reference's pytree (nested dicts of
    arrays, read with ``np.asarray``): the same keys, shapes and dtypes,
    as tensors on ``device`` (``None`` is the card)."""
    dev = resolve(device)

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) else _tensor(t, dev)

    return walk(tree)
