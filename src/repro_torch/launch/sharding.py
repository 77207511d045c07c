"""Sharding: the analysis mesh of the λ-search, and the LM mesh's rules
(the port of ``repro.launch.sharding``).

**The analysis mesh.** A one-dimensional :class:`Mesh` of ``torch.device``s,
:func:`host_mesh` over the visible CUDA devices and :func:`row_chunks` (the
batch-axis sharding rule): the sharded λ-search spreads its rows over it.

**The LM mesh** is a ``torch.distributed`` ``DeviceMesh`` named
``("data", "model")`` or ``("pod", "data", "model")`` (``launch/mesh.py``).
One place maps every parameter, activation, cache and optimizer leaf to a
spec over it, with the reference's rules:

  batch dims            -> ("pod","data")      (DP; ZeRO-style state shard)
  attention heads / FFN hidden / experts / vocab -> "model"  (TP / EP)
  KV-cache: heads over "model" when divisible, else sequence (SP)

Every rule degrades gracefully: an axis is applied only if the dim is
divisible by the mesh axis size.

The spec functions are pure over the mesh's axis names and sizes: ``mesh``
is a ``DeviceMesh`` or a mapping of axis name to size, so the production
specs need no process group.  A spec is the reference's ``PartitionSpec``
as a tuple, one entry a dim: ``None``, an axis name, or a tuple of axis
names.  :func:`placements` turns a spec into DTensor placements on a real
``DeviceMesh``, and :func:`distribute` applies a tree of
:class:`NamedSharding`.

**The order of a multi-axis entry.**  A dim sharded over several axes,
such as the inference experts' ``("model", "data")``, is split by DTensor
in the mesh's order: on a ``(data, model)`` mesh chunk
``data_idx * n_model + model_idx``, where JAX splits in the entry's order
(``model_idx * n_data + data_idx``).  The port keeps DTensor's layout and
linearises the expert rank in ``models/moe.py``'s ``_local_moe`` over the
expert axes in mesh order to match it.  So the results are the
reference's, but expert ``e`` of an inference-EP layer lies on another
``(data, model)`` coordinate than in the reference whenever both axes are
larger than one.

**The ambient mesh.**  :func:`use_mesh` / :func:`current_mesh` carry either
kind.  The λ-search reads it through :func:`mesh_devices`, which ignores an
LM ``DeviceMesh``: the λ-search shards over an analysis :class:`Mesh` only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
from typing import Mapping, Optional

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

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


def current_mesh():
    """The mesh entered by :func:`use_mesh` on this thread (an analysis
    :class:`Mesh` or an LM ``DeviceMesh``), else ``None``."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` this thread's ambient mesh (other threads do not see
    it).  Under an LM ``DeviceMesh`` a plain tensor that meets a DTensor
    (positions, masks, RoPE tables, in the forward and in autograd's
    backward) counts as replicated over the mesh."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        if mesh is None or isinstance(mesh, Mesh):
            yield mesh
        else:
            with _implicit_replication(), _shard_to_partial_via_replica():
                yield mesh
    finally:
        _STATE.mesh = prev


@contextlib.contextmanager
def _shard_to_partial_via_replica():
    """Let DTensor's operator dispatch turn a shard into a partial sum by
    way of a replica (all-gather, then keep the value on one rank), which
    DTensor cannot do in one step.  torch 2.11 plans a pointwise operator
    in one input's layout, so an add of two gradients where each shards
    what the other sums (deepseek-v3's MLA branch against its residual,
    train_4k on the (2, 16, 16) mesh) has no plan it can run without it.
    Restores what it found on exit; an enclosing one stays."""
    import torch.distributed.tensor._dispatch as dispatch
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    base = dispatch.redistribute_local_tensor
    if getattr(base, "via_replica", False):
        yield
        return

    def redistribute_local_tensor(local, current, target, *args, **kwargs):
        mid = tuple(Replicate() if c.is_shard() and t.is_partial() else t
                    for c, t in zip(current.placements, target.placements))
        if mid != tuple(target.placements):
            spec = DTensorSpec(target.mesh, mid, tensor_meta=target.tensor_meta)
            local, current = base(local, current, spec, *args, **kwargs), spec
        return base(local, current, target, *args, **kwargs)

    redistribute_local_tensor.via_replica = True
    dispatch.redistribute_local_tensor = redistribute_local_tensor
    try:
        yield
    finally:
        dispatch.redistribute_local_tensor = base


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, restoring the flag it found on
    exit: torch's own clears it, which would end an enclosing one (the
    layer groups enter the mesh again inside the step's)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def mesh_devices(mesh) -> list:
    """Flat device list of an analysis ``mesh``; ``[]`` for None or an LM
    ``DeviceMesh`` (the λ-search does not shard over the LM mesh).

    The sharded analysis path (:func:`repro_torch.core.engine.batch_execute`
    / ``batch_execute_fused``) chunks the EdgeStack batch axis over exactly
    this ordering, so chunk k always lands on the same device across calls.
    """
    return list(mesh.devices) if isinstance(mesh, Mesh) else []


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


# ======================================================================
# the LM mesh: axis sizes, specs and placements
# ======================================================================
def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, an analysis :class:`Mesh`
    or a mapping of axis name to size, in the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    if isinstance(mesh, Mesh):
        return {mesh.axis_names[0]: len(mesh.devices)}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("an LM DeviceMesh needs mesh_dim_names")
    return dict(zip(names, (int(n) for n in mesh.shape)))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _entry(axis):
    """A spec entry as ``PartitionSpec`` keeps it: a one-axis tuple is its axis."""
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


def _fit(mesh, shape, spec_axes) -> tuple:
    """Drop spec axes that do not divide the corresponding dim."""
    fitted = []
    for dim, axis in zip(shape, spec_axes):
        if axis is not None and dim % _axis_size(mesh, axis) == 0 and dim > 0:
            fitted.append(_entry(axis))
        else:
            fitted.append(None)
    return tuple(fitted)


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: the port's ``jax.sharding.NamedSharding``.
    ``mesh`` is a ``DeviceMesh``, or an axis-size mapping when only the spec
    is wanted."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: one a
    mesh axis, ``Shard(d)`` for the dim ``d`` whose entry names the axis,
    else ``Replicate()``.  A dim named by several axes is split in the
    mesh's order (the module docstring).  An axis of size 1 replicates: one
    shard is the whole dim, and DTensor would refuse views of a dim it
    counts as sharded."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    used = set()
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None:
                continue
            if axis in used:
                raise ValueError(f"mesh axis {axis!r} shards two dims of spec {spec}")
            used.add(axis)
            if sizes[axis] > 1:
                out[names.index(axis)] = Shard(d)
    return tuple(out)


def distribute(tree, shardings):
    """Each tensor leaf of ``tree`` as a DTensor with its sharding's
    placements.  Every rank must hold the same full leaf (a seeded init, a
    restored checkpoint): each keeps its own chunk and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(
        lambda t, sh: distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None),
        tree, shardings, is_leaf=is_sharding)


def full(t):
    """A DTensor gathered whole on every rank (a collective: every rank of
    its mesh calls it); anything else as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def write_slot(buf, dim: int, slot: int, val) -> None:
    """``buf.select(dim, slot).copy_(val)``, in place, also on a DTensor
    ``buf`` (a decode cache): ``val`` is laid out as ``buf`` without ``dim``
    and written into the shard that holds ``slot``, if this rank has it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(buf, DTensor):
        buf.select(dim, slot).copy_(val)
        return
    mesh, pls = buf.device_mesh, buf.placements
    if not isinstance(val, DTensor):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim, run_check=False)
    val_pls = [Replicate() if isinstance(p, Shard) and p.dim == dim
               else Shard(p.dim - (p.dim > dim)) if isinstance(p, Shard) else p for p in pls]
    local_val = val.redistribute(mesh, val_pls).to_local()
    lo, size = _local_range(mesh, pls, dim, buf.shape[dim])
    if lo <= slot < lo + size:
        buf.to_local().select(dim, slot - lo).copy_(local_val)


def _local_range(mesh, pls, dim: int, size: int) -> tuple:
    """(first index, count) of dim ``dim`` (of global ``size``) that this
    rank holds under placements ``pls``: DTensor's row-major chunks, even
    by ``_fit``."""
    from torch.distributed.tensor import Shard

    lo = 0
    for i, p in enumerate(pls):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(i)
            lo += mesh.get_local_rank(i) * size
    return lo, size


def embedding(tokens, table):
    """``F.embedding(tokens, table)``.  On a DTensor ``table`` (V, D) the
    lookup is vocab-parallel and the table stays where it is: the tokens
    (small) are replicated, each rank looks its own rows up in its own
    columns (zero for a token whose row another rank holds), and the
    partial sums over the vocab's axes are reduced as the result is laid
    out like the tokens, with D whole.  (DTensor's own vocab-parallel
    embedding mixes up its mask when the tokens are batch-sharded.)"""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh, pls = table.device_mesh, tuple(table.placements)
    nd = tokens.dim()

    def lookup(tok, tab):
        lo, n = _local_range(mesh, pls, 0, table.shape[0])
        rel = tok - lo
        inside = (rel >= 0) & (rel < n)
        return F.embedding(torch.where(inside, rel, 0), tab) * inside[..., None].to(tab.dtype)

    out_pls = tuple(Partial() if isinstance(p, Shard) and p.dim == 0 else
                    Shard(nd) if isinstance(p, Shard) else Replicate() for p in pls)
    tok_pls = (tuple(tokens.placements) if isinstance(tokens, DTensor)
               else (Replicate(),) * mesh.ndim)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, tok_pls, run_check=False)
    rep = (Replicate(),) * mesh.ndim
    x = local_map(lookup, out_placements=(out_pls,), in_placements=(rep, pls),
                  in_grad_placements=(rep, pls), device_mesh=mesh,
                  redistribute_inputs=True)(tokens, table)
    return x.redistribute(mesh, tok_pls)


def split_dim(t, dim: int, sizes) -> torch.Tensor:
    """``t.unflatten(dim, sizes)``.  A DTensor whose shards of ``dim`` would
    not split evenly into ``sizes[0]`` (say 12 heads over a model axis of
    16) is first replicated along ``dim``: the all-gather GSPMD inserts
    where a reshape splits a sharded dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(t, DTensor):
        dim = dim % t.dim()
        pls = tuple(t.placements)
        split = [i for i, p in enumerate(pls) if isinstance(p, Shard) and p.dim == dim]
        if sizes[0] % math.prod(t.device_mesh.size(i) for i in split):
            t = t.redistribute(t.device_mesh, [Replicate() if i in split else p
                                               for i, p in enumerate(pls)])
    return t.unflatten(dim, sizes)


class _MergeDims(torch.autograd.Function):
    """``flatten(dim, dim + 1)`` whose backward splits the gradient by
    :func:`split_dim`: the gradient may come back sharded over the merged
    dim where its first factor does not divide (DTensor's own view
    backward refuses that)."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim, ctx.sizes = dim, (t.shape[dim], t.shape[dim + 1])
        return t.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None


def merge_dims(t, dim: int) -> torch.Tensor:
    """``t.flatten(dim, dim + 1)`` (say heads and head dim into one); on a
    DTensor its gradient is split back by :func:`split_dim`."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t.flatten(dim, dim + 1)
    return _MergeDims.apply(t, dim % t.dim())


class _Reshape(torch.autograd.Function):
    """``t.reshape(shape)`` whose backward lays the gradient out as the
    result was laid out before viewing it back.  A gradient summed over
    branches may come back in another layout: sharded over a merged dim by
    more ranks than the dim's first factor has rows (the MoE's tokens, (B,
    S) merged, sharded over pod x data where B is one microbatch), which
    torch 2.11's view backward cannot split.  A partial sum of the result's
    reads as replicated where the gradient is not one."""

    @staticmethod
    def forward(ctx, t, shape):
        out = t.reshape(shape)
        ctx.shape, ctx.mesh, ctx.pls = t.shape, out.device_mesh, tuple(out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate

        pls = tuple(Replicate() if isinstance(p, Partial) and not isinstance(q, Partial) else p
                    for p, q in zip(ctx.pls, g.placements))
        if tuple(g.placements) != pls:
            g = g.redistribute(ctx.mesh, pls)
        return g.reshape(ctx.shape), None


def reshape(t, shape) -> torch.Tensor:
    """``t.reshape(shape)``; on a DTensor its gradient is viewed back from
    the result's own layout (:class:`_Reshape`)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t.reshape(shape)
    return _Reshape.apply(t, tuple(shape))


def per_shard(fn, t):
    """``fn(t)``, where ``fn`` keeps ``t``'s shape and mixes no elements
    across a dim that a mesh axis splits (an elementwise op, a scan along a
    dim no axis splits).  A DTensor's shards each go through ``fn`` where
    they lie (``local_map``), so its backward runs on local tensors too:
    DTensor has no rule for some backward ops (``log_sigmoid_backward``;
    ``flip``, in the backward of ``cumsum``, on torch 2.11)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(t, DTensor):
        return fn(t)
    pls = tuple(Replicate() if isinstance(p, Partial) else p for p in t.placements)
    return local_map(fn, out_placements=(pls,), in_placements=(pls,),
                     device_mesh=t.device_mesh, redistribute_inputs=True)(t)


def like(t, ref):
    """``t`` laid out as ``ref`` where both are DTensors (a partial sum of
    ``ref``'s read as replicated), else as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if isinstance(t, DTensor) and isinstance(ref, DTensor):
        pls = tuple(Replicate() if isinstance(p, Partial) else p for p in ref.placements)
        if tuple(t.placements) != pls:
            return t.redistribute(ref.device_mesh, pls)
    return t


def assign(dst, src) -> None:
    """``dst.copy_(src)``, with a DTensor ``src`` laid out as ``dst`` first."""
    from torch.distributed.tensor import DTensor

    if isinstance(dst, DTensor) and isinstance(src, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


# ======================================================================
# activations
# ======================================================================
def logical_shard(x, kind: str):
    """Constrain an activation inside model code: the identity without an
    ambient LM mesh or on a plain tensor; a DTensor is redistributed to the
    kind's fitted placements."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if mesh is None or isinstance(mesh, Mesh) or not isinstance(x, DTensor):
        return x
    b = batch_axes(mesh)
    if kind == "act":  # (B, S, D)
        spec = _fit(mesh, x.shape, (b, None, None))
    elif kind == "logits":  # (B, S, V)
        spec = _fit(mesh, x.shape, (b, None, "model"))
    elif kind == "rows":  # (B, ...) row-batched analysis arrays
        spec = _fit(mesh, x.shape, (b,) + (None,) * (x.ndim - 1))
    else:
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


# ======================================================================
# parameters
# ======================================================================
_PARAM_RULES: list[tuple[str, tuple]] = [
    # (path regex, spec template aligned from the RIGHT; left dims pad None).
    # Two-axis sharding: "model" = tensor/expert parallel, "data" = FSDP /
    # ZeRO-3.
    (r"experts/w_(gate|up)$", ("model", "data", None)),  # (L,E,D,F)
    (r"experts/w_down$", ("model", None, "data")),       # (L,E,F,D)
    (r"router$", (None, None)),                          # replicated (tiny)
    (r"(wq|wk|wv|w_gate|w_up|w_qkv|w_in|w_dt|wq_b|wk_b|wv_b|w_if|wq_a|wkv_a)$",
     ("data", "model")),                                 # (..., D, F)
    (r"(wo|w_down|w_out)$", ("model", "data")),          # (..., F, D)
    (r"r_gates$", ("data", "model")),
    (r"a_log$", ("model", None)),                        # (L, di, n)
    (r"d_skip$", ("model",)),
    (r"w_conv$", (None, "model")),
    (r"(b_up|bq|bk|bv)$", ("model",)),
    (r"(b_down|b_if|norm.*|d_skip)$", (None,)),
    (r"^embed$", ("model", "data")),                     # (V, D)
    (r"^lm_head$", ("data", "model")),                   # (D, V)
    (r"^frontend_proj$", ("data", "model")),
    (r"^final_norm$", (None,)),
]


def param_pspec(path: str, shape, mesh, *, inference: bool = False) -> tuple:
    for pattern, tail in _PARAM_RULES:
        if re.search(pattern, path):
            if inference:
                # weight-stationary serving: no FSDP axis (no per-step
                # gathers); experts spread over (model x data) whole-expert
                if "experts" in path:
                    tail = (("model", "data"), None, None)
                else:
                    tail = tuple(None if a == "data" else a for a in tail)
            full = (None,) * max(0, len(shape) - len(tail)) + tuple(
                tail[-len(shape):] if len(tail) > len(shape) else tail
            )
            return _fit(mesh, shape, full)
    return _fit(mesh, shape, (None,) * len(shape))


def _paths(tree, prefix=""):
    """The ``/``-joined key path of every leaf, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def params_shardings(params, mesh, *, inference: bool = False):
    """A :class:`NamedSharding` for each leaf of a (meta or real) param tree."""
    return tree_unflatten(params, [
        NamedSharding(mesh, param_pspec(path, leaf.shape, mesh, inference=inference))
        for path, leaf in zip(_paths(params), tree_leaves(params))])


# ======================================================================
# decode caches / states / optimizer
# ======================================================================
def cache_pspec(shape, mesh) -> tuple:
    """Shard a decode-cache leaf.

    Cache leaves are stacked per layer: (L, B, ...rest).  Rule: L
    replicated; B -> data when divisible; the first remaining dim divisible
    by the model axis -> model (heads for GQA, sequence for MLA, di for SSM
    states)."""
    b = batch_axes(mesh)
    spec: list = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % _axis_size(mesh, b) == 0:
        spec[1] = _entry(b)
    for dim in range(2, len(shape)):
        if shape[dim] % _axis_size(mesh, "model") == 0:
            spec[dim] = "model"
            break
    return tuple(spec)


def cache_shardings(cache, mesh):
    return tree_map(lambda leaf: NamedSharding(mesh, cache_pspec(leaf.shape, mesh)), cache)


def batch_shardings(batch, mesh):
    b = batch_axes(mesh)
    return tree_map(lambda leaf: NamedSharding(
        mesh, _fit(mesh, leaf.shape, (b,) + (None,) * (len(leaf.shape) - 1))), batch)


def _is_int8_moment(x) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


def opt_state_shardings(opt_state, params, mesh):
    """Shardings for the AdamW state tree.

    float32/bf16 moments mirror their parameter's sharding; an int8
    moment's ``q`` (the parameter's dims, the last padded to the block) and
    ``scale`` (the last dim swapped for the block count) take the
    parameter's spec, the scale's last dim unsharded."""
    param_sh = params_shardings(params, mesh)

    def mom(m_leaf, p_sh):
        if _is_int8_moment(m_leaf):
            q_shape = m_leaf["q"].shape
            base = tuple(p_sh.spec) + (None,) * (len(q_shape) - len(p_sh.spec))
            return {
                "q": NamedSharding(mesh, _fit(mesh, q_shape, base)),
                "scale": NamedSharding(mesh, _fit(mesh, m_leaf["scale"].shape,
                                                  base[:-1] + (None,))),
            }
        return p_sh

    out = {
        "step": NamedSharding(mesh, ()),
        "m": tree_map(mom, opt_state["m"], param_sh, is_leaf=_is_int8_moment),
        "v": tree_map(mom, opt_state["v"], param_sh, is_leaf=_is_int8_moment),
    }
    if "ef" in opt_state:  # error-feedback residuals follow params
        out["ef"] = param_sh
    return out


# ======================================================================
# per-shard calls (the port's shard_map)
# ======================================================================
def lm_mesh(mesh=None):
    """``mesh``, else the ambient mesh if it is an LM ``DeviceMesh``, else None."""
    mesh = mesh if mesh is not None else current_mesh()
    return None if mesh is None or isinstance(mesh, Mesh) else mesh


def local_call(fn, args, in_specs, out_specs, mesh):
    """``fn`` of each rank's local shards of ``args`` laid out by
    ``in_specs``, its outputs read as DTensors laid out by ``out_specs``
    (``local_map``, the port's ``shard_map``).  A plain tensor argument
    counts as replicated over the mesh.  ``fn`` runs the collectives its
    outputs need.

    Gradients: an input replicated over a mesh axis that shards another
    input gets its gradient summed over that axis (each rank computed a
    part of it), as ``shard_map``'s transpose sums an unmapped input's
    cotangents."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    in_pls = [placements(mesh, s) for s in in_specs]
    split = {i for pl in in_pls for i, p in enumerate(pl) if isinstance(p, Shard)}
    grad_pls = [tuple(Partial() if i in split and isinstance(p, Replicate) else p
                      for i, p in enumerate(pl)) for pl in in_pls]
    out_pls = [placements(mesh, s) for s in out_specs]
    args = [a if isinstance(a, DTensor) else
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for a in args]
    return local_map(
        fn, out_placements=tuple(out_pls),
        in_placements=tuple(in_pls), in_grad_placements=tuple(grad_pls),
        device_mesh=mesh, redistribute_inputs=True,
    )(*args)
