"""Multi-pod dry run on ``meta`` tensors (the port of ``repro.launch.dryrun``):
lay every (architecture x input shape) out on the production meshes and
count what one device does in one step.

  single-pod mesh: (16, 16)    axes (data, model)         = 256 devices
  multi-pod mesh : (2, 16, 16) axes (pod, data, model)    = 512 devices

Each cell builds the shape-only params (``init_abstract``), lays them, the
optimizer state and the batch or decode cache out by the LM mesh's rules
(``launch/sharding.py``) as DTensors on the production mesh of a fake
process group (backend ``"fake"``: this process is rank 0 of 256 or 512,
and no collective moves data), and **runs** the real train, prefill or
serve step on them inside :class:`CountingMode`.  Every local tensor lies
on ``meta``: nothing is allocated and nothing is computed, only shapes
flow.  The record (``build/dryrun_torch/<cell>.json``) has the reference's
keys:

  * ``memory``      per-device argument, output, temp and peak bytes
  * ``cost``        per-device flops and bytes accessed
  * ``collectives`` per-device bytes and counts by kind
  * ``roofline``    the three terms (seconds) under the H100 constants of
    ``launch/mesh.py``'s :data:`HW` (data-sheet arithmetic, not a
    measurement) and the dominant one

How the port's figures differ from the reference's (XLA's analysis of the
compiled program):

  * the flops are ``torch.utils.flop_counter``'s (matrix products) plus
    the work of each flash attention and Mamba scan wrapper call, charged
    from ``kernels/work.py`` (the kernel's work on every device: the plain
    version's operations inside the wrapper are not counted);
    elementwise operations count no flops;
  * ``bytes_accessed`` is the local bytes of every counted operation's
    operands and results (views and allocations excluded): eager, unfused
    operations, so it exceeds what XLA reports for a fused program;
  * collectives come from the DTensor plan, the ``_c10d_functional`` and
    ``c10d`` operations one device issues, each counted once as its
    output's local bytes (one over a group of one rank moves nothing and
    is not counted); ``collective_bytes(hlo_text)`` has no counterpart,
    and collective-permute stays 0 (the port issues none);
  * the peak is an estimate, the live local bytes through the step tracked
    by storage, not the allocator's; ``temp_bytes`` is peak less argument;
  * a decode step takes ``cache_len`` as a Python int: it is charged at a
    full cache (``seq_len - 1`` tokens written), what the reference's
    traced lowering covers;
  * eager execution runs every layer and every microbatch, so the
    reference's trip-count correction is not needed (XLA counts a scan
    body once; the port has no scan).  :func:`_probe_costs` is kept as a
    check that the count is linear in the stacks' repeats, and
    ``cost_corrected`` equals ``cost``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

``--device`` is the mesh's device type (default ``cuda``; ``cpu`` on a
host without a card); the local tensors are ``meta`` either way.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import pathlib
import threading
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from ..configs import ARCHS, SHAPES, get_arch, input_specs
from ..configs.base import ArchConfig
from ..kernels import ops
from ..models import transformer as tf
from ..models.blocks import SHAPE_ONLY
from ..optim import AdamWConfig, adamw_init
from ..tree import tree_leaves
from . import sharding as sh
from .mesh import HW, make_production_mesh
from .steps import make_prefill_step, make_serve_step, make_train_step

ART = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: the collective operations one device issues, by kind: DTensor's
#: functional collectives (and their autograd forms) and the in-place c10d
#: operations of ``torch.distributed``'s calls (the MoE layer's)
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
#: operations that only allocate: no byte is read or written
_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def _local(t):
    """A DTensor's local shard; any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _group_size(func, args, kwargs) -> int:
    """The ranks of a collective operation's group, from its schema: a
    ``c10d`` operation's ``ProcessGroup`` argument or a functional one's
    ``group_name``."""
    from torch.distributed.distributed_c10d import ProcessGroup, _resolve_process_group

    for i, arg in enumerate(func._schema.arguments):
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        if "ProcessGroup" in str(arg.type):
            return ProcessGroup.unbox(value).size()
        if arg.name == "group_name":
            return (value if isinstance(value, ProcessGroup)
                    else _resolve_process_group(value)).size()
    raise ValueError(f"{func} names no process group")


def local_bytes(tree) -> int:
    """The local bytes of every tensor leaf of ``tree`` (a DTensor's shard)."""
    return sum(_local(t).nbytes for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class CountingMode(TorchDispatchMode):
    """Per-device flops, bytes accessed, collectives and live bytes of what
    runs inside it.

    A DTensor operation is left to DTensor (``NotImplemented``): its local
    operations come back here with this device's shards.  Only operations
    on ``device`` (the type of the step's local tensors) count: DTensor's
    sharding propagation runs on ``FakeTensor``s at global shapes, and its
    planner's bookkeeping on small CPU tensors, once per new operation
    signature in a process; both are skipped.  Each call of a flash
    attention or Mamba scan wrapper is charged its kernel's work
    (``ops.CHARGE_HOOKS``) and the operations inside it are not counted, so
    a step counts the same on ``meta``, on the CPU and on the card.  Live
    bytes are tracked by storage from the arguments registered with
    :meth:`track`; ``peak`` is their maximum.  :meth:`breakdown` names
    the operations that counted most and the largest tensors made."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = device
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes = {k: 0 for k in _COLLECTIVES}
        self.coll_count = {k: 0 for k in _COLLECTIVES}
        self.charges = collections.Counter()
        self.by_op = collections.defaultdict(lambda: [0, 0, 0])    # flops, bytes, calls
        self.largest = {}           # (op, shape, dtype) -> local bytes of one output
        self.live = self.peak = 0
        self._storages = {}
        # autograd runs a card's backward on a thread of its own: the counts
        # take a lock (re-entered where a storage is freed while it is held),
        # and a charged call quiets its own thread only
        self._lock = threading.RLock()
        self._quiet = threading.local()

    # -- memory ---------------------------------------------------------
    def track(self, tree) -> None:
        """Count every tensor leaf of ``tree`` (local shards) as live."""
        with self._lock:
            for t in tree_leaves(tree):
                if isinstance(t, torch.Tensor):
                    self._add(_local(t))
            self.peak = max(self.peak, self.live)

    def _add(self, t) -> None:
        from torch._subclasses.fake_tensor import FakeTensor

        if not isinstance(t, torch.Tensor) or isinstance(t, FakeTensor):
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            with self._lock:
                if self._storages.pop(key, None) is not None:
                    self.live -= n

        self._storages[key] = weakref.ref(st, freed)
        self.live += n

    # -- the kernels' charges -------------------------------------------
    def _charge(self, name, work, run):
        nbytes, flops = work
        with self._lock:
            self.flops += flops
            self.bytes_accessed += nbytes
            self.charges[name] += 1
            row = self.by_op[f"charged {name}"]
            row[0] += flops
            row[1] += nbytes
            row[2] += 1
        self._quiet.on = True
        try:
            out = run()
        finally:
            self._quiet.on = False
        with self._lock:
            for t in _pytree_leaves(out):
                self._add(t)
            self.peak = max(self.peak, self.live)
        return out

    def __enter__(self):
        ops.CHARGE_HOOKS.append(self._charge)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.CHARGE_HOOKS.remove(self._charge)
        return super().__exit__(*exc)

    # -- the operations -------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        ins = [t for t in _pytree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(self._quiet, "on", False) or any(isinstance(t, FakeTensor) for t in ins):
            return out
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in outs) or \
                all(t.device.type != self.device for t in (*ins, *outs)):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        flops = nbytes = 0
        kind = None
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None and _group_size(func, args, kwargs) == 1:
                kind = None     # a collective over a group of one rank moves nothing
        else:
            if packet in flop_registry:
                flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            if not func.is_view and name not in _ALLOCATIONS:
                nbytes = sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        with self._lock:
            self.flops += flops
            self.bytes_accessed += nbytes
            if kind is not None:
                self.coll_bytes[kind] += sum(t.nbytes for t in outs)
                self.coll_count[kind] += 1
            row = self.by_op[str(func)]
            row[0] += flops
            row[1] += nbytes
            row[2] += 1
            for t in outs:
                self._add(t)
                if t.nbytes > min(self.largest.values(), default=0) or len(self.largest) < 8:
                    self.largest[(str(func), tuple(t.shape), str(t.dtype))] = t.nbytes
                    if len(self.largest) > 8:
                        del self.largest[min(self.largest, key=self.largest.get)]
            self.peak = max(self.peak, self.live)
        return out

    def breakdown(self, n: int = 8) -> dict:
        """The ``n`` operations with the most flops and the most bytes (each
        ``[op, flops, bytes, calls]``) and the largest outputs made (``[op,
        local shape, dtype, bytes]``)."""
        rows = [[op, *v] for op, v in self.by_op.items()]
        return {
            "by_flops": sorted(rows, key=lambda r: -r[1])[:n],
            "by_bytes": sorted(rows, key=lambda r: -r[2])[:n],
            "largest_outputs": [[op, list(shape), dtype, nb] for (op, shape, dtype), nb in
                                sorted(self.largest.items(), key=lambda kv: -kv[1])],
        }

    def collectives(self) -> dict:
        """The reference's ``collectives`` record: bytes and counts by kind."""
        out = {f"bytes_{k}": float(v) for k, v in self.coll_bytes.items()}
        out.update({f"count_{k}": v for k, v in self.coll_count.items()})
        out["bytes_total"] = float(sum(self.coll_bytes.values()))
        return out


def count_step(step, args) -> tuple[dict, object]:
    """``(record parts, step's output)`` of ``step(*args)`` run once inside
    a :class:`CountingMode`: ``memory``, ``cost``, ``collectives`` and the
    kernels' ``charges``.  ``args`` are the step's arguments, on ``meta``
    or on a device, plain or DTensors."""
    argument = local_bytes(args)
    device = next(_local(t).device.type for t in tree_leaves(args) if isinstance(t, torch.Tensor))
    with CountingMode(device) as mode:
        mode.track(args)
        out = step(*args)
    return {
        "memory": {
            "argument_bytes": argument,
            "output_bytes": local_bytes(out),
            "temp_bytes": mode.peak - argument,
            "peak_bytes": mode.peak,
        },
        "cost": {"flops": float(mode.flops), "bytes_accessed": float(mode.bytes_accessed)},
        "collectives": mode.collectives(),
        "charges": dict(mode.charges),
        "breakdown": mode.breakdown(),
    }, out


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on the way out (also on error).  Refuses to start beside a
    real group: a process has one default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "the dry run makes a fake process group of its own and a process group "
            "already exists; run it in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
def _config(arch) -> ArchConfig:
    return arch if isinstance(arch, ArchConfig) else get_arch(arch)


def pick_opt_dtype(cfg) -> str:
    """Optimizer-state dtype policy by model size (DESIGN.md §6)."""
    n = cfg.param_count()
    if n > 50e9:
        return "int8"
    if n > 5e9:
        return "bfloat16"
    return "float32"


def model_flops(cfg, shape_info) -> float:
    """6*N_active*D for train (fwd+bwd), 2*N_active*D for inference."""
    n_active = cfg.active_param_count()
    if shape_info["kind"] == "train":
        tokens = shape_info["seq_len"] * shape_info["global_batch"]
        return 6.0 * n_active * tokens
    if shape_info["kind"] == "prefill":
        tokens = shape_info["seq_len"] * shape_info["global_batch"]
        return 2.0 * n_active * tokens
    tokens = shape_info["global_batch"]  # one token per sequence
    return 2.0 * n_active * tokens


# ----------------------------------------------------------------------
def _batch(cfg, shape, batch_tokens, gen) -> dict:
    """The cell's model inputs (no decode cache), at ``batch_tokens`` =
    ``(batch, seq)`` in place of the shape's if given: ``meta`` for
    :data:`SHAPE_ONLY`, else seeded tokens and embeddings on ``gen``'s
    device."""
    specs, info = input_specs(cfg, shape)
    specs.pop("cache_len", None)
    if batch_tokens is not None:
        b, s = batch_tokens
        n_front = specs["frontend_embeds"].shape[1] if "frontend_embeds" in specs else 0
        sizes = {"tokens": (b, 1 if info["kind"] == "decode" else s - n_front),
                 "labels": (b, s - n_front), "frontend_embeds": (b, n_front, cfg.d_model)}
        specs = {k: torch.empty(sizes[k], dtype=t.dtype, device="meta") for k, t in specs.items()}
    if gen is SHAPE_ONLY:
        return specs
    return {k: (torch.randint(0, cfg.vocab, t.shape, generator=gen, device=gen.device,
                              dtype=t.dtype) if not t.is_floating_point() else
                0.02 * torch.randn(t.shape, generator=gen, device=gen.device).to(t.dtype))
            for k, t in specs.items()}


def cell_step(cfg: ArchConfig, shape: str, mesh, *, opt_dtype=None, accum: int = 1,
              param_dtype=None, batch_tokens=None, gen=SHAPE_ONLY):
    """``(step, args, notes)``: the cell's train, prefill or serve step and
    its arguments laid out on ``mesh`` by the LM mesh's rules, and what the
    record notes about them.  With :data:`SHAPE_ONLY` every local tensor is
    ``meta``; with a ``torch.Generator`` the params, optimizer state, batch
    and cache are real, seeded, on its device (the same step counted on a
    real device).  ``param_dtype`` defaults to the config's activation type
    (``init_abstract``'s); ``batch_tokens`` is ``(batch, seq)`` in place of
    the shape's."""
    info = SHAPES[shape]
    params = tf.init_params(cfg, gen, dtype=param_dtype or cfg.activation_dtype)
    batch = _batch(cfg, shape, batch_tokens, gen)
    if info["kind"] == "train":
        opt = AdamWConfig(state_dtype=opt_dtype or pick_opt_dtype(cfg))
        opt_state = adamw_init(params, opt)
        args = sh.distribute(
            (params, opt_state, batch),
            (sh.params_shardings(params, mesh), sh.opt_state_shardings(opt_state, params, mesh),
             sh.batch_shardings(batch, mesh)))
        return make_train_step(cfg, opt, accum=accum), args, {"grad_accum": accum}
    if info["kind"] == "prefill":
        args = sh.distribute(
            (params, batch), (sh.params_shardings(params, mesh), sh.batch_shardings(batch, mesh)))
        return make_prefill_step(cfg), args, {}
    # decode -- serving: weight-stationary params (no FSDP axis) + whole-
    # expert inference EP; one token against a full cache
    cfg = dataclasses.replace(cfg, inference_ep=True)
    b, s = batch_tokens if batch_tokens is not None else (info["global_batch"], info["seq_len"])
    cache = tf.init_cache(cfg, b, s, device=gen.device)
    params, cache, batch = sh.distribute(
        (params, cache, batch),
        (sh.params_shardings(params, mesh, inference=True), sh.cache_shardings(cache, mesh),
         sh.batch_shardings(batch, mesh)))
    notes = {"cache_len": s - 1,
             "cache_len_note": "a Python int: the step is counted at a full cache, "
                               "seq_len - 1 tokens written"}
    return make_serve_step(cfg), (params, cache, batch["tokens"], s - 1), notes


def lower_cell(arch, shape: str, *, multi_pod: bool, opt_dtype=None,
               unroll: bool = False, repeats_override=None, device: str = "cuda",
               mesh=None, param_dtype=None, batch_tokens=None):
    """Lay one (arch, shape, mesh) cell out on ``meta`` and count one step;
    return the record.  ``arch`` is a name or an ``ArchConfig``.

    Without ``mesh`` the cell runs on the production mesh (of device type
    ``device``) of a fake world of 256 or 512 ranks that this call makes and
    destroys; with one (a ``DeviceMesh`` of the caller's group) it runs
    there.  ``repeats_override`` sets each stack's repeat count (the probes
    of :func:`_probe_costs`); ``unroll`` is recorded and changes nothing
    (the port always runs its layers one by one).  ``param_dtype`` and
    ``batch_tokens`` are :func:`cell_step`'s: they hold a cell to another
    run's arguments (``model_flops`` stays the shape's).
    """
    cfg = _config(arch)
    arch = cfg.name
    if repeats_override is not None:
        cfg = dataclasses.replace(
            cfg,
            layer_unroll=True,
            stacks=tuple(
                (int(r), specs)
                for r, (_, specs) in zip(repeats_override, cfg.stacks)
            ),
        )
    elif unroll:
        cfg = dataclasses.replace(cfg, layer_unroll=True)
    info = SHAPES[shape]
    if shape == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape, "skipped": "quadratic-attention"}

    world = contextlib.nullcontext() if mesh is not None else fake_world(512 if multi_pod else 256)
    with world:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        sizes = sh.axis_sizes(mesh)
        record = {
            "arch": arch, "shape": shape,
            "mesh": "x".join(str(n) for n in sizes.values()),
            "chips": math.prod(sizes.values()),
        }
        t0 = time.time()
        # microbatch big models so the activation stash fits; probes count
        # with accum=1
        accum = 1 if repeats_override is not None else (16 if cfg.param_count() > 30e9 else 1)
        step, args, notes = cell_step(cfg, shape, mesh, opt_dtype=opt_dtype, accum=accum,
                                      param_dtype=param_dtype, batch_tokens=batch_tokens)
        record.update(notes)
        with sh.use_mesh(mesh):
            parts, _ = count_step(step, args)
        record.update(parts)
        record["run_s"] = round(time.time() - t0, 1)

    record["roofline"] = roofline_terms(record, cfg, info, record["chips"])
    record["model_flops"] = model_flops(cfg, info)
    record["params_total"] = cfg.param_count()
    record["params_active"] = cfg.active_param_count()
    return record


def roofline_terms(record, cfg, info, n_chips) -> dict:
    flops = float(record["cost"]["flops"])
    bytes_acc = float(record["cost"]["bytes_accessed"])
    coll = float(record["collectives"]["bytes_total"])
    # the counts are one device's: flops and bytes per device, collective
    # bytes the outputs of the collectives one device issues
    t_compute = flops / HW["peak_flops_bf16"]
    t_memory = bytes_acc / HW["hbm_bw"]
    t_collective = coll / HW["ici_bw"]
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
    }


# ----------------------------------------------------------------------
def _probe_costs(arch, shape, *, multi_pod, opt_dtype, device="cuda", batch_tokens=None):
    """The reference's probe differencing (all stack repeats at 1, then each
    stack at 2), kept as a check: eager execution counts every layer, so
    ``probe1 + sum_k (repeat_k - 1) * body_k`` must equal the direct count
    of a step at ``accum`` 1."""
    repeats = [r for r, _ in _config(arch).stacks]
    kw = dict(multi_pod=multi_pod, opt_dtype=opt_dtype, device=device, batch_tokens=batch_tokens)
    base = lower_cell(arch, shape, repeats_override=[1] * len(repeats), **kw)
    if "skipped" in base:
        return None
    flops = float(base["cost"]["flops"])
    bytes_acc = float(base["cost"]["bytes_accessed"])
    coll = dict(base["collectives"])
    probes = {"probe1": base["cost"] | {"coll": base["collectives"]["bytes_total"]}}
    for k, r_k in enumerate(repeats):
        if r_k == 1:
            continue
        reps = [1] * len(repeats)
        reps[k] = 2
        pk = lower_cell(arch, shape, repeats_override=reps, **kw)
        flops += (r_k - 1) * (float(pk["cost"]["flops"]) - float(base["cost"]["flops"]))
        bytes_acc += (r_k - 1) * (float(pk["cost"]["bytes_accessed"])
                                  - float(base["cost"]["bytes_accessed"]))
        for key in coll:
            if key.startswith("count_") or (key.startswith("bytes_") and key != "bytes_total"):
                coll[key] += (r_k - 1) * (pk["collectives"][key] - base["collectives"][key])
        probes[f"probe_stack{k}"] = pk["cost"] | {"coll": pk["collectives"]["bytes_total"]}
    coll["bytes_total"] = sum(
        v for k, v in coll.items() if k.startswith("bytes_") and k != "bytes_total"
    )
    return {
        "flops": flops,
        "bytes_accessed": bytes_acc,
        "collectives": coll,
        "probes": probes,
    }


def run_cell(arch, shape, *, multi_pod, opt_dtype=None, tag="", unroll=False,
             probes=True, device="cuda"):
    """Count one cell (``arch`` a name), write its record and print its
    line.  ``cost_corrected`` equals ``cost`` (the module docstring); with
    ``probes`` the probes' sums are recorded beside it, and
    ``probes_equal_cost`` says whether they equal the direct count."""
    name = f"{arch}__{shape}__{'512' if multi_pod else '256'}"
    if unroll:
        name += "__unroll"
    name += tag
    ART.mkdir(parents=True, exist_ok=True)
    path = ART / f"{name}.json"
    t0 = time.time()
    try:
        if SHAPES[shape]["kind"] == "decode" and not unroll:
            unroll = True
        rec = lower_cell(arch, shape, multi_pod=multi_pod, opt_dtype=opt_dtype,
                         unroll=unroll, device=device)
        rec["unroll"] = unroll
        if "skipped" not in rec:
            rec["cost_corrected"] = dict(rec["cost"])
            rec["collectives_corrected"] = dict(rec["collectives"])
        # the probes count at accum 1: a check of the cells whose step has no
        # microbatches
        if probes and not unroll and "skipped" not in rec and rec.get("grad_accum", 1) == 1:
            corrected = _probe_costs(arch, shape, multi_pod=multi_pod, opt_dtype=opt_dtype,
                                     device=device)
            if corrected is not None:
                rec["probes"] = corrected["probes"]
                rec["probe_sums"] = {"flops": corrected["flops"],
                                     "bytes_accessed": corrected["bytes_accessed"],
                                     "collectives": corrected["collectives"]}
                rec["probes_equal_cost"] = (
                    corrected["flops"] == rec["cost"]["flops"]
                    and corrected["bytes_accessed"] == rec["cost"]["bytes_accessed"]
                    and corrected["collectives"] == rec["collectives"])
    except Exception as e:  # record failures: they are faults to repair
        rec = {
            "arch": arch, "shape": shape, "multi_pod": multi_pod,
            "unroll": unroll,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    rec["wall_s"] = round(time.time() - t0, 1)
    path.write_text(json.dumps(rec, indent=2, default=float))
    status = rec.get("error", rec.get("skipped", "ok"))
    print(f"[dryrun] {name}: {status} ({rec['wall_s']} s)", flush=True)
    return rec


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--opt-dtype", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--unroll", action="store_true",
                    help="recorded only: the port always runs its layers one by one")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type: cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the cells the arguments name; returns their records."""
    args = parse_args(argv)
    cells = []
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cells.append((arch, shape, mp))

    ok, records = 0, []
    for arch, shape, mp in cells:
        # probes only on the single-pod mesh: the multi-pod pass proves the
        # pod axis shards
        rec = run_cell(arch, shape, multi_pod=mp, opt_dtype=args.opt_dtype,
                       tag=args.tag, unroll=args.unroll, probes=not mp, device=args.device)
        records.append(rec)
        if "error" not in rec:
            ok += 1
    print(f"[dryrun] {ok}/{len(cells)} cells OK")
    return records


if __name__ == "__main__":
    main()
