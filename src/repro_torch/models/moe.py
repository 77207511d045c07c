"""Mixture-of-Experts layer (the port of ``repro.models.moe``).

Fine-grained experts with optional shared experts and top-k routing, four
dispatch modes:

* ``onehot``       GShard-classic dense dispatch/combine einsums with a
  (tokens, E, C) one-hot tensor;
* ``gather``       capacity dispatch by gather and scatter;
* ``shard_map``    expert parallelism on an LM mesh (training): tokens stay
  sharded over the batch axes and replicated over ``"model"``; each rank
  dispatches its tokens to its E/model expert slice, whose weights it
  all-gathers over ``"data"`` (FSDP) inside the body, and an all-reduce
  over ``"model"`` combines the partial outputs;
* ``inference_ep`` weight-stationary serving: whole experts per rank over
  ``("model", "data")``, the decode tokens replicated, one all-reduce over
  both axes.

The two expert-parallel modes run :func:`_local_moe` on each rank's shards
through ``launch.sharding.local_call`` (``local_map``, the port's
``shard_map``).  Its collectives are differentiable: the FSDP all-gather's
backward is a reduce-scatter, so the weight gradient leaves data-sharded;
the combine's all-reduce passes the replicated cotangent through; the aux
loss is a mean over the mesh, its backward the cotangent over the ranks.  Expert
ranks are linearised over the expert axes in the mesh's order, DTensor's
layout of a multi-axis dim (``launch/sharding.py``).

Without a mesh the reference runs ``shard_map`` as ``gather`` and ignores
``inference_ep``; so does the port.  All modes drop tokens beyond an
expert's capacity and return the switch-style load-balancing aux loss.
The reference's MoE has no Pallas kernel: it is plain JAX.  The port's
``gather`` mode adds one route of its own where the weights bound the
experts (decode: a few choices an expert): the kept-row kernel pair
(``ops.moe_gate_up``, ``ops.moe_down``) computes the kept choices' rows
alone and reads only the experts they were routed to, in place of the
padded (E, C, D) GEMMs (:func:`_kept_rows`).

While a profiler collects (``obs``), each mode marks its routing, dispatch,
experts and combine as spans (``moe.route``, ``moe.dispatch``,
``moe.experts``, ``moe.combine``; ``moe.shared`` the shared experts) and
counts the choices, the expert rows it computes, the choices kept within
capacity and the experts with a kept choice (this rank's under a mesh).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import obs
from ..kernels import ops
from ..launch import sharding as sh
from .blocks import init_linear, init_swiglu, mm, swiglu_ffn


def init_moe(gen, cfg, *, stack=(), dtype=torch.float32):
    d, e, fe = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    p = {
        "router": init_linear(gen, d, e, stack=stack, dtype=dtype),
        "experts": init_swiglu(gen, d, fe, stack=(*stack, e), dtype=dtype),
    }
    if cfg.moe_shared > 0:
        p["shared"] = init_swiglu(gen, d, fe * cfg.moe_shared, stack=stack, dtype=dtype)
    return p


def _routing(p, x, cfg):
    """Top-k gates (T, k) in x's dtype, expert ids (T, k) and the aux loss.

    Ties keep the lower expert id first, as ``jax.lax.top_k`` does (a
    stable descending sort)."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    with obs.span("moe.route", x):
        logits = mm(x, p["router"]).float()                  # (T, E)
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[:, :k], idx[:, :k]
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        # switch aux loss: E * sum_e (frac_tokens_e * mean_prob_e)
        onehot_top1 = F.one_hot(idx[:, 0], e).float()
        aux = e * torch.mean(onehot_top1.mean(dim=0) * probs.mean(dim=0))
        return gates.to(x.dtype), idx, aux


def _capacity(cfg, tokens: int) -> int:
    c = int(tokens * cfg.moe_top_k * cfg.moe_capacity / cfg.moe_experts)
    return max(c, 4)


#: the most choices an expert, T * k / E on average, at which ``gather``
#: runs the experts on the kept rows alone (:func:`_kept_rows`).  A float32
#: weight element does 2 flops for each row that reads it, against its 4
#: bytes; the card's float32 ridge is 67 TFLOP/s over 3.35 TB/s, 20 flop/B,
#: which 40 rows reach.  Under it the weights' bytes bound the experts and
#: the padded GEMMs compute rows nobody reads; above it they are
#: compute-bound, and a GEMM is the right tool.  Timed on an H100 against
#: the padded route (``tools/moe_kept_ab.py``, capacity 1.25, jamba's and
#: deepseek-v3's layers), the pair is 1.45-2.0 x as fast at 1 to 8 rows,
#: 1.12 x at 16, and at 32 already 6 % slower at jamba's (an expert past
#: 32 rows reads its weights again), so the route stops at 16.
R_MAX = 16


def _kept_rows(x, ex, cfg) -> bool:
    """Whether ``gather`` runs the experts by the kept-row kernels: no
    gradient is recorded (they have no backward), x and the weights are
    float32 (the type the kernels take) and the mean choices an expert are
    at most :data:`R_MAX`."""
    ws = (ex["w_gate"], ex["w_up"], ex["w_down"])
    return (not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, *ws)))
            and all(t.dtype == torch.float32 for t in (x, *ws))
            and x.shape[0] * cfg.moe_top_k <= R_MAX * cfg.moe_experts)


def _positions(flat_idx, e: int):
    """Each choice's place among the earlier choices of its expert, in flat
    order (T*k,)."""
    oh = F.one_hot(flat_idx, e)
    return (torch.cumsum(oh, dim=0) - oh).gather(1, flat_idx[:, None])[:, 0]


def _count_routing(choices: int, rows: int, pos, capacity: int, valid=None) -> None:
    """The routing's counters, while ``obs`` records (off, no op runs), from
    ``pos``, each choice's place in its expert (``valid`` the choices of
    this rank's experts): see :func:`_count`.  An expert's first choice
    (position 0) is kept whenever it has one, since the capacity is at
    least 4."""
    if obs.enabled():
        keep, first = pos < capacity, pos == 0
        if valid is not None:
            keep &= valid
            first &= valid
        _count(choices, rows, keep.sum(), first.sum())


def _count(choices: int, rows: int, kept, hit) -> None:
    """``moe.choices`` (tokens x top-k) and the expert ``moe.rows`` (experts
    x capacity, on every route) from the host; ``moe.kept``, the choices
    kept within capacity, and ``moe.experts_hit``, the experts with a kept
    choice, as device counts."""
    obs.count("moe.choices", choices)
    obs.count("moe.rows", rows)
    obs.count("moe.kept", kept)
    obs.count("moe.experts_hit", hit)


def _run_experts(p, expert_in):
    """Per-expert SwiGLU over (E, C, D) with stacked weights (E, D, F)."""
    ex = p["experts"]
    h = F.silu(mm(expert_in, ex["w_gate"])) * mm(expert_in, ex["w_up"])
    return mm(h, ex["w_down"])


def _einsum(eq, *ops):
    """``torch.einsum`` in the promoted type of its operands, as JAX's."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


def _dispatch_onehot(p, x, gates, idx, cfg):
    """GShard dense dispatch: (T, E, C) mask einsums."""
    t = x.shape[0]
    e = cfg.moe_experts
    c = _capacity(cfg, t)
    with obs.span("moe.dispatch", x):
        oh_e = F.one_hot(idx, e)                              # (T, k, E) int64
        flat = oh_e.reshape(-1, e)
        pos = (torch.cumsum(flat, dim=0) - flat) * flat
        pos = pos.sum(dim=-1).reshape(idx.shape)              # (T, k)
        # a position past the capacity matches no slot: the choice is dropped
        oh_c = (pos[..., None] == torch.arange(c, device=x.device)).to(x.dtype)
        oh_e = oh_e.to(x.dtype)
        dispatch = _einsum("tke,tkc->tec", oh_e, oh_c)
        expert_in = _einsum("tec,td->ecd", dispatch, x)
    _count_routing(idx.numel(), e * c, pos, c)
    with obs.span("moe.experts", x):
        expert_out = _run_experts(p, expert_in)
    with obs.span("moe.combine", x):
        combine = _einsum("tke,tkc,tk->tec", oh_e, oh_c, gates)
        return _einsum("tec,ecd->td", combine, expert_out)


def _pad(x, idx, e: int, c: int):
    """The padded route's dispatch: ``(buf, slot, keep, pos)``, buf (E, C, D)
    each expert's first C choices' rows of x in flat order and zeros after;
    slot each choice's row of buf flattened, e*c for a dropped one; keep
    whether it was kept; pos its place among its expert's choices."""
    t, d = x.shape
    flat_idx = idx.reshape(-1)                                # (T*k,)
    pos = _positions(flat_idx, e)
    keep = pos < c
    # every dropped choice writes the overflow row e*c, which is discarded
    slot = torch.where(keep, flat_idx * c + pos, e * c)
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x.repeat_interleave(idx.shape[1], dim=0)     # jnp.repeat(x, k, axis=0)
    return buf[:e * c].reshape(e, c, d), slot, keep, pos


def _dispatch_gather(p, x, gates, idx, cfg):
    """Capacity dispatch by scatter and gather (no dense (T, E, C) einsum)."""
    t, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    c = _capacity(cfg, t)
    if _kept_rows(x, p["experts"], cfg):
        return _dispatch_kept(p, x, gates, idx, cfg, c)
    with obs.span("moe.dispatch", x):
        buf, slot, keep, pos = _pad(x, idx, e, c)
    _count_routing(t * k, e * c, pos, c)
    with obs.span("moe.experts", x):
        expert_out = _run_experts(p, buf).reshape(e * c, d)
    with obs.span("moe.combine", x):
        expert_out = torch.cat([expert_out, expert_out.new_zeros((1, d))])
        w = gates.reshape(-1)[:, None] * keep[:, None].to(gates.dtype)
        picked = expert_out[slot] * w
        return picked.reshape(t, k, -1).sum(dim=1)


def _dispatch_kept(p, x, gates, idx, cfg, c):
    """``gather``'s experts on the kept choices' rows alone: each choice's
    SwiGLU row (0 where its expert was full) from the kept-row kernel pair,
    which finds its rows in ``idx`` and reads only the experts hit; the
    combine as the padded route's."""
    t, k = idx.shape
    ex = p["experts"]
    with obs.span("moe.dispatch", x):
        # the kernels need no buffer: the index work left is the record's,
        # from each expert's load (one scatter-add, no host sync)
        if obs.enabled():
            e, flat = cfg.moe_experts, idx.reshape(-1)
            load = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
                0, flat, torch.ones_like(flat))
            _count(t * k, e * c, load.clamp(max=c).sum(), (load > 0).sum())
    with obs.span("moe.experts", x):
        h = ops.moe_gate_up(x, idx, ex["w_gate"], ex["w_up"], capacity=c)
        out = ops.moe_down(h, idx, ex["w_down"], capacity=c)
    with obs.span("moe.combine", x):
        return (out * gates.reshape(-1)[:, None]).reshape(t, k, -1).sum(dim=1)


# ----------------------------------------------------------------------
# explicit expert parallelism
# ----------------------------------------------------------------------
class _AllReduce(torch.autograd.Function):
    """Sum over the process groups ``groups``, times ``scale``; the backward
    passes the (replicated) cotangent through, times ``scale``."""

    @staticmethod
    def forward(ctx, t, groups, scale):
        out = t.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        ctx.scale = scale
        return out * scale if scale != 1 else out

    @staticmethod
    def backward(ctx, grad):
        return (grad * ctx.scale if ctx.scale != 1 else grad), None, None


class _AllGather(torch.autograd.Function):
    """Concatenate the group's shards along ``dim``; the backward is a
    reduce-scatter of the cotangent over the group along ``dim``."""

    @staticmethod
    def forward(ctx, t, group, dim):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        ctx.group, ctx.dim = group, dim
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        chunks = [c.contiguous() for c in grad.chunk(dist.get_world_size(ctx.group), dim=ctx.dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=ctx.group)
        return out, None, None


def _local_moe(x_loc, router, w_gate, w_up, w_down, *, cfg, mesh, expert_axes=("model",),
               gather_data=True):
    """Per-shard body: x_loc (T_loc, D) this rank's tokens; w_* this rank's
    expert slice, D-sharded over ``"data"`` when ``gather_data`` (training
    FSDP: gathered here, so the weight gradient leaves data-sharded).
    Returns (y_loc, aux): y summed over the expert axes, aux the mean of
    the ranks' aux losses (per-shard routing statistics, as the
    reference's ``pmean``)."""
    t, d = x_loc.shape
    k = cfg.moe_top_k
    if gather_data:
        g = mesh.get_group("data")
        w_gate = _AllGather.apply(w_gate, g, 1)
        w_up = _AllGather.apply(w_up, g, 1)
        w_down = _AllGather.apply(w_down, g, 2)
    e_loc = w_gate.shape[0]
    c = _capacity(cfg, t)

    gates, idx, aux = _routing({"router": router}, x_loc, cfg)
    sizes, coord = sh.axis_sizes(mesh), mesh.get_coordinate()
    rank = 0
    for i, ax in enumerate(sizes):      # linearised in the mesh's axis order
        if ax in expert_axes:
            rank = rank * sizes[ax] + coord[i]
    with obs.span("moe.dispatch", x_loc):
        rel = idx - rank * e_loc                              # (T, k)
        valid = (rel >= 0) & (rel < e_loc)

        # position within each LOCAL expert; choices of other ranks' experts
        # go to a trash row e_loc
        safe_rel = torch.where(valid, rel, e_loc)
        flat = safe_rel.reshape(-1)
        oh = F.one_hot(flat, e_loc + 1)
        pos = (torch.cumsum(oh, dim=0) - oh).gather(1, flat[:, None])[:, 0]
        keep = (valid.reshape(-1) & (pos < c)).reshape(t, k)
        slot = torch.where(keep, safe_rel * c + pos.reshape(t, k), e_loc * c)

        # dispatch per choice (k scatters of (T, D)): never the (T*k, D) repeat
        buf = x_loc.new_zeros((e_loc * c + 1, d))
        for j in range(k):
            buf[slot[:, j]] = x_loc
        expert_in = buf[:e_loc * c].reshape(e_loc, c, d)
    _count_routing(t * k, e_loc * c, pos, c, valid.reshape(-1))
    with obs.span("moe.experts", x_loc):
        h = F.silu(mm(expert_in, w_gate)) * mm(expert_in, w_up)
        expert_out = mm(h, w_down).reshape(e_loc * c, -1)
    with obs.span("moe.combine", x_loc):
        expert_out = torch.cat([expert_out, expert_out.new_zeros((1, expert_out.shape[1]))])
        y_partial = expert_out.new_zeros((t, expert_out.shape[1]))
        for j in range(k):
            w = (gates[:, j] * keep[:, j]).to(x_loc.dtype)[:, None]
            y_partial = y_partial + expert_out[slot[:, j]] * w
        groups = [mesh.get_group(ax) for ax in sizes if ax in expert_axes]
        y = _AllReduce.apply(y_partial, groups, 1)
    aux = _AllReduce.apply(aux, [mesh.get_group(ax) for ax in sizes], 1.0 / mesh.size())
    return y, aux


def _expert_specs(p, mesh, specs):
    return [sh._fit(mesh, p["experts"][name].shape, spec)
            for name, spec in zip(("w_gate", "w_up", "w_down"), specs)]


def _dispatch_shard_map(p, x, cfg, mesh):
    """Expert-parallel MoE over ``mesh`` (training). x: (T, D) global."""
    b_ax = sh.batch_axes(mesh)
    w_specs = _expert_specs(p, mesh, (("model", "data", None),) * 2 + (("model", None, "data"),))
    body = functools.partial(_local_moe, cfg=cfg, mesh=mesh,
                             gather_data=w_specs[0][1] == "data")
    ex = p["experts"]
    return sh.local_call(
        body, (x, p["router"], ex["w_gate"], ex["w_up"], ex["w_down"]),
        [(b_ax, None), (None, None), *w_specs], [(b_ax, None), ()], mesh)


def _dispatch_inference_ep(p, x, cfg, mesh):
    """Serving-time expert placement (weight-stationary, no per-step weight
    movement).

    * E divisible by model*data: whole experts per rank over both axes; the
      (small) decode token batch is replicated and one all-reduce over both
      axes combines.
    * otherwise: experts over the model axis only (whole-D slices, no FSDP
      gathers); tokens stay data-sharded when divisible, else replicated.
    """
    sizes = sh.axis_sizes(mesh)
    b_ax = sh.batch_axes(mesh)
    n_model, n_data = sizes["model"], math.prod(sizes[a] for a in b_ax)
    if cfg.moe_experts % (n_model * n_data) == 0:
        ep_axes, tok_spec = ("model", "data"), (None, None)
    else:
        ep_axes = ("model",)
        tok_spec = (b_ax, None) if x.shape[0] % n_data == 0 else (None, None)
    body = functools.partial(_local_moe, cfg=cfg, mesh=mesh, expert_axes=ep_axes,
                             gather_data=False)
    w_spec = (ep_axes if len(ep_axes) > 1 else ep_axes[0], None, None)
    ex = p["experts"]
    return sh.local_call(
        body, (x, p["router"], ex["w_gate"], ex["w_up"], ex["w_down"]),
        [tok_spec, (None, None), w_spec, w_spec, w_spec], [tok_spec, ()], mesh)


def _replicated(fn, args, mesh):
    """``fn`` on the whole of ``args`` on every rank of ``mesh`` (the
    unsharded dispatch under a mesh: the reference's GSPMD replicates it)."""
    if mesh is None:
        return fn(*args)
    specs = [(None,) * a.dim() for a in args]
    return sh.local_call(fn, args, specs, [(None, None), ()], mesh)


# ----------------------------------------------------------------------
def moe_forward(p, x, cfg, *, mesh=None):
    """x: (B, S, D) -> (y, aux_loss).

    ``mesh`` (else the ambient LM mesh of ``use_mesh``) picks the
    expert-parallel dispatch as the reference does: ``inference_ep`` when
    the config asks for it and the experts divide over ``"model"``;
    ``shard_map`` when the experts divide over ``"model"`` and the tokens
    over the batch axes; else ``gather``, replicated on every rank.  Under
    a mesh the tensors are DTensors on it (under ``use_mesh`` plain ones
    count as replicated).  Without a mesh ``shard_map`` runs as ``gather``
    and ``inference_ep`` is ignored."""
    mesh = sh.lm_mesh(mesh)
    b, s, d = x.shape
    # its gradient, summed over the dispatch and the shared experts, is laid
    # out as flat before it is viewed back as (B, S, D)
    flat = sh.reshape(x, (b * s, d))
    dispatch = cfg.moe_dispatch
    if dispatch not in ("onehot", "gather", "shard_map"):
        raise ValueError(f"unknown moe_dispatch {dispatch!r}")
    if mesh is not None:
        sizes = sh.axis_sizes(mesh)
        n_data = math.prod(sizes[a] for a in sh.batch_axes(mesh))
        if cfg.inference_ep and cfg.moe_experts % sizes["model"] == 0:
            dispatch = "inference_ep"
        elif dispatch == "shard_map" and (cfg.moe_experts % sizes["model"]
                                          or flat.shape[0] % n_data):
            dispatch = "gather"  # indivisible experts, or e.g. a batch-1 decode
    if dispatch == "inference_ep":
        y, aux = _dispatch_inference_ep(p, flat, cfg, mesh)
    elif dispatch == "shard_map" and mesh is not None:
        y, aux = _dispatch_shard_map(p, flat, cfg, mesh)
    else:
        dispatch_fn = _dispatch_onehot if dispatch == "onehot" else _dispatch_gather

        def run(flat, router, w_gate, w_up, w_down):
            q = {"router": router, "experts": {"w_gate": w_gate, "w_up": w_up,
                                               "w_down": w_down}}
            gates, idx, aux = _routing(q, flat, cfg)
            return dispatch_fn(q, flat, gates, idx, cfg), aux

        ex = p["experts"]
        y, aux = _replicated(run, (flat, p["router"], ex["w_gate"], ex["w_up"], ex["w_down"]),
                             mesh)
    if "shared" in p:
        with obs.span("moe.shared", flat):
            y = y + swiglu_ffn(p["shared"], flat)
    # back in the tokens' layout: the sum may shard the tokens over more
    # axes than the batch's, which B x S cannot split into
    return sh.like(y, flat).reshape(b, s, -1), aux
