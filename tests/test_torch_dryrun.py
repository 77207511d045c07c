"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
reference's pure functions, hand counts and real steps, on the CPU.

The reference's ``lower_cell`` cannot run here (JAX 0.9.0 breaks its mesh
path, ROADMAP queue 3) and left no records, so the port is held to:
``pick_opt_dtype`` and ``model_flops`` of every architecture and shape,
``roofline_terms`` under the port's H100 constants; per-device flops,
collective bytes and counts of hand-sized products and redistributions on
a fake (4, 4) mesh; one step counted on ``meta`` against the same step on
real CPU tensors in a world of one rank; the probe differencing against
the direct count; and every reduced architecture laid out on the fake
(16, 16) production mesh.  Counts are integers: every comparison is exact.

The reference module sets ``XLA_FLAGS`` (512 host devices) when it is
imported; it is imported after ``jax.devices()`` has fixed this process's
backend, and the variable is put back at once, so later backends and
subprocesses of the worker do not see it.
"""

import ast
import dataclasses
import os
import pathlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_arch as r_get_arch

from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch, reduced
from repro_torch.core import pipeline as tpipe
from repro_torch.kernels import ops, ref, work
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the record keys of the reference's lower_cell (its lower_s and compile_s
#: have the port's run_s in their place)
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "memory", "cost", "collectives", "roofline",
               "model_flops", "params_total", "params_active"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
ROOFLINE_KEYS = {"t_compute_s", "t_memory_s", "t_collective_s", "dominant"}


@pytest.fixture(scope="module")
def rdry():
    """The reference's ``repro.launch.dryrun``, imported with this process's
    backend already fixed and ``XLA_FLAGS`` put back as it was."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


@pytest.fixture
def fake_world():
    """A fake process group of 16 ranks and its (4, 4) ("data", "model")
    mesh; the group is destroyed afterwards."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.fixture
def world_of_one():
    """A world of one gloo rank in this process and its (1, 1) LM mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield tmesh.make_local_mesh("cpu")
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the reference's arithmetic
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_opt_dtype_and_model_flops_match_reference(rdry, arch, shape):
    cfg, rcfg = get_arch(arch), r_get_arch(arch)
    assert dryrun.pick_opt_dtype(cfg) == rdry.pick_opt_dtype(rcfg)
    assert dryrun.model_flops(cfg, SHAPES[shape]) == rdry.model_flops(rcfg, rdry.SHAPES[shape])


@pytest.mark.parametrize("dominant", ["compute", "memory", "collective"])
def test_roofline_terms_match_reference_under_h100_constants(rdry, monkeypatch, dominant):
    monkeypatch.setattr(rdry, "HW", dict(tmesh.HW))
    big = {"compute": (3e15, 1e9, 1e6), "memory": (1e9, 5e13, 1e6),
           "collective": (1e9, 1e9, 7e11)}[dominant]
    record = {"cost": {"flops": big[0], "bytes_accessed": big[1]},
              "collectives": {"bytes_total": big[2]}}
    cfg, rcfg = get_arch("qwen2-1.5b"), r_get_arch("qwen2-1.5b")
    ours = dryrun.roofline_terms(record, cfg, SHAPES["train_4k"], 256)
    assert ours == rdry.roofline_terms(record, rcfg, rdry.SHAPES["train_4k"], 256)
    assert ours["dominant"] == dominant


def _chip_smoke_constants() -> dict:
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    return {t.id: node.value.value for node in tree.body if isinstance(node, ast.Assign)
            for t in node.targets if isinstance(t, ast.Name)
            and isinstance(node.value, ast.Constant)}


def test_h100_constants_agree_in_all_three_places():
    smoke = _chip_smoke_constants()
    hw = tmesh.HW
    assert hw["peak_flops_bf16"] == tpipe.PEAK_FLOPS == smoke["BF16_FLOPS_PER_S"] == 989e12
    assert hw["hbm_bw"] == smoke["HBM_BYTES_PER_S"] == 3.35e12
    assert hw["ici_bw"] == tpipe.LINK_BW == 450e9
    assert hw["hbm_bytes"] == tpipe.HBM_BYTES == 80e9


# ----------------------------------------------------------------------
# the counting mode on hand cases
# ----------------------------------------------------------------------
def _meta_dtensor(shape, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.empty(shape, device="meta"), mesh, placements,
                             src_data_rank=None)


def test_counting_mode_products_are_per_device(fake_world):
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake_world
    # column-parallel: x (64, 128) rows over data, w (128, 256) columns over
    # model: each device multiplies (16, 128) by (128, 64)
    x = _meta_dtensor((64, 128), mesh, [Shard(0), Replicate()])
    w = _meta_dtensor((128, 256), mesh, [Replicate(), Shard(1)])
    with dryrun.CountingMode() as mode:
        y = x @ w
    assert mode.flops == 2 * 16 * 128 * 64 == 262_144
    assert y.to_local().shape == (16, 64)
    assert mode.collectives()["bytes_total"] == 0
    # row-parallel: x (64, 256) columns over model, w (256, 128) rows over
    # model: (16, 64) by (64, 128) a device, then the partial sums' all-reduce
    x = _meta_dtensor((64, 256), mesh, [Shard(0), Shard(1)])
    w = _meta_dtensor((256, 128), mesh, [Replicate(), Shard(0)])
    with dryrun.CountingMode() as mode:
        y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
    assert mode.flops == 2 * 16 * 64 * 128 == 262_144
    coll = mode.collectives()
    assert coll["count_all-reduce"] == 1 and coll["bytes_all-reduce"] == 16 * 128 * 4
    assert coll["bytes_total"] == 16 * 128 * 4
    assert y.to_local().shape == (16, 128)


def test_counting_mode_collectives_by_kind_once_each(fake_world):
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = fake_world
    w = _meta_dtensor((128, 256), mesh, [Replicate(), Shard(1)])
    with dryrun.CountingMode() as mode:
        full = w.redistribute(mesh, [Replicate(), Replicate()])
    coll = mode.collectives()
    # the gathered (128, 256) float32 tensor, once
    assert coll["count_all-gather"] == 1 and coll["bytes_all-gather"] == 128 * 256 * 4
    assert coll["bytes_total"] == 128 * 256 * 4
    assert mode.flops == 0 and full.to_local().shape == (128, 256)

    from torch.distributed.tensor import DTensor
    p = DTensor.from_local(torch.empty((8, 32), device="meta"), mesh, [Replicate(), Partial()],
                           run_check=False)
    with dryrun.CountingMode() as mode:
        s = p.redistribute(mesh, [Replicate(), Shard(0)])
    coll = mode.collectives()
    assert coll["count_reduce-scatter"] == 1 and coll["bytes_reduce-scatter"] == 2 * 32 * 4
    assert coll["count_all-reduce"] == coll["count_all-gather"] == 0
    assert s.to_local().shape == (2, 32)
    # an in-place c10d all-reduce over the model axis's group (the MoE
    # layer's), and one over a group of one rank, which moves nothing
    t = torch.empty((8, 8), device="meta")
    with dryrun.CountingMode() as mode:
        dist.all_reduce(t, group=mesh.get_group("model"))
    assert mode.collectives()["count_all-reduce"] == 1
    assert mode.collectives()["bytes_all-reduce"] == 8 * 8 * 4


def test_counting_mode_charges_the_kernels_work():
    """K6 4 D flops a kept pair and query head; K7's route the work of its
    one walk; the plain versions' operations inside the wrappers are not
    counted, on meta or on the CPU."""
    g = torch.Generator().manual_seed(0)
    b, hq, hkv, s, d = 2, 4, 2, 40, 64
    q_cpu = torch.randn((b, hq, s, d), generator=g)
    kv_cpu = torch.randn((b, hkv, s, d), generator=g)
    for dev in ("meta", "cpu"):
        q, kv = q_cpu.to(dev), kv_cpu.to(dev)
        with dryrun.CountingMode() as mode:
            ops.flash_attention(q, kv, kv, causal=True, window=0)
        assert mode.flops == 4 * d * hq * b * s * (s + 1) // 2
        assert mode.bytes_accessed == 2 * (q.numel() + kv.numel()) * 4
        assert mode.charges == {"flash_attention": 1}
        with dryrun.CountingMode() as mode:
            ops.flash_attention(q, kv, kv, causal=True, window=8)
        assert mode.flops == 4 * d * hq * b * work.attn_pairs(s, s, True, 8)

    bsz, length, dm, n, chunk = 2, 70, 8, 16, 32
    x, dt = (torch.randn((bsz, length, dm), generator=g) for _ in range(2))
    a = -torch.rand((dm, n), generator=g)
    bb, cc = (torch.randn((bsz, length, n), generator=g) for _ in range(2))
    terms = bsz * length * dm * n
    # three chunks (32, 32 and 6 steps): seven a term, two more a term of the
    # middle chunk, dt*x a step and channel, the first two chunks' dt sums
    # and their ends' four a state
    want = 7 * terms + 2 * bsz * 32 * dm * n + bsz * length * dm + 2 * bsz * 32 * dm \
        + 2 * 4 * bsz * dm * n
    for dev in ("meta", "cpu"):
        args = [t.to(dev) for t in (x, dt, a, bb, cc)]
        with dryrun.CountingMode() as mode:
            ops.mamba_scan(*args, chunk=chunk)
        assert mode.flops == want
        assert mode.charges == {"mamba_scan_route": 1}


# ----------------------------------------------------------------------
# the meta leg of K6 and K7's route
# ----------------------------------------------------------------------
def test_meta_leg_returns_the_kernels_shapes_and_cpu_stays_plain():
    g = torch.Generator().manual_seed(1)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.empty((2, 4, 33, 64), dtype=dt, device="meta")
        k = torch.empty((2, 2, 33, 64), dtype=dt, device="meta")
        o = ops.flash_attention(q, k, k, causal=True)
        assert (o.device.type, o.shape, o.dtype) == ("meta", q.shape, dt)
    # with a gradient the meta call goes through FlashAttentionFn, whose
    # backward (the plain recompute) runs on meta too
    q = torch.empty((1, 2, 16, 64), device="meta", requires_grad=True)
    k = torch.empty((1, 2, 16, 64), device="meta", requires_grad=True)
    o = ops.flash_attention(q, k, k)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    dq, dk = torch.autograd.grad(o.sum(), (q, k))
    assert dq.shape == q.shape and dk.device.type == "meta"
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(*(torch.empty((1, 1, 4, 24), device="meta"),) * 3)

    bsz, length, d, n, chunk = 2, 70, 8, 16, 32
    nc = -(-length // chunk)
    x = torch.empty((bsz, length, d), dtype=torch.bfloat16, device="meta")
    dtm = torch.empty_like(x)
    a = torch.empty((d, n), device="meta")
    b = torch.empty((bsz, length, n), dtype=torch.bfloat16, device="meta")
    y, h = ops.mamba_scan(x, dtm, a, b, b, chunk=chunk)
    assert (y.shape, y.dtype, h.shape, h.dtype) == (x.shape, x.dtype, (bsz, d, n), torch.float32)
    s_loc = ops.mamba_chunk_states(x, dtm, a, b, chunk=chunk)
    assert s_loc.shape == (bsz, nc, d, n) and s_loc.dtype == torch.float32
    h0 = ops.mamba_chunk_combine(dtm, a, s_loc, chunk=chunk)
    assert h0.shape == s_loc.shape and h0.device.type == "meta"
    ys, hs = ops.mamba_chunk_scan(x, dtm, a, b, b, h0, chunk=chunk)
    assert ys.shape == x.shape and hs.shape == h0.shape
    xg = torch.empty((bsz, length, d), device="meta", requires_grad=True)
    y, _ = ops.mamba_scan(xg, xg, a, torch.empty((bsz, length, n), device="meta"),
                          torch.empty((bsz, length, n), device="meta"), chunk=chunk)
    assert type(y.grad_fn).__name__ == "MambaScanFnBackward"

    # a CPU tensor still goes to the plain version, bit for bit
    q = torch.randn((1, 2, 20, 64), generator=g)
    k = torch.randn((1, 1, 20, 64), generator=g)
    assert torch.equal(ops.flash_attention(q, k, k, window=5),
                       ref.attention_ref(q, k, k, causal=True, window=5))
    xs = torch.randn((1, 40, 4), generator=g)
    a_c = -torch.rand((4, 8), generator=g)
    b_c = torch.randn((1, 40, 8), generator=g)
    got = ops.mamba_scan(xs, xs.abs(), a_c, b_c, b_c, chunk=16)
    want = ref.mamba_route_ref(xs, xs.abs(), a_c, b_c, b_c, chunk=16)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


# ----------------------------------------------------------------------
# whole steps
# ----------------------------------------------------------------------
STEP_CELLS = {
    # name: (arch, shape, (batch, seq), config changes)
    "qwen2_train_remat": ("qwen2-1.5b", "train_4k", (4, 64), {"remat": "full"}),
    "jamba_prefill": ("jamba-v0.1-52b", "prefill_32k", (2, 48), {}),
    "deepseek_decode": ("deepseek-v3-671b", "decode_32k", (4, 32), {}),
}


@pytest.mark.parametrize("cell", list(STEP_CELLS))
def test_step_counts_the_same_on_meta_and_on_cpu(world_of_one, cell):
    """One step counted on meta (``lower_cell``) and on real CPU tensors
    (``cell_step`` from a seeded generator): the same flops, charges and
    argument and output bytes, and no collective on a world of one.
    ``bytes_accessed`` is not compared: ``F.one_hot`` (the MoE routing)
    decomposes into other operations on meta than on the CPU."""
    arch, shape, bt, changes = STEP_CELLS[cell]
    mesh = world_of_one
    cfg = dataclasses.replace(reduced(get_arch(arch)), **changes)
    rec = dryrun.lower_cell(cfg, shape, multi_pod=False, mesh=mesh, batch_tokens=bt,
                            device="cpu")
    step, args, _ = dryrun.cell_step(cfg, shape, mesh, batch_tokens=bt,
                                     gen=torch.Generator().manual_seed(0))
    assert all(t.device.type == "cpu" for t in tree_leaves(args) if isinstance(t, torch.Tensor))
    with tsh.use_mesh(mesh):
        parts, out = dryrun.count_step(step, args)
    assert parts["cost"]["flops"] == rec["cost"]["flops"] > 0
    assert parts["charges"] == rec["charges"]
    assert parts["collectives"] == rec["collectives"]
    assert rec["collectives"]["bytes_total"] == 0
    for key in ("argument_bytes", "output_bytes"):
        assert parts["memory"][key] == rec["memory"][key]
    assert parts["memory"]["argument_bytes"] == sum(
        tsh.full(t).nbytes for t in tree_leaves(args) if isinstance(t, torch.Tensor))
    if cell == "qwen2_train_remat":       # each layer's forward, and again in remat's recompute
        assert rec["charges"] == {"flash_attention": 2 * cfg.n_layers}
    if cell == "jamba_prefill":           # two chunks a Mamba layer: the route's one launch
        assert set(rec["charges"]) == {"flash_attention", "mamba_scan_route"}
    if cell == "deepseek_decode":
        assert rec["cache_len"] == bt[1] - 1


def _three_repeats(arch):
    cfg = reduced(get_arch(arch))
    return dataclasses.replace(cfg, stacks=tuple((3, specs) for _, specs in cfg.stacks))


@pytest.mark.parametrize("arch,shape", [("qwen2-1.5b", "train_4k"),
                                        ("jamba-v0.1-52b", "prefill_32k")])
def test_probe_differencing_equals_the_direct_count(arch, shape):
    """Eager execution counts every layer: probe1 + 2 (probe2 - probe1) is
    the count of three repeats a stack, exactly."""
    cfg, bt = _three_repeats(arch), (16, 32)
    probes = dryrun._probe_costs(cfg, shape, multi_pod=False, opt_dtype=None, device="cpu",
                                 batch_tokens=bt)
    direct = dryrun.lower_cell(cfg, shape, multi_pod=False, device="cpu", batch_tokens=bt)
    assert probes["flops"] == direct["cost"]["flops"]
    assert probes["bytes_accessed"] == direct["cost"]["bytes_accessed"]
    assert probes["collectives"] == direct["collectives"]
    assert not dist.is_initialized()


#: one shape a reduced architecture, the kinds spread over them; train and
#: prefill at 16 sequences of 16 tokens (the frontends' 16 on top), jamba's
#: Mamba chunks cut to 8 tokens so that its scans take the whole route.
#: Cells with a suffix change the reduced config where the sharding takes
#: another path: "-ep" 16 experts at the configs' capacity factor (each
#: model rank one expert, fewer slots than tokens); "-heads" 16 heads, which
#: divide the model axis (decode and MLA's attention per head shard);
#: "-int8" int8 moments (the vocab is no whole number of quantization
#: blocks a shard, the router's 8 experts pad to a block)
PRODUCTION_CELLS = {
    "deepseek-moe-16b": ("train_4k", {}, {}),
    "deepseek-moe-16b-ep": ("train_4k", {"moe_experts": 16, "moe_capacity": 1.25}, {}),
    "deepseek-moe-16b-heads": ("decode_32k", {"n_heads": 16, "n_kv_heads": 16}, {}),
    "deepseek-v3-671b": ("decode_32k", {}, {}),
    "deepseek-v3-671b-heads": ("prefill_32k", {"n_heads": 16}, {}),
    "xlstm-350m": ("train_4k", {}, {}),
    "codeqwen1.5-7b": ("prefill_32k", {}, {}), "qwen2-1.5b": ("train_4k", {}, {}),
    "qwen1.5-110b": ("decode_32k", {}, {}), "starcoder2-3b": ("long_500k", {}, {}),
    "phi-3-vision-4.2b": ("train_4k", {}, {}), "musicgen-medium": ("prefill_32k", {}, {}),
    "jamba-v0.1-52b": ("train_4k", {"mamba_chunk": 8}, {}),
    "deepseek-moe-16b-int8": ("train_4k", {}, {"opt_dtype": "int8"}),
}


@pytest.mark.parametrize("cell", list(PRODUCTION_CELLS))
def test_lower_cell_on_the_fake_production_mesh(rdry, monkeypatch, cell):
    shape, changes, extra = PRODUCTION_CELLS[cell]
    arch = cell.removesuffix("-ep").removesuffix("-heads").removesuffix("-int8")
    cfg = dataclasses.replace(reduced(get_arch(arch)), **changes)
    kw = dict(extra) if SHAPES[shape]["kind"] == "decode" else dict(
        extra, batch_tokens=(16, 16 + (cfg.frontend_tokens if cfg.frontend else 0)))
    count_step, seen = dryrun.count_step, []

    def spy(step, args):
        parts, out = count_step(step, args)
        seen.extend(tree_leaves((args, out)))
        return parts, out

    monkeypatch.setattr(dryrun, "count_step", spy)
    rec = dryrun.lower_cell(cfg, shape, multi_pod=False, device="cpu", **kw)
    assert not dist.is_initialized()
    assert "error" not in rec and "skipped" not in rec
    assert RECORD_KEYS <= set(rec) and rec["mesh"] == "16x16" and rec["chips"] == 256
    assert set(rec["memory"]) == MEMORY_KEYS and set(rec["roofline"]) == ROOFLINE_KEYS
    assert set(rec["cost"]) == {"flops", "bytes_accessed"}
    assert set(rec["collectives"]) == set(rdry.collective_bytes(""))
    assert rec["collectives"]["bytes_total"] > 0 and rec["cost"]["flops"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    # the arguments and results, every local shard on meta
    assert {dryrun._local(t).device.type for t in seen if isinstance(t, torch.Tensor)} == {"meta"}
    if SHAPES[shape]["kind"] == "train":
        assert rec["grad_accum"] == 1


def test_microbatches_of_fewer_rows_than_batch_ranks():
    """8 microbatches of 4 rows on the production mesh's 16 data ranks (the
    multi-pod mesh's 32 meet 16 of 16 in a big model's train cell): the
    batch is gathered before it is split, where a reshape of the sharded
    rows fails."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = reduced(get_arch("qwen2-1.5b"))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        mesh = tmesh.make_production_mesh(device_type="cpu")
        step, args, notes = dryrun.cell_step(cfg, "train_4k", mesh, accum=8,
                                             batch_tokens=(32, 16))
        with tsh.use_mesh(mesh):
            parts, _ = dryrun.count_step(step, args)
    finally:
        dist.destroy_process_group()
    assert notes == {"grad_accum": 8} and parts["cost"]["flops"] > 0
    assert parts["collectives"]["count_all-gather"] > 0


def test_moe_microbatches_of_fewer_rows_than_batch_ranks_on_a_pod_mesh(monkeypatch):
    """Reduced deepseek-v3 (MoE, ``shard_map`` dispatch) on a fake (2, 2, 2)
    ("pod", "data", "model") mesh: microbatches of 2 rows on 4 batch ranks,
    so the MoE's 32 tokens shard over pod x data, more axes than (B, S)
    can carry (deepseek-v3 train_4k on (2, 16, 16) in small).  The step
    lowers; the MoE output's local shard is (b_local, S, d_local) of its
    placements; and the gradient of the MoE's input comes back in the
    input's own layout, as it must for torch 2.11's view backward."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models import moe as tmoe

    cfg = reduced(get_arch("deepseek-v3-671b"))
    cfg = dataclasses.replace(cfg, stacks=tuple((1, specs) for _, specs in cfg.stacks))
    assert cfg.moe_dispatch == "shard_map"
    seen, moe_forward = [], tmoe.moe_forward

    def spy(p, x, c, **kw):
        grads = []
        x.register_hook(lambda g: grads.append(tuple(g.placements)))
        y, aux = moe_forward(p, x, c, **kw)
        seen.append((x, y, grads))
        return y, aux

    monkeypatch.setattr(tmoe, "moe_forward", spy)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        step, args, notes = dryrun.cell_step(cfg, "train_4k", mesh, accum=2,
                                             batch_tokens=(4, 16))
        with tsh.use_mesh(mesh):
            parts, _ = dryrun.count_step(step, args)
    finally:
        dist.destroy_process_group()
    assert notes == {"grad_accum": 2} and parts["cost"]["flops"] > 0
    assert len(seen) == 2    # one MoE layer, two microbatches
    for x, y, grads in seen:
        assert tuple(y.shape) == (2, 16, cfg.d_model)
        local = list(y.shape)
        for i, p in enumerate(y.placements):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(i)
        assert tuple(y.to_local().shape) == tuple(local)
        assert grads == [tuple(x.placements)]


def test_a_shard_becomes_a_partial_sum_through_a_replica_under_the_lm_mesh():
    """DTensor's dispatch cannot redistribute a shard into a partial sum in
    one step; under ``use_mesh`` it goes through a replica (an all-gather,
    then the partial's share), and outside it DTensor's own refusal
    stands."""
    import torch.distributed.tensor._dispatch as dispatch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        meta = TensorMeta(torch.Size((4, 6)), (6, 1), torch.float32)
        shard = DTensorSpec(mesh, (Shard(0),), tensor_meta=meta)
        partial = DTensorSpec(mesh, (Partial(),), tensor_meta=meta)
        local = torch.empty((2, 6), device="meta")
        with pytest.raises(RuntimeError, match="not supported"):
            dispatch.redistribute_local_tensor(local, shard, partial)
        with tsh.use_mesh(mesh):
            out = dispatch.redistribute_local_tensor(local, shard, partial)
        assert out.shape == (4, 6)
        assert not getattr(dispatch.redistribute_local_tensor, "via_replica", False)
    finally:
        dist.destroy_process_group()


def test_long_500k_skips_quadratic_attention_and_the_cli_writes_records(monkeypatch, tmp_path):
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    monkeypatch.setattr(dryrun, "get_arch", lambda name: reduced(get_arch(name)))
    recs = dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k", "--device", "cpu"])
    assert recs == [{"arch": "qwen2-1.5b-reduced", "shape": "long_500k",
                     "skipped": "quadratic-attention", "unroll": True, "wall_s": recs[0]["wall_s"]}]
    assert (tmp_path / "qwen2-1.5b__long_500k__256.json").exists()
    recs = dryrun.main(["--arch", "starcoder2-3b", "--shape", "decode_32k", "--multi-pod",
                        "--device", "cpu", "--tag", "_t"])
    assert "error" not in recs[0] and recs[0]["mesh"] == "2x16x16" and recs[0]["chips"] == 512
    assert (tmp_path / "starcoder2-3b__decode_32k__512_t.json").exists()


def test_refuses_beside_a_process_group_and_destroys_its_own_on_error(world_of_one,
                                                                      monkeypatch):
    with pytest.raises(RuntimeError, match="process group already exists"):
        dryrun.lower_cell(reduced(get_arch("qwen2-1.5b")), "decode_32k", multi_pod=False,
                          device="cpu")
    dist.destroy_process_group()

    def broken(*a, **k):
        raise ZeroDivisionError("a fault in the step")

    monkeypatch.setattr(dryrun, "make_serve_step", broken)
    with pytest.raises(ZeroDivisionError):
        dryrun.lower_cell(reduced(get_arch("qwen2-1.5b")), "decode_32k", multi_pod=False,
                          device="cpu")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


def test_route_work_counts_by_hand():
    """The route's bytes and operations at jamba's 32k call and at a small
    ragged one, counted by hand: x, dt and y, B and C, a and the last
    state; 7 operations a term, 9 in the chunks between the first and the
    last, dt*x a step, the dt sums and the combine's four a state at every
    chunk's end but the last's."""
    x = torch.empty((1, 32768, 8192), dtype=torch.bfloat16, device="meta")
    a = torch.empty((8192, 16), device="meta")
    b = torch.empty((1, 32768, 16), dtype=torch.bfloat16, device="meta")
    nbytes, flops = work.route_work(x, a, b, chunk=128)
    assert nbytes == 3 * 32768 * 8192 * 2 + 2 * 32768 * 16 * 2 + 8192 * 16 * 4 + 8192 * 16 * 4
    assert flops == (7 * 256 + 2 * 254) * 128 * 8192 * 16 + 32768 * 8192 \
        + 255 * (128 * 8192 + 4 * 8192 * 16)
    # two rows, 70 steps at chunk 32: chunks of 32, 32 and 6 steps, float32
    x, b = torch.empty((2, 70, 8)), torch.empty((2, 70, 16))
    nbytes, flops = work.route_work(x, torch.empty((8, 16)), b, chunk=32)
    assert nbytes == (3 * 2 * 70 * 8 + 2 * 2 * 70 * 16) * 4 + 8 * 16 * 4 + 2 * 8 * 16 * 4
    assert flops == 7 * 2 * 70 * 8 * 16 + 2 * 2 * 32 * 8 * 16 + 2 * 70 * 8 \
        + 2 * (2 * 32 * 8 + 4 * 2 * 8 * 16)
    # one chunk: K7's work from zero states, without the states in
    x = torch.empty((1, 20, 8))
    assert work.route_work(x, torch.empty((8, 16)), torch.empty((1, 20, 16)), chunk=32)[1] \
        == 7 * 20 * 8 * 16 + 20 * 8


def test_work_formulas_are_the_ones_chip_smoke_uses():
    text = (ROOT / "chip_smoke.py").read_text()
    for name in ("flash_work", "scan_work", "states_work", "combine_work", "route_work"):
        assert f"work.{name}(" in text, name
    assert "def attn_pairs" not in text
    # the kept pairs of a causal window, counted by hand
    assert work.attn_pairs(5, 5, True, 2) == 1 + 2 + 2 + 2 + 2
    assert work.attn_pairs(3, 4, False, 0) == 12
    assert work.attn_pairs(np.int64(4), 4, True, 0) == 10
