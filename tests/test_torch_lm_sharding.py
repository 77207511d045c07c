"""The LM half of ``launch/sharding.py`` against the JAX reference's spec
functions at production size: every leaf's parameter spec (training and
``inference=True``), the decode-cache, batch and optimizer-state specs
(float32, bf16 and int8 moments) on ``AbstractMesh((16, 16))`` and
``AbstractMesh((2, 16, 16))``; the specs turned into DTensor placements on
a fake-process-group ``(16, 16)`` mesh with meta tensors; the expert layout
of a multi-axis entry; and a λ-search under an ambient LM mesh."""

import dataclasses
import functools
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES
from repro.configs import decode_cache_specs as r_cache_specs
from repro.configs import get_arch as r_get_arch
from repro.configs import input_specs as r_input_specs
from repro.launch import sharding as rsh
from repro.models import transformer as rtf
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as r_adamw_init

import repro_torch.core as tc
from repro_torch.configs import decode_cache_specs, get_arch, input_specs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves

import _torch_mesh_ranks as ranks

MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}


def _both(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _specs(tree, is_leaf=None):
    return [tuple(s.spec) for s in jax.tree.leaves(tree, is_leaf=is_leaf)]


@functools.lru_cache(maxsize=None)
def _abstract(name):
    return rtf.init_abstract(r_get_arch(name)), ttf.init_abstract(get_arch(name))


def _port_specs(tree):
    return [s.spec for s in tree_leaves(tree, lambda x: isinstance(x, tsh.NamedSharding))]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_match_the_reference(name):
    r_abs, t_abs = _abstract(name)
    for mesh in MESHES:
        rmesh, tmesh_ = _both(mesh)
        for inference in (False, True):
            want = _specs(rsh.params_shardings(r_abs, rmesh, inference=inference))
            got = _port_specs(tsh.params_shardings(t_abs, tmesh_, inference=inference))
            assert got == want, (mesh, inference)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_batch_and_opt_state_specs_match_the_reference(name):
    rcfg, cfg = r_get_arch(name), get_arch(name)
    r_abs, t_abs = _abstract(name)
    is_moment = lambda x: isinstance(x, dict) and "q" in x   # noqa: E731
    r_states, t_states = {}, {}
    for dtype in ("float32", "bfloat16", "int8"):
        r_opt = RAdamWConfig(state_dtype=dtype)
        r_states[dtype] = jax.eval_shape(lambda: r_adamw_init(r_abs, r_opt))
        t_states[dtype] = adamw_init(t_abs, AdamWConfig(state_dtype=dtype))
    for mesh in MESHES:
        rmesh, tmesh_ = _both(mesh)
        for shape in ("decode_32k", "long_500k"):
            got = _port_specs(tsh.cache_shardings(decode_cache_specs(cfg, shape), tmesh_))
            assert got == _specs(rsh.cache_shardings(r_cache_specs(rcfg, shape), rmesh))
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            got = _port_specs(tsh.batch_shardings(input_specs(cfg, shape)[0], tmesh_))
            assert got == _specs(rsh.batch_shardings(r_input_specs(rcfg, shape)[0], rmesh))
        for dtype in r_states:
            want = rsh.opt_state_shardings(r_states[dtype], r_abs, rmesh)
            got = tsh.opt_state_shardings(t_states[dtype], t_abs, tmesh_)
            assert _port_specs(got) == _specs(want), (mesh, dtype)
            assert [tuple(t.shape) for t in tree_leaves(t_states[dtype], is_moment)
                    if not isinstance(t, dict)] == [
                tuple(t.shape) for t in jax.tree.leaves(r_states[dtype], is_leaf=is_moment)
                if not isinstance(t, dict)]


def test_spec_helpers_match_the_reference():
    for mesh in MESHES:
        rmesh, tmesh_ = _both(mesh)
        assert tsh.batch_axes(tmesh_) == rsh.batch_axes(rmesh)
        for axis in (None, "data", "model", ("data", "model")):
            assert tsh._axis_size(tmesh_, axis) == rsh._axis_size(rmesh, axis)
        for shape in ((32, 8, 24), (48, 16, 16), (3, 16, 7)):
            spec = (rsh.batch_axes(rmesh), "model", ("data", "model"))
            assert tsh._fit(tmesh_, shape, spec) == tuple(rsh._fit(rmesh, shape, spec))
    assert tsh.param_pspec("stack0/experts/w_gate", (3, 256, 7168, 2048), _both("multi_pod")[1]) \
        == (None, "model", "data", None)
    assert tsh.param_pspec("stack0/experts/w_gate", (3, 256, 7168, 2048), _both("multi_pod")[1],
                           inference=True) == (None, ("model", "data"), None, None)
    assert tsh.cache_pspec((61, 128, 1, 32768, 576), _both("multi_pod")[1]) == \
        (None, ("pod", "data"), None, "model", None)


def test_expert_layout_of_a_multi_axis_entry():
    """Inference experts over ("model", "data"): DTensor splits the dim in the
    mesh's order, JAX in the entry's; the port linearises its expert ranks
    to match DTensor, so expert e lies elsewhere than in the reference."""
    lay = ranks.expert_coordinates(8, {"data": 2, "model": 2})
    assert [(c["data"], c["model"]) for c in lay["port"]] == [
        (0, 0), (0, 0), (0, 1), (0, 1), (1, 0), (1, 0), (1, 1), (1, 1)]
    assert [(c["data"], c["model"]) for c in lay["reference"]] == [
        (0, 0), (0, 0), (1, 0), (1, 0), (0, 1), (0, 1), (1, 1), (1, 1)]
    same = ranks.expert_coordinates(8, {"data": 1, "model": 4})
    assert same["port"] == same["reference"]        # one axis larger than one: no deviation


@pytest.fixture
def fake_world():
    """A fake process group of 256 ranks (this process is rank 0), destroyed
    afterwards so later tests see no group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_specs_as_placements_on_a_fake_production_mesh(fake_world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = tmesh.make_production_mesh(device_type="cpu")
    assert tsh.axis_sizes(mesh) == {"data": 16, "model": 16}
    params = ttf.init_abstract(get_arch("deepseek-v3-671b"))
    w = params["stack1"]["l0"]["ffn"]["experts"]["w_gate"]           # (58, 256, 7168, 2048)
    train = tsh.params_shardings(params, mesh)["stack1"]["l0"]["ffn"]["experts"]["w_gate"]
    serve = tsh.params_shardings(params, mesh, inference=True)["stack1"]["l0"]["ffn"]["experts"][
        "w_gate"]
    assert train.placements == (Shard(2), Shard(1))
    assert serve.placements == (Shard(1), Shard(1))     # ("model", "data"): mesh order
    assert distribute_tensor(w, mesh, train.placements, src_data_rank=None).to_local().shape == \
        (58, 16, 448, 2048)
    assert distribute_tensor(w, mesh, serve.placements, src_data_rank=None).to_local().shape == \
        (58, 1, 7168, 2048)
    # qwen2-1.5b's (28, 1536, 8960) FFN up projection
    qwen = ttf.init_abstract(get_arch("qwen2-1.5b"))["stack0"]["l0"]["ffn"]["w_up"]
    sh_up = tsh.params_shardings({"w_up": qwen}, mesh)["w_up"]
    local = distribute_tensor(qwen, mesh, sh_up.placements, src_data_rank=None)
    assert local.shape == qwen.shape and local.to_local().shape == (28, 96, 560)
    assert local.to_local().device.type == "meta"
    assert tsh.placements(mesh, (None,)) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="two dims"):
        tsh.placements(mesh, ("data", "data"))
    # a world of another size is refused unless the group is the fake one
    with mock.patch.object(dist, "get_backend", lambda *a: "gloo"), \
            pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")


@pytest.fixture
def local_mesh():
    """A world of one gloo rank in this process, and its (1, 1) LM mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield tmesh.make_local_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_lambda_search_under_an_ambient_lm_mesh(local_mesh):
    """The λ-search ignores an ambient LM DeviceMesh: the same periods as
    with no mesh, on the faults harness's 64-tile smoke chip."""
    hw = dataclasses.replace(tc.DYNAP_SE, n_tiles=64)
    snn = tc.small_app(170, 2100, seed=11)
    cl = tc.partition_greedy(snn, hw)
    app = tc.sdfg_from_clusters(cl, hw=hw)
    order, _ = tc.single_tile_order(cl, hw)
    b = np.stack([np.random.default_rng(11 + i).integers(0, 64, size=app.n_actors)
                  for i in range(5)])
    ob = tc.project_order_batch(order, b)
    want = tc.batch_execute(app, b, hw, ob, backend="csr", with_energy=True, device="cpu")
    assert tsh.mesh_devices(local_mesh) == []
    with tsh.use_mesh(local_mesh):
        assert tsh.current_mesh() is local_mesh
        got = tc.batch_execute(app, b, hw, ob, backend="csr", with_energy=True, device="cpu")
    np.testing.assert_array_equal(got.periods, want.periods)
    np.testing.assert_array_equal(got.energies, want.energies)
    assert np.isfinite(want.periods).all()


def test_logical_shard_is_the_identity_off_the_mesh(local_mesh):
    x = torch.randn(4, 8, 16)
    assert tsh.logical_shard(x, "act") is x                 # no mesh
    with tsh.use_mesh(local_mesh):
        assert tsh.logical_shard(x, "act") is x             # a plain tensor
        d = tsh.distribute(x, tsh.NamedSharding(local_mesh, (None, None, None)))
        y = tsh.logical_shard(d, "logits")
        assert torch.equal(tsh.full(y), x)


def test_kernel_wrappers_refuse_a_dtensor(local_mesh):
    """A DTensor reaches a kernel only as its shards (local_call): the
    wrapper itself refuses one, so neither the kernel nor its plain
    version runs on DTensor ops."""
    from repro_torch.kernels import ops

    q = torch.randn(2, 4, 8, 64)
    d = tsh.distribute(q, tsh.NamedSharding(local_mesh, (None,) * 4))
    with pytest.raises(TypeError, match="local_call"):
        ops.flash_attention(d, d, d)
    x = torch.randn(2, 16, 8)
    dx = tsh.distribute(x, tsh.NamedSharding(local_mesh, (None,) * 3))
    with pytest.raises(TypeError, match="local_call"):
        ops.mamba_scan(dx, dx, torch.randn(8, 4), torch.randn(2, 16, 4), torch.randn(2, 16, 4))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b"])
def test_serve_on_a_mesh_of_one_gives_the_same_tokens(local_mesh, arch):
    """serve(mesh=): weight-stationary params, inference_ep and the caches
    by cache_shardings (written through write_slot), against the unmeshed
    loop on the same params and prompts."""
    from repro_torch.configs import reduced
    from repro_torch.launch import serve as tserve

    cfg = reduced(get_arch(arch))
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 8))
    want = tserve.serve(cfg, params, prompts, 6, 16, "cpu", keep_prompt_logits=True)
    got = tserve.serve(cfg, params, prompts, 6, 16, "cpu", keep_prompt_logits=True,
                       mesh=local_mesh)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prompt_logits.numpy(), want.prompt_logits.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_train_main_on_a_mesh_of_one_is_the_unsharded_run(local_mesh, tmp_path):
    """train.main(mesh=) on the (1, 1) mesh: the same losses bit for bit as
    the unsharded run, and a checkpoint it writes restores the run."""
    import contextlib
    import io

    from repro_torch.launch import train as ttrain

    argv = ["--smoke", "--steps", "3", "--seq-len", "32", "--batch", "4"]
    with contextlib.redirect_stdout(io.StringIO()):
        want = ttrain.main(argv, device="cpu")
        got = ttrain.main(argv, device="cpu", mesh=local_mesh)
        ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
        ttrain.main(argv[:2] + ["2"] + argv[3:] + ckpt, device="cpu", mesh=local_mesh)
        resumed = ttrain.main(argv + ckpt, device="cpu", mesh=local_mesh)
    assert got == want
    assert resumed == want[2:]


def test_remat_recompute_on_another_thread_keeps_the_mesh(local_mesh):
    """On the card autograd runs the backward, and so remat's recompute, on
    a thread of its own, which does not see the ambient mesh (a thread
    local): the layer groups enter it again.  Here the backward runs on
    another thread, and the MoE layer's recompute must find the mesh."""
    import dataclasses
    import threading

    from repro_torch.configs import reduced
    from repro_torch.launch import steps as tsteps
    from repro_torch.tree import tree_unflatten

    cfg = dataclasses.replace(reduced(get_arch("deepseek-moe-16b")), remat="full")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(i))
             for i, k in enumerate(("tokens", "labels"))}
    want_loss, want = tsteps.loss_and_grads(params, batch, cfg)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(
        tsh.distribute(params, tsh.params_shardings(params, local_mesh)))]

    d_batch = tsh.distribute(batch, tsh.batch_shardings(batch, local_mesh))
    with tsh.use_mesh(local_mesh):
        with torch.enable_grad():
            loss = ttf.loss_fn(tree_unflatten(params, leaves), d_batch, cfg)
        out = {}

        def backward():
            # autograd's own threads carry DTensor's implicit-replication
            # flag from the caller, but not this module's ambient mesh
            with tsh._implicit_replication():
                out.update(g=torch.autograd.grad(loss, leaves))

        th = threading.Thread(target=backward)
        th.start()
        th.join(timeout=120)
    assert not th.is_alive() and "g" in out
    assert float(tsh.full(loss)) == float(want_loss)
    for a, b in zip(out["g"], tree_leaves(want)):
        np.testing.assert_allclose(tsh.full(a).numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
