"""The LM mesh's numerics on four gloo ranks of this CPU, a ``(2, 2)``
``("data", "model")`` mesh each (the rank bodies are in
tests/_torch_mesh_ranks.py):

1. expert-parallel MoE against the reference's ``shard_map`` runs on a
   ``(2, 2)`` mesh of forced host devices (a JAX subprocess): training EP
   and inference EP, ``y`` within ``rtol 1e-5`` and the aux loss within
   1e-6, the aux loss's gradient by the router and the tokens against
   ``jax.grad`` of the reference's; the expert weights' gradient through
   EP against the port's unsharded gradient;
2. sharded train steps against the port's unsharded step (the
   reference's sharded step cannot run under this JAX);
3. the reference's checkpoint restore onto a resized mesh, bit for bit.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch.multiprocessing as tmp

import _torch_mesh_ranks as ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240

#: the reference's EP on a (2, 2) mesh of forced host devices
REFERENCE_EP = r"""
import sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch, reduced
from repro.models import moe

a = dict(np.load(sys.argv[1]))
cfg = reduced(get_arch("deepseek-moe-16b"))
p = {"router": a["router"],
     "experts": {"w_gate": a["w_gate"], "w_up": a["w_up"], "w_down": a["w_down"]}}
mesh = jax.make_mesh((2, 2), ("data", "model"))
y_sm, aux_sm = jax.jit(lambda p, x: moe._dispatch_shard_map(p, x, cfg, mesh))(p, a["x"])
y_ie, aux_ie = jax.jit(lambda p, x: moe._dispatch_inference_ep(p, x, cfg, mesh))(p, a["x"])
g_aux = {}
for mode, fn in (("sm", moe._dispatch_shard_map), ("ie", moe._dispatch_inference_ep)):
    def aux_of(router, x, fn=fn):
        return fn(dict(p, router=router), x, cfg, mesh)[1]
    g_router, g_x = jax.jit(jax.grad(aux_of, argnums=(0, 1)))(a["router"], a["x"])
    g_aux.update({f"g_aux_{mode}_router": g_router, f"g_aux_{mode}_x": g_x})
w = jax.device_put(a["w_gate"], NamedSharding(mesh, P(("model", "data"), None, None)))
layout = np.zeros((cfg.moe_experts, 2), np.int64)
for shard in w.addressable_shards:
    (d,), (m,) = np.nonzero(mesh.devices == shard.device)
    layout[shard.index[0]] = (d, m)
np.savez(sys.argv[2], y_sm=y_sm, aux_sm=aux_sm, y_ie=y_ie, aux_ie=aux_ie, layout=layout, **g_aux)
"""


def _spawn(fn, *args):
    """``fn(rank, *args)`` in four spawned processes; fails the test if any
    raises or they outlast RANK_TIMEOUT_S."""
    ctx = tmp.spawn(fn, args=args, nprocs=4, join=False)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks of {fn.__name__} did not finish in {RANK_TIMEOUT_S} s")


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    """The reference's EP (a JAX subprocess) and the port's rank body
    ``ranks.moe`` on the same inputs: (reference, port) result files."""
    from repro.configs import get_arch, reduced

    tmp_path = tmp_path_factory.mktemp("moe")

    cfg = reduced(get_arch("deepseek-moe-16b"))
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    rng = np.random.default_rng(3)

    def draw(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    inputs = dict(router=draw(d, e, fan_in=d), w_gate=draw(e, d, f, fan_in=d),
                  w_up=draw(e, d, f, fan_in=d), w_down=draw(e, f, d, fan_in=f),
                  x=draw(64, d, fan_in=1), r=draw(64, d, fan_in=1))
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", REFERENCE_EP, str(tmp_path / "in.npz"),
                    str(tmp_path / "ref.npz")], env=env, check=True, timeout=RANK_TIMEOUT_S)
    _spawn(ranks.moe, str(tmp_path / "store"), str(tmp_path / "in.npz"),
           str(tmp_path / "port.npz"))
    return np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")


def test_expert_parallel_moe_matches_the_reference_shard_map(moe_run):
    ref, got = moe_run
    e = ref["layout"].shape[0]
    for mode in ("sm", "ie"):
        np.testing.assert_allclose(got[f"y_{mode}"], ref[f"y_{mode}"], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[f"y_{mode}"]).max())
        assert abs(float(got[f"aux_{mode}"]) - float(ref[f"aux_{mode}"])) <= 1e-6
        # the aux loss's gradient through the mean over the mesh
        for name in ("router", "x"):
            want = ref[f"g_aux_{mode}_{name}"]
            np.testing.assert_allclose(got[f"g_aux_{mode}_{name}"], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"{mode} {name}")
    # the per-shard aux (the reference's pmean) is not the whole batch's
    assert abs(float(got["aux_sm"]) - float(got["aux_gather"])) > 1e-4
    np.testing.assert_allclose(got["y_sm"], got["y_gather"], rtol=1e-5,
                               atol=1e-5 * np.abs(got["y_gather"]).max())
    for name in ("w_gate", "w_up", "w_down", "router", "x"):
        want = got[f"g_plain_{name}"]
        np.testing.assert_allclose(got[f"g_ep_{name}"], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
    # the stated layout deviation: expert e of inference EP lies on another
    # (data, model) coordinate than in the reference, each as predicted
    lay = ranks.expert_coordinates(e, {"data": 2, "model": 2})
    assert got["layout"].tolist() == [[c["data"], c["model"]] for c in lay["port"]]
    assert ref["layout"].tolist() == [[c["data"], c["model"]] for c in lay["reference"]]
    assert got["layout"].tolist() != ref["layout"].tolist()


def test_sharded_train_steps_match_the_unsharded_step(tmp_path):
    """Losses within 1e-6 relative and updated params within 1e-5 absolute:
    every reduction over a sharded dim becomes per-shard partial sums and
    an all-reduce (the sharded contractions, the loss's batch mean, the
    global-norm clip's squared sums, the MoE combine), so the step is not
    bit-equal.  deepseek-moe-16b and jamba (whose Mamba scan runs per
    shard, channels over "model") run with aux weight 0: their aux loss is
    a mean of per-shard statistics, as the reference's pmean (held in the
    test above), not the whole batch's."""
    _spawn(ranks.train, str(tmp_path / "store"), str(tmp_path / "out.npz"))
    got = np.load(tmp_path / "out.npz")
    for key in ("qwen2-1.5b_float32", "deepseek-moe-16b_float32", "qwen2-1.5b_int8",
                "jamba-v0.1-52b_float32"):
        np.testing.assert_allclose(got[f"{key}_sharded"], got[f"{key}_unsharded"], rtol=1e-6,
                                   err_msg=key)
        assert float(got[f"{key}_param_err"]) <= 1e-5, key
        assert bool(got[f"{key}_layout_kept"]), key


def test_remesh_checkpoint_restore_roundtrip(tmp_path):
    """Params saved on the (2, 2) mesh restore onto a (4,) data mesh."""
    _spawn(ranks.remesh, str(tmp_path / "store"), str(tmp_path / "ckpt"),
           str(tmp_path / "out.npz"))
    got = np.load(tmp_path / "out.npz")
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    np.testing.assert_array_equal(got["w"], w)
    np.testing.assert_array_equal(got["again_w"], w)
    np.testing.assert_array_equal(got["b"], np.arange(8, dtype=np.float32))
    assert int(got["step"]) == 10
    np.testing.assert_array_equal(got["rows"], w.reshape(4, 2, 8))   # rank r holds rows 2r, 2r+1
    assert got["placements_b"].tolist() == ["S(0)"]


@pytest.mark.parametrize("arch", [a for a, _ in ranks.SERVE_CASES])
def test_meshed_serve_matches_unsharded_serve(moe_run, arch):
    """``serve(mesh=)`` on the (2, 2) mesh (inference-EP params, sharded
    caches, every decode step under the mesh) gives unsharded ``serve``'s
    greedy tokens, its prompt logits within 1e-5 of their largest
    magnitude (the sharded contractions sum in another order)."""
    _, got = moe_run
    key = f"serve_{arch}"
    np.testing.assert_array_equal(got[f"{key}_sharded_tokens"], got[f"{key}_unsharded_tokens"])
    want = got[f"{key}_unsharded_logits"]
    np.testing.assert_allclose(got[f"{key}_sharded_logits"], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
