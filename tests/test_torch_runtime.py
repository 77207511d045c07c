"""The slice as a whole: the port's isolated-placement admission path
against the JAX reference, plus the port's ground rules (no JAX or
``repro`` imports, CUDA by default)."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.core as rc

from repro_torch.core import apps as tapps
from repro_torch.core import explore as texplore
from repro_torch.core import hardware as thw
from repro_torch.core import optimize as topt
from repro_torch.core import partition as tpart
from repro_torch.core import runtime as trt

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUDGET = (2, 8)


def _apps(mod):
    tiny = mod.small_app(220, 2600, seed=11)
    return [mod.build_app("MLP-MNIST"), mod.build_app("CNN-MNIST"), tiny]


def _drive(ctl, apps, errors):
    """A fixed admit / reject / finish / evict schedule; returns the
    trajectory and the admitted bindings."""
    for snn in apps:
        ctl.register(snn)
    bindings = []

    def admit(name, k):
        try:
            bindings.append(ctl.admit(name, n_tiles_request=k).binding.copy())
        except errors:
            pass

    admit("MLP-MNIST", 2)
    admit("CNN-MNIST", 4)
    admit("tiny", 3)
    admit("MLP-MNIST", 2)         # already running: reject
    ctl.finish("tiny")
    admit("tiny", 20)             # more tiles than free: reject
    ctl.evict("CNN-MNIST")
    admit("tiny", 5)              # cache hit
    admit("CNN-MNIST", 2)
    ctl.record_rejection("late-app", "quota")
    return ctl.trajectory(), bindings


@pytest.fixture(scope="module")
def reference_run():
    ctl = rc.AdmissionController(rc.DYNAP_SE_9, optimize_budget=BUDGET)
    return _drive(ctl, _apps(rc), (rc.AdmissionError,))


def _port_run(backend):
    ctl = trt.AdmissionController(
        thw.DYNAP_SE_9, optimize_budget=BUDGET, backend=backend, device="cpu"
    )
    return _drive(ctl, _apps(tapps), (trt.AdmissionError,))


def _strip_wall(traj):
    return [{k: v for k, v in e.items() if k != "wall_s"} for e in traj]


def test_admission_trajectory_edges_bit_identical(reference_run):
    ref_traj, ref_bindings = reference_run
    traj, bindings = _port_run("edges")
    assert [e["kind"] for e in traj] == [
        "admit", "admit", "admit", "reject", "finish", "reject", "evict",
        "admit", "admit", "reject",
    ]
    assert _strip_wall(traj) == _strip_wall(ref_traj)
    assert len(bindings) == len(ref_bindings) == 5
    for a, b in zip(bindings, ref_bindings):
        np.testing.assert_array_equal(a, b)


def test_admission_trajectory_csr_matches_reference(reference_run):
    ref_traj, ref_bindings = reference_run
    traj, bindings = _port_run("csr")
    assert [(e["kind"], e["app"], e["tiles"]) for e in traj] == [
        (e["kind"], e["app"], e["tiles"]) for e in ref_traj
    ]
    np.testing.assert_allclose(
        [e["throughput"] for e in traj], [e["throughput"] for e in ref_traj],
        rtol=1e-8,
    )
    for a, b in zip(bindings, ref_bindings):
        np.testing.assert_array_equal(a, b)


def test_subset_scores_and_optimizer_match_reference():
    r_cl = rc.partition_greedy(rc.build_app("MLP-MNIST"), rc.DYNAP_SE_16)
    t_cl = tpart.partition_greedy(tapps.build_app("MLP-MNIST"), thw.DYNAP_SE_16)
    order, _ = rc.single_tile_order(r_cl, rc.DYNAP_SE_16)
    free = list(range(2, 16))
    r = rc.score_free_tile_subsets(r_cl, rc.DYNAP_SE_16, free, 3, order)
    for backend in ("edges", "csr"):
        t = texplore.score_free_tile_subsets(
            t_cl, thw.DYNAP_SE_16, free, 3, order, backend=backend, device="cpu")
        assert t.subsets == r.subsets and t.best == r.best
        assert t.virt_orders == r.virt_orders
        np.testing.assert_allclose(t.throughputs, r.throughputs, rtol=1e-8)
    r_opt = rc.optimize_binding(r_cl, rc.DYNAP_SE_16, single_order=order,
                                population=8, generations=2, allowed_tiles=free)
    t_opt = topt.optimize_binding(t_cl, thw.DYNAP_SE_16, single_order=order,
                                  population=8, generations=2, allowed_tiles=free,
                                  backend="edges", device="cpu")
    np.testing.assert_array_equal(t_opt.binding, r_opt.binding)
    assert t_opt.period == r_opt.period and t_opt.energy == r_opt.energy
    assert [g.best_period for g in t_opt.history] == [g.best_period for g in r_opt.history]


def test_controller_defaults_to_cuda_and_later_slices_raise(monkeypatch):
    import torch

    from repro_torch.core import engine as tengine
    from repro_torch.core import maxplus as tmp
    from repro_torch.core import sdfg as tsdfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.AdmissionController(thw.DYNAP_SE)
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.AdmissionController(thw.DYNAP_SE, placement="joint")
    # the sharded solve (ROADMAP queue 1, module 5) is the later slice
    mesh = object()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, module 5"):
        trt.AdmissionController(thw.DYNAP_SE, placement="joint", mesh=mesh, device="cpu")
    snn = tapps.small_app(150, 1800, seed=3)
    cl = tpart.partition_greedy(snn, thw.DYNAP_SE)
    app = tsdfg.sdfg_from_clusters(cl, hw=thw.DYNAP_SE)
    stack = tmp.stack_graphs([app])
    binding = np.zeros(app.n_actors, dtype=np.int64)
    for call in (
        lambda: tmp.mcr_batch(stack, devices=[mesh], device="cpu"),
        lambda: tengine.batch_execute(app, binding, thw.DYNAP_SE, mesh=mesh, device="cpu"),
        lambda: topt.optimize_binding_graph(
            app, thw.DYNAP_SE, list(range(app.n_actors)),
            seed_bindings={"s": binding}, mesh=mesh, device="cpu"),
        lambda: topt.optimize_binding_graphs_fused([], mesh=mesh, device="cpu"),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, module 5"):
            call()


def test_core_exports_every_reference_name_or_lists_it():
    import repro_torch.core as tcore

    for name in rc.__all__:
        assert name in tcore.__all__ or name in tcore.NOT_PORTED, name
    for name, where in tcore.NOT_PORTED.items():
        assert name in rc.__all__ and name not in tcore.__all__, name
        assert where.startswith("queue 1, module "), where
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_port_never_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path.name, name)


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys, repro_torch.convert, repro_torch.core.runtime, "
        "repro_torch.core.explore, repro_torch.core.optimize, "
        "repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
