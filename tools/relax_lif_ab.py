"""Side-by-side timing of K5 (the LIF crossbar step) and K1 (the relaxation
round) on one GPU: the bodies before their redesign, kept in
``tools/pr14_kernels/``, against the package's ``csrc/`` sources, in turns.

K5, on HeartClass's 1013 crossbar blocks (8 samples of rate-0.15 spikes,
as ``chip_smoke.py`` builds them): the old and new G = 1 call on one block;
1013 sequential G = 1 calls (old and new) against one stacked call over
all blocks (new, and its named variants ``K5_VARIANTS``, each a one-line
edit of ``lif_crossbar.cu``).

K1 and K1w, on the inputs of the first call of every distinct shape that
``chip_smoke.py``'s admission and dense phases launch (the same apps,
requests and budget): old and new (and the named variants
``K1_VARIANTS``), each checked bit for bit against the plain version,
timed in turns, and the launch-weighted sum of ``launches x (ms -
bound)`` over the shapes for each.

Run from the repository root on a machine with the card:

    python3 tools/relax_lif_ab.py --k5 base,stages2 --k1 base,edges1

(each a comma-separated list of ``K5_VARIANTS`` and ``K1_VARIANTS``;
``base`` alone by default).

One JSON line per measurement.  It exits non-zero if a kernel does not
build or differs from its plain version.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core import apps, engine, runtime  # noqa: E402
from repro_torch.core.hardware import DYNAP_SE_1024, DYNAP_SE_16  # noqa: E402
from repro_torch.core.sdfg import sdfg_from_clusters  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

OLD = ROOT / "tools" / "pr14_kernels"
OUT = ROOT / "build" / "repro_torch_kernels" / "relax_lif_ab"

#: name -> (old, new) replacements in csrc/lif_crossbar.cu
K5_VARIANTS = {
    "base": [],
    "stages2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    # 8 rows per thread at every G (base: 4 below one block an SM)
    "rpt8": [("    launch<4>(", "    launch<BB>(")],
    # 4 rows per thread at every G, the stack's too
    "split_all": [("(int64_t)G * col_blocks < n_sm", "true")],
    "nb64": [("constexpr int NB = 128;", "constexpr int NB = 64;")],
}
#: name -> (old, new) replacements in csrc/relax_round.cu
K1_VARIANTS = {
    "base": [],
    **{f"team{n}": [("constexpr int TEAM = 8;", f"constexpr int TEAM = {n};")]
       for n in (2, 4, 16, 32)},
    "edges1": [("constexpr int EDGES = 2;", "constexpr int EDGES = 1;")],
    "edges4": [("constexpr int EDGES = 2;", "constexpr int EDGES = 4;")],
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIGNATURES = {"lif_crossbar_step": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P]}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _variant(source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise SystemExit(f"edit target not found: {old!r}")
        source = source.replace(old, new)
    return source


def build(k5_variants: list[str], k1_variants: list[str]) -> dict[str, ctypes.CDLL]:
    """Libraries ``relax_old``, ``lif_old``, ``relax_<variant>`` and ``lif_<variant>``."""
    lif = (_build.CSRC / "lif_crossbar.cu").read_text()
    relax = (_build.CSRC / "relax_round.cu").read_text()
    jobs = {"relax_old": (OLD / "relax_round.cu").read_text(),
            "lif_old": (OLD / "lif_crossbar.cu").read_text(),
            **{f"lif_{n}": _variant(lif, K5_VARIANTS[n]) for n in k5_variants},
            **{f"relax_{n}": _variant(relax, K1_VARIANTS[n]) for n in k1_variants}}
    procs = {}
    for name, text in jobs.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
               str(d / "k.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name} does not build:\n{out}")
        emit({"build": name, "ptxas": [ln for ln in out.splitlines() if "registers" in ln
                                       or "spill" in ln]})
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        if name == "lif_old":
            lib.lif_crossbar_step.argtypes = OLD_SIGNATURES["lif_crossbar_step"]
        elif name.startswith("relax_"):   # the C entry is unchanged
            lib.relax_round.argtypes = _build.SIGNATURES["relax_round"]["relax_round"]
        else:
            lib.lif_crossbar_step.argtypes = _build.SIGNATURES["lif_crossbar"]["lif_crossbar_step"]
        libs[name] = lib
    return libs


def timed(fn, trials=11, reps=10):
    """Device ms per call: median over trials of CUDA-event time of ``reps``
    back-to-back calls behind a sleep kernel (``chip_smoke.py``'s method);
    a call over 10 ms is timed alone, 3 times."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    if a.elapsed_time(b) > 10.0:
        trials, reps = 3, 1
    for _ in range(3):
        fn()
    times = []
    for _ in range(trials):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def in_turns(fns: dict) -> dict:
    """ms of each named call, timed A B .. B A: the two turns' times."""
    ms = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        ms[n].append(timed(fns[n]))
    return ms


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"relax_lif_ab: FAILED: {msg}")


# ---------------------------------------------------------------------- K5
def lif_call(lib, old: bool, s, w, v):
    """One launch of a K5 library on (G, B, n_in) x (G, n_in, n_out)
    inputs; the old body takes one block (G = 1)."""
    g, b, n_in = s.shape
    n_out = w.shape[2]
    out_s, out_v = torch.empty_like(v), torch.empty_like(v)
    args = (s.data_ptr(), w.data_ptr(), v.data_ptr(), out_s.data_ptr(), out_v.data_ptr())
    if old:
        check(g == 1, "the old K5 takes one block")
        err = lib.lif_crossbar_step(*args, b, n_in, n_out, 0.9, 1.0, 0.0, stream())
    else:
        err = lib.lif_crossbar_step(*args, g, b, n_in, n_out, 0.9, 1.0, 0.0, stream())
    check(err == 0, f"K5 launch failed with cudaError_t {err}")
    return out_s, out_v


def k5(libs, variants, blocks_np, smi):
    dev = torch.device("cuda")
    blocks = torch.as_tensor(blocks_np, device=dev)
    g_all, n_in, n_out = blocks.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    s = (torch.rand((g_all, chip_smoke.CROSSBAR_SAMPLES, n_in), generator=gen, device=dev)
         < chip_smoke.CROSSBAR_RATE).float()
    v = torch.zeros((g_all, chip_smoke.CROSSBAR_SAMPLES, n_out), device=dev)
    plain = ref.lif_crossbar_step_ref(s, blocks, v)
    one = [(s[i:i + 1], blocks[i:i + 1], v[i:i + 1]) for i in range(g_all)]
    old = libs["lif_old"]
    got = lif_call(old, True, *one[0])
    check(torch.equal(got[0], plain[0][:1]) and torch.equal(got[1], plain[1][:1]),
          "old K5 differs from its plain version")
    for name in variants:
        got = lif_call(libs[f"lif_{name}"], False, s, blocks, v)
        check(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]),
              f"K5 {name} differs from its plain version on the stack")
        got = lif_call(libs[f"lif_{name}"], False, *one[0])
        check(torch.equal(got[0], plain[0][:1]) and torch.equal(got[1], plain[1][:1]),
              f"K5 {name} differs from its plain version on one block")
    nbytes = (s.numel() + blocks.numel() + 3 * v.numel()) * 4
    base = libs[f"lif_{variants[0]}"]

    ms = in_turns({"old": lambda: lif_call(old, True, *one[0]),
                   **{n: (lambda lib=libs[f"lif_{n}"]: lif_call(lib, False, *one[0]))
                      for n in variants}})
    emit({"kernel": "lif_crossbar_step", "call": "G=1 (8,128,128)", "ms_in_turns": ms,
          "bound_ms": 1e3 * nbytes / g_all / chip_smoke.HBM_BYTES_PER_S, "nvidia_smi": smi})

    def seq(lib, is_old):
        for args in one:
            lif_call(lib, is_old, *args)

    ms = in_turns({"old_1013_sequential_g1": lambda: seq(old, True),
                   "new_1013_sequential_g1": lambda: seq(base, False),
                   **{f"{n}_stacked": (lambda lib=libs[f"lif_{n}"]: lif_call(lib, False, s,
                                                                             blocks, v))
                      for n in variants}})
    emit({"kernel": "lif_crossbar_step", "call": f"one step over G={g_all} blocks",
          "ms_in_turns": ms, "bound_ms": 1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S,
          "bytes": nbytes, "nvidia_smi": smi})


# ---------------------------------------------------------------------- K1
def relax_call(lib, dist, lams, csr, witness: bool):
    n, k = dist.shape
    best = torch.empty_like(dist)
    psrc = torch.empty(dist.shape, dtype=torch.int64, device=dist.device) if witness else None
    args = [dist.data_ptr(), lams.data_ptr(), csr.indptr.data_ptr(), csr.src.data_ptr(),
            csr.w.data_ptr(), csr.t.data_ptr(), best.data_ptr(),
            psrc.data_ptr() if witness else None, n, csr.n_actors, k, int(witness)]
    err = lib.relax_round(*args, stream())
    check(err == 0, f"K1 launch failed with cudaError_t {err}")
    return best, psrc


def k1_bytes(dist, lams, csr, witness):
    """``chip_smoke.py``'s count: row pointers, per edge src/w/t, each node's
    dist row and lams in; best (and psrc) out."""
    nk, k = dist.shape
    e = int(csr.src.numel())
    return (nk + 1) * 4 + e * (4 + 8 + 8) + nk * k * 8 + lams.numel() * 8 \
        + nk * k * 8 * (2 if witness else 1)


def k1_calls(dev):
    """{(name, path, shape): [launches, (dist, lams, csr)]} of chip_smoke's
    admission and dense phases, the inputs of each shape's first call."""
    calls = {}
    where = {"path": None}
    for name in ("relax_round", "relax_round_witness"):
        orig = getattr(ops, name)

        def spy(dist, lams, csr, _name=name, _orig=orig):
            shape = (dist.shape[0] // csr.n_actors, csr.n_actors, int(csr.src.numel()),
                     dist.shape[1])
            key = (_name, where["path"], shape)
            if key not in calls:
                calls[key] = [0, (dist.clone(), lams.clone(), csr)]
            calls[key][0] += 1
            return _orig(dist, lams, csr)

        setattr(ops, name, spy)
    ctl = runtime.AdmissionController(DYNAP_SE_1024, optimize_budget=chip_smoke.OPTIMIZE_BUDGET,
                                      device=dev)
    for app in chip_smoke.REQUESTS:
        ctl.register(apps.build_app(app))
    where["path"] = "admission"
    for app, k in chip_smoke.REQUESTS.items():
        ctl.admit(app, n_tiles_request=k)
    ctl.finish("CNN-MNIST")
    ctl.admit("CNN-MNIST", n_tiles_request=chip_smoke.REQUESTS["CNN-MNIST"])
    # the dense phase's K1 calls: CNN-MNIST's candidates on the 4x4 chip
    art = ctl.artifacts[("CNN-MNIST", DYNAP_SE_1024)]
    g = sdfg_from_clusters(art.clustered, hw=DYNAP_SE_16)
    b = np.random.default_rng(1).integers(0, DYNAP_SE_16.n_tiles,
                                          size=(chip_smoke.BATCH, g.n_actors))
    ob = engine.project_order_batch(art.single_order, b)
    where["path"] = "dense"
    engine.batch_execute(g, b, DYNAP_SE_16, ob, with_starts=True, device=dev)
    torch.cuda.synchronize()
    where["path"] = None
    return calls, ctl.artifacts[(chip_smoke.SNN_APP, DYNAP_SE_1024)].clustered


def k1(libs, variants, calls, smi):
    plain_of = {"relax_round": ref.segment_relax_ref,
                "relax_round_witness": ref.segment_relax_witness_ref}
    totals = collections.defaultdict(float)
    for (name, path, shape), (launches, (dist, lams, csr)) in sorted(
            calls.items(), key=lambda kv: (kv[0][0], kv[0][1], -kv[0][2][2])):
        witness = name == "relax_round_witness"
        plain = plain_of[name](dist, lams, csr)
        fns = {label: (lambda lib=libs[f"relax_{label}"]: relax_call(lib, dist, lams, csr,
                                                                      witness))
               for label in ["old", *variants]}
        for label, fn in fns.items():
            got = fn()
            check(torch.equal(got[0], plain[0] if witness else plain)
                  and (not witness or torch.equal(got[1], plain[1])),
                  f"{label} {name} differs from its plain version at {shape}")
        bound = 1e3 * k1_bytes(dist, lams, csr, witness) / chip_smoke.HBM_BYTES_PER_S
        ms = in_turns(fns)
        deg = torch.diff(csr.indptr.long())
        for label in ["old", *variants]:
            totals[(name, label)] += launches * (statistics.mean(ms[label]) - bound)
        emit({"kernel": name, "path": path, "shape": dict(zip("BnEK", shape)),
              "launches": launches,
              "in_degree_mean": float(deg.double().mean()), "in_degree_max": int(deg.max()),
              "ms_in_turns": ms, "bound_ms": bound, "nvidia_smi": smi})
    emit({"rule2_ms": {f"{n} {label}": v for (n, label), v in sorted(totals.items())},
          "nvidia_smi": smi})


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k5", default="base", help="comma-separated K5_VARIANTS")
    ap.add_argument("--k1", default="base", help="comma-separated K1_VARIANTS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    k5_variants, k1_variants = args.k5.split(","), args.k1.split(",")
    t0 = time.perf_counter()
    libs = build(k5_variants, k1_variants)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"phase": "build", "s": time.perf_counter() - t0, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    calls, cl = k1_calls(torch.device("cuda"))
    blocks_np, _, _ = chip_smoke.crossbar_blocks(cl)
    k5(libs, k5_variants, blocks_np, smi)
    k1(libs, k1_variants, calls, smi)


if __name__ == "__main__":
    main(sys.argv[1:])
