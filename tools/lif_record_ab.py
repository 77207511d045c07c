"""Side-by-side timing of the LIF recording's kernels on one GPU, in turns:
``lif_record`` (``csrc/lif_record.cu``) and ``spike_input``
(``csrc/spike_input.cu``) in named variants (edits of those sources and of
``csrc/spike_sum.cuh``), beside spike_input's body before its redesign
(``tools/pr24_kernels/spike_input.cu``).

On HeartClass's recording (256 steps, the draws of seed 0, LIFParams'
defaults), each ``lif_record`` variant's counts, last v and refr must equal
``ref.lif_record_ref`` on the host bit for bit; each ``spike_input`` body,
at the fired flags of recorded step ``--step`` (``chip_smoke.py``'s
``recorded_spikes``) and at all-one spikes, must equal
``ref.spike_input_ref`` on the host bit for bit; a ``diag_`` variant gives
wrong results on purpose and is only timed.  The first variant's barrier
floor (its grid meeting 256 times, doing nothing) and the launch floor (an
empty launch) are timed beside them.

Run from the repository root on a machine with the card:

    python3 tools/lif_record_ab.py --record base,no_cache,diag_nosum --spike base,walk_shfl,pr24

One JSON line per measurement, each with the card's name and power limit.
It exits non-zero if a kernel does not build or differs from its plain
version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from relax_lif_ab import in_turns, timed  # noqa: E402
from repro_torch.core import apps, lif  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

OUT = ROOT / "build" / "repro_torch_kernels" / "lif_record_ab"
SUM = "spike_sum.cuh"


def _threads(n):
    return [("lif_record.cu", "constexpr int THREADS = 1024;", f"constexpr int THREADS = {n};")]


def _batch(n):
    return [(SUM, "constexpr int BATCH = 4;", f"constexpr int BATCH = {n};")]


_COMPACT = """    int count = 0;
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const unsigned live = __ballot_sync(FULL, p[k] != 0.0f);   // a NaN product is != 0
      if (p[k] != 0.0f) buf[count + __popc(live & below)] = p[k];
      count += __popc(live);
    }
    // +0 after the last product: the walk reads 8 at a time, and
    // acc + (+0) == acc (acc is never -0)
    if (lane < 8) buf[count + lane] = 0.0f;
    __syncwarp();
    for (int i = 0; i < count; i += 8) {
      const float4 a = *reinterpret_cast<const float4*>(buf + i);
      const float4 b = *reinterpret_cast<const float4*>(buf + i + 4);
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, a.x), a.y), a.z), a.w);
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, b.x), b.y), b.z), b.w);
    }
    __syncwarp();
"""
#: the walk of spike_sum.cuh's first form: a shuffle from each set bit's lane
_SHUFFLE = """#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      unsigned live = __ballot_sync(FULL, p[k] != 0.0f);
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        acc = __fadd_rn(acc, __shfl_sync(FULL, p[k], j));
      }
    }
"""


def _walk_shfl():
    return [(SUM, _COMPACT, _SHUFFLE)]


_WALK8 = """    for (int i = 0; i < count; i += 8) {
      const float4 a = *reinterpret_cast<const float4*>(buf + i);
      const float4 b = *reinterpret_cast<const float4*>(buf + i + 4);
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, a.x), a.y), a.z), a.w);
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, b.x), b.y), b.z), b.w);
    }"""
#: the compacted walk one product at a time
WALK_ONE = [(SUM, _WALK8, "    for (int i = 0; i < count; ++i) acc = __fadd_rn(acc, buf[i]);")]
#: the compacted walk replaced by one add a batch (wrong sums, timed only)
DIAG_NOWALK = [(SUM, _WALK8, "    acc = __fadd_rn(acc, buf[0]);")]
#: two blocks of 1024 threads an SM: at most 32 registers a thread
MIN2 = [("lif_record.cu", "__global__ void __launch_bounds__(THREADS)\nlif_record_kernel(",
         "__global__ void __launch_bounds__(THREADS, 2)\nlif_record_kernel(")]


def _cost(n):
    return [("lif_record.cu", "constexpr int NEURON_COST = 32;",
             f"constexpr int NEURON_COST = {n};")]


#: name -> (file, old, new) edits of lif_record.cu and spike_sum.cuh
RECORD_VARIANTS = {
    "base": [],
    "t256": _threads(256),
    "t512": _threads(512),
    "batch1": _batch(1),
    "batch2": _batch(2),
    "batch8": _batch(8),
    "cost0": _cost(0),
    "cost8": _cost(8),
    "cost128": _cost(128),
    # equal ranges of neurons: a neuron outweighs every synapse
    "by_neurons": _cost(1 << 20),
    "walk_shfl": _walk_shfl(),
    "walk_one": WALK_ONE,
    "min2": MIN2,
    # no synapse in shared memory: every step reads them from the L2
    "no_cache": [("lif_record.cu",
                  "  *smem = mask_bytes + (size_t)*cap * (sizeof(int) + sizeof(float));",
                  "  *cap = 0;\n  *smem = mask_bytes;")],
    # wrong results, timed only: no synaptic sums; no grid barrier (the
    # blocks race through the steps); the walk cut to an add a batch
    "diag_nosum": [("lif_record.cu", """        const float acc = spike_sum::ordered_sum(syn, indptr[u], indptr[u + 1],
                                                 MaskSpikes{smask}, lane, buf[warp]);""",
                    "        const float acc = 0.0f;")],
    "diag_nobarrier": [("lif_record.cu", "    if (!last) grid.sync();",
                        "    if (!last) __syncthreads();")],
    "diag_nowalk": DIAG_NOWALK,
}
#: name -> edits of spike_input.cu and spike_sum.cuh; "pr24" is the old body
SPIKE_VARIANTS = {"base": [], "batch1": _batch(1), "batch2": _batch(2), "batch8": _batch(8),
                  "walk_shfl": _walk_shfl(), "walk_one": WALK_ONE, "diag_nowalk": DIAG_NOWALK,
                  "pr24": None}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"lif_record_ab: FAILED: {msg}")


def _edited(name: str, edits) -> str:
    text = (_build.CSRC / name).read_text()
    for file, old, new in edits:
        if file == name:
            check(old in text, f"edit target not found in {name}: {old!r}")
            text = text.replace(old, new)
    return text


def build(record: list[str], spike: list[str]) -> dict[str, ctypes.CDLL]:
    """Libraries ``record_<variant>`` and ``spike_<variant>``, built in
    parallel, each beside its own edited copy of the headers."""
    jobs = {}
    for name in record:
        jobs[f"record_{name}"] = ("lif_record", RECORD_VARIANTS[name])
    for name in spike:
        jobs[f"spike_{name}"] = ("spike_input", SPIKE_VARIANTS[name])
    procs = {}
    for job, (stem, edits) in jobs.items():
        d = OUT / job
        d.mkdir(parents=True, exist_ok=True)
        if edits is None:
            (d / "k.cu").write_text((ROOT / "tools" / "pr24_kernels" / f"{stem}.cu").read_text())
        else:
            (d / "k.cu").write_text(_edited(f"{stem}.cu", edits))
            for header in _build.CSRC.glob("*.cuh"):
                (d / header.name).write_text(_edited(header.name, edits))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
               str(d / "k.cu")]
        procs[job] = (stem, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for job, (stem, proc) in procs.items():
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"{job} does not build:\n{out}")
        emit({"build": job, "ptxas": [ln.strip() for ln in out.splitlines()
                                      if "registers" in ln or "spill" in ln]})
        lib = ctypes.CDLL(str(OUT / job / "lib.so"))
        for fn, argtypes in _build.SIGNATURES[stem].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
        libs[job] = lib
    return libs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default="base", help="lif_record variants, comma-separated")
    ap.add_argument("--spike", default="base,pr24", help="spike_input variants, comma-separated")
    ap.add_argument("--step", type=int, default=chip_smoke.SI_STEP,
                    help="the recorded step whose fired flags spike_input sums")
    args = ap.parse_args(argv)
    record = [v for v in args.record.split(",") if v]
    spike = [v for v in args.spike.split(",") if v]
    check(set(record) <= set(RECORD_VARIANTS) and set(spike) <= set(SPIKE_VARIANTS),
          f"unknown variants: {sorted(set(record) - set(RECORD_VARIANTS))} "
          f"{sorted(set(spike) - set(SPIKE_VARIANTS))}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    t0 = time.perf_counter()
    libs = build(record, spike)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"phase": "build", "s": time.perf_counter() - t0,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})

    dev = torch.device("cuda")
    snn = apps.build_app(chip_smoke.SNN_APP)
    params = lif.LIFParams()
    n, steps = snn.n_neurons, chip_smoke.SNN_STEPS
    csr, is_input = lif.snn_tensors(snn, dev)
    e = int(csr.pre.numel())
    draws = lif.input_draws(n, steps, 0, dev)
    host = ref.lif_record_ref(*lif.snn_tensors(snn, "cpu"), draws.cpu(), params)
    masks = torch.empty((2 * (-(-n // 32)),), dtype=torch.int32, device=dev)
    in_u8 = is_input.view(torch.uint8)

    def record_call(lib):
        out = (torch.empty(n, device=dev), torch.empty(n, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev))
        err = lib.lif_record(csr.indptr.data_ptr(), csr.pre.data_ptr(), csr.weight.data_ptr(),
                             in_u8.data_ptr(), draws.data_ptr(), *(t.data_ptr() for t in out),
                             masks.data_ptr(), n, e, steps, params.v_threshold, params.v_reset,
                             params.leak, params.refractory, params.input_rate, stream())
        check(err == 0, f"lif_record launch failed with cudaError_t {err}")
        return out

    fns = {}
    for name in record:
        lib = libs[f"record_{name}"]
        got = record_call(lib)
        torch.cuda.synchronize()
        same = all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, host))
        check(same or name.startswith("diag_"), f"lif_record {name} differs from its plain version")
        grid = (ctypes.c_int * 5)()
        check(lib.lif_record_grid(n, e, grid) == 0, "lif_record_grid failed")
        emit({"kernel": "lif_record", "variant": name, "bit_identical": same,
              "grid": dict(zip(("blocks", "threads", "chunk", "cached_synapses",
                                "smem_bytes"), grid))})
        fns[name] = lambda lib=lib: record_call(lib)
    if fns:
        emit({"kernel": "lif_record", "app": chip_smoke.SNN_APP, "steps": steps,
              "ms_in_turns": in_turns(fns), "nvidia_smi": smi})
        base = libs[f"record_{record[0]}"]
        emit({"floors": {
            "barrier_ms": timed(lambda: base.lif_barrier_floor(n, e, steps, stream())),
            "barrier_grid_of": record[0],
            "launch_ms": timed(lambda: base.empty_launch(stream())),
        }, "nvidia_smi": smi})

    s_step = chip_smoke.recorded_spikes(csr, is_input, draws, params, args.step)
    outdeg = torch.bincount(csr.pre.long(), minlength=n)
    active = int(outdeg[s_step.bool()].sum())
    host_csr = ref.SynapseCSR(**{f: getattr(csr, f).cpu()
                                 for f in ("indptr", "pre", "weight", "post")})
    for label, s in (("step", s_step), ("all_one", torch.ones_like(s_step))):
        want = ref.spike_input_ref(s.cpu(), host_csr)
        fns = {}
        for name in spike:
            lib = libs[f"spike_{name}"]

            def call(lib=lib, s=s):
                out = torch.empty_like(s)
                err = lib.spike_input(csr.indptr.data_ptr(), csr.pre.data_ptr(),
                                      csr.weight.data_ptr(), s.data_ptr(), out.data_ptr(), n,
                                      stream())
                check(err == 0, f"spike_input launch failed with cudaError_t {err}")
                return out

            check(torch.equal(call().cpu().view(torch.int32), want.view(torch.int32))
                  or name.startswith("diag_"),
                  f"spike_input {name} differs from its plain version at {label}")
            fns[name] = call
        emit({"kernel": "spike_input", "spikes": label, "step": args.step,
              "active_synapses": active if label == "step" else int(csr.pre.numel()),
              "synapses": int(csr.pre.numel()), "bit_identical": [v for v in spike if not v.startswith("diag_")],
              "ms_in_turns": in_turns(fns), "nvidia_smi": smi})
    emit({"ok": True, "wall_s": time.perf_counter() - t0,
          "note": "ms_in_turns: a variant's device ms in the first and the second turn"})


if __name__ == "__main__":
    main()
