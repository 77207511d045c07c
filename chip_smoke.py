"""Drive the PyTorch/CUDA port's compile-and-admit, joint placement and serving,
SNN execution and LM serving paths on one GPU.

Run from the repository root:  ``PYTHONPATH=src python3 chip_smoke.py``
(the script also finds ``src/`` beside itself).  It needs one CUDA device
and ``nvcc``; it builds the kernels under ``build/repro_torch_kernels/``
first.  Without a CUDA device, or without the repository beside it, it
exits non-zero and prints no result.

Phases (each one fails the run if it fails; JSON lines on stdout):

1. env        torch/CUDA versions, card name and power limit, kernel build time
2. admission  the main path: an isolated-placement AdmissionController on the
              32x32 chip registers the eight Table-1 apps at their published
              sizes and admits each (2..16 tiles), then finishes one and
              re-admits it (a cache hit), that one under torch.profiler (its
              host wall split into numpy and Python, torch's dispatch and the
              host's waits on the card).  K1 must launch on every admission.
3. dense      the Eq.-4 start-time path and the dense backend on the card
              (K2, K3 and the G = 1 matmul), held against the exact search
4. crosscheck one admission replayed with device="cpu" (identical binding,
              throughput within 1e-8) and the largest stack the admission
              phase solved (HeartClass's) by "csr" on the card against
              "edges" on the host (rtol 1e-8)
5. joint_serving the joint, region-scoped controller on the 32x32 chip at the
              stress and serving harnesses' defaults: 224 synthetic tenants
              (scale 0.06) registered, 640 Zipf-1.1 churn events drained
              through a ServingQueue in windows of 16 (one flush profiled),
              then the faults harness's 30-fault storm through inject_fault,
              inject_drift and heal; every ticket processed, no rebalance
              below the chip throughput before it, no remap below its seed,
              no resident on a dead tile after any storm event, cached chip
              metrics within 1e-6 of the exact union's after the drain and
              the storm; K1 must launch
6. joint_crosscheck the faults harness's smoke configuration (64 tiles, 10
              tenants, 16 churn events through a ServingQueue, a 6-fault
              storm) with "csr" on the card and on the host: trajectory,
              bindings, chip metrics and every ChipMetrics field equal; with
              "edges" on the host, the card run's final placement scored
              again within 1e-8 (the runs part where scores tie within the
              search's tolerance; where is printed); the largest fused stack
              of phase 5 on the card, each member's rows equal to its own
              solve and within 1e-8 of "edges"
7. lm_serve   the LM serving path: qwen2-1.5b at full width, float32 params
              from a seeded generator, served with the reference's defaults
              (8 requests, 32 prompt + 32 generated tokens, greedy); the
              prefill step on the same prompts (flash kernel, float32) held
              against the serve loop's teacher-forced decode logits (plain
              attention) at the reference's 2e-2, and its last argmax against
              the first generated token
8. lm_prefill the prefill step in bf16 params (as the reference's prefill cell
              lowers it): qwen2-1.5b at (1, 32768) tokens, prefill_32k's
              length with the batch cut from 32 to 1, then starcoder2-3b at
              (1, 8192), whose 4096-token window runs the kernel's window
              branch; each model is freed before the next
9. snn_crossbar the SNN execution path on HeartClass (24,732 neurons, 2.4M
              synapses): (a) simulate_spikes on the card, 256 steps, twice,
              and on the host with the same draws: every neuron's count the
              same in all three (the synaptic sum, spike_input, adds in a
              fixed order); (b) the example's path over every cluster of
              the admission phase's clustering: one 128x128 crossbar block
              per cluster, 8 samples of rate-0.15 input spikes, 5 steps with
              spikes fed back, each step one stacked K5 launch over all the
              blocks; then the example's own 2-D loop (G = 1 calls) over its
              first 4 clusters, equal to the stack's rows bit for bit; the
              whole stacked trajectory bit-identical to the plain version and
              K5 launched 5 x (1 + 4) times
10. jamba_serve jamba-v0.1-52b cut to one of its four 8-layer blocks, float32
              params from seed 0, served at the reference's defaults; the
              prefill step on the same prompts (one chunk) launches K7 7 times
              (no states pass, no combine) and K6 once; the first Mamba
              layer's prefill output (K7) held against its token-by-token
              decode (plain) within MAMBA_CONTEXT_TOL of the decode output's rms
11. jamba_prefill the same cut in bf16 params at (1, 32768) tokens,
              prefill_32k's length with the batch cut from 32 to 1: each of
              the 7 Mamba layers launches K7's states-only pass, the combine
              and K7 once each; a second, profiled run splits their device
              time into the three
12. kernels   every kernel against its plain PyTorch version on the card, with
              times and bounds, on the inputs of its largest call in phases
              2-11: K1-K5 bit-identical; flash attention, also at its largest
              float32 call, its largest windowed call and its largest
              dense-model prefill call (qwen2-1.5b's 32k, timed against SDPA
              as the largest is), within kernels/ref.py's ATTN_TOL (per
              element one rounding step of the output type plus 2^-14 of its
              row's root mean square); all four flash comparisons are
              printed before any is checked; each flash call also timed
              against one F.scaled_dot_product_attention call for the same
              masks (a boolean mask for the window), whose own distance from
              the plain version is printed as library_tol_ratio;
              K7 within kernels/ref.py's SCAN_TOL at its last largest call
              (from combined, nonzero chunk states), its states-only pass
              within half the state's limit (and equal to the full launch's
              states in the same exp mode), the combine within the state's
              limit; spike_input bit-identical to the host's; K1 and K7, launched on
              two paths each, also timed at each path's largest call; K1 and
              K5 also checked and timed at the first call of every distinct
              shape of each path (``by_shape``: K5's stacked step and the
              example's G = 1 call; K1's admission and dense shapes and the
              10 joint_serving shapes with the most launches, with the
              launch-weighted ``rule2_ms``)

Launch counts are set to 0 just before each path's phase (2, 3, 5, 7-11) and
read just after, and reported per path; launches made to compare or time
kernels do not count.
"""

from __future__ import annotations

import collections
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet peaks (dense, without sparsity, at 700 W);
#: the flop rates count an FMA, one instruction, as two flops
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12     # float32 outside the tensor cores
FP64_FLOPS_PER_S = 34e12     # float64 outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # bf16 on the tensor cores
#: a (max,+) term is two float32 instructions (FADD, FMNMX), so it takes
#: the dispatch slots of four data-sheet flops; FMNMX's own rate on sm_90
#: (64 per clock per SM, half the FADD rate) gives the same bound
MAXPLUS_TERMS_PER_S = FP32_FLOPS_PER_S / 4
#: a K1 term dist + (w - lam*t) against the running max is four float64
#: instructions (DMUL, DADD, DADD, DSETP)
RELAX_TERMS_PER_S = FP64_FLOPS_PER_S / 8
#: each of K7's expf issues one MUFU.EX2: 16 a clock per SM, 132 SMs, at the
#: H100 SXM's 1.98 GHz boost clock (a second bound, beside the table's)
EX2_PER_S = 132 * 16 * 1.98e9

#: n_tiles_request per app, each between 2 and 16
REQUESTS = {
    "ImgSmooth": 2, "EdgeDet": 4, "MLP-MNIST": 2, "HeartEstm": 8,
    "HeartClass": 16, "CNN-MNIST": 4, "LeNet-MNIST": 8, "LeNet-CIFAR": 16,
}
OPTIMIZE_BUDGET = (2, 64)
BATCH = 64                   # candidate rows of the dense-path stack
#: tokens of starcoder2-3b's bf16 prefill: twice its 4096-token window
STARCODER2_TOKENS = 8_192
#: the reference's own decode-vs-forward contract (tests/test_models_smoke.py)
SERVE_RTOL = SERVE_ATOL = 2e-2
PROFILED_DECODE_STEPS = 4
#: the SNN execution path: the largest Table-1 app and the example's inputs
SNN_APP = "HeartClass"
SNN_STEPS = 256              # simulate_spikes' default
CROSSBAR_SAMPLES, CROSSBAR_RATE, CROSSBAR_STEPS = 8, 0.15, 5
#: clusters the example's own 2-D loop (one G = 1 call a step) runs over
CROSSBAR_EXAMPLE_CLUSTERS = 4
#: the first Mamba layer's prefill (chunked scan, K7) against its decode
#: recurrence (plain), float32: at most this share of the decode output's rms
MAMBA_CONTEXT_TOL = 1e-4
JAMBA = "jamba-v0.1-52b"
#: kernels whose largest call is the last of equal size (K7's second launch
#: of a scan starts from the combined chunk states, not zeros)
KEEP_LAST_OF_EQUAL = ("mamba_chunk_scan",)
#: kernels launched on more than one path at different shapes: each is also
#: timed at every path's largest call (the rule-2 order weighs launches by it)
BY_PATH = ("relax_round", "relax_round_witness", "mamba_chunk_scan")
#: kernels also checked and timed at the first call of every distinct shape
#: of each path
BY_SHAPE = ("relax_round", "relax_round_witness", "lif_crossbar_step")
#: paths with hundreds of K1 shapes: only this many, those with the most
#: launches, are checked and timed by shape
BY_SHAPE_TOP = {"joint_serving": 10}
#: joint_serving: the stress and serving harnesses' defaults
#: (benchmarks/stress.py, benchmarks/serving.py): tenants drawn at this
#: scale, the joint search budget, Zipf-1.1 churn drained in windows
JOINT_TENANTS, JOINT_SCALE, JOINT_BUDGET = 224, 0.06, (1, 6)
JOINT_EVENTS, JOINT_WINDOW, ZIPF_S = 640, 16, 1.1
#: then the faults harness's full storm (benchmarks/faults.py)
JOINT_FAULTS = 30
JOINT_STORM = dict(seed=2, tiles_per_fault=2, heal_after=4.0, p_throttle=0.15,
                   p_drift=0.15, max_dead_frac=0.10)
#: the flush of the drain that is run under torch.profiler (of 40)
PROFILED_FLUSH = 20
#: joint_crosscheck: the faults harness's smoke configuration
SMOKE_TILES, SMOKE_TENANTS, SMOKE_EVENTS, SMOKE_FAULTS = 64, 10, 16, 6
SMOKE_STORM = dict(seed=2, tiles_per_fault=1, heal_after=2.0, p_throttle=0.15,
                   p_drift=0.15, max_dead_frac=0.15)
#: host calls that wait for the card (syncs, and copies out of it)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpyAsync", "cudaMemcpy")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def crossbar_blocks(cl, size: int = 128):
    """One dense (size, size) float32 crossbar block per cluster of a
    ``ClusteredSNN``, as ``examples/snn_on_tpu.py`` builds them: rows are
    the cluster's distinct presynaptic neurons in increasing id, columns its
    member neurons in increasing id, and each synapse adds its weight in
    synapse order.  Returns ``(blocks (n_clusters, size, size), inputs per
    cluster, members per cluster)``."""
    import numpy as np

    work, k = cl.snn, cl.n_clusters
    n = work.n_neurons
    members = np.bincount(cl.cluster_of, minlength=k)
    col = np.empty(n, dtype=np.int64)      # a neuron's rank within its cluster
    starts = np.cumsum(members) - members
    col[np.lexsort((np.arange(n), cl.cluster_of))] = np.arange(n) - np.repeat(starts, members)
    syn_cluster = cl.cluster_of[work.post].astype(np.int64)
    keys, row = np.unique(syn_cluster * n + work.pre, return_inverse=True)
    first = np.searchsorted(keys, np.arange(k, dtype=np.int64) * n)
    row = row.reshape(-1) - first[syn_cluster]
    inputs = np.diff(np.append(first, keys.size))
    if max(members.max(initial=0), inputs.max(initial=0)) > size:
        raise ValueError(f"a cluster needs more than {size} crossbar rows or columns")
    blocks = np.zeros((k, size, size), dtype=np.float32)
    np.add.at(blocks, (syn_cluster, row, col[work.post]), work.weight.astype(np.float32))
    return blocks, inputs, members


def zipf_stream(names, n_events, seed=1):
    """The stress harness's churn: ``n_events`` tenant picks, Zipf-``ZIPF_S``
    over the tenants in order, from ``default_rng(seed)``."""
    import numpy as np

    r = np.arange(1, len(names) + 1, dtype=np.float64) ** -ZIPF_S
    probs = r / r.sum()
    rng = np.random.default_rng(seed)
    return [names[int(rng.choice(len(names), p=probs))] for _ in range(n_events)]


def tiles_request(n_clusters: int) -> int:
    """The stress harness's request: a small footprint a tenant."""
    return max(1, min(4, n_clusters))


def joint_controller(runtime, workloads, hw, n_tenants, device, backend="auto"):
    """A joint, region-scoped controller with ``n_tenants`` tenants of the
    stress harness registered; returns it, the names and the requests."""
    tenants = workloads.workload_suite(n_tenants, seed=0, scale=JOINT_SCALE)
    ctl = runtime.AdmissionController(
        hw, placement="joint", joint_budget=JOINT_BUDGET, full_rebalance_every=0,
        backend=backend, device=device)
    requests = {}
    for snn in tenants:
        requests[snn.name] = tiles_request(ctl.register(snn).clustered.n_clusters)
    return ctl, [snn.name for snn in tenants], requests


def drain_churn(serving, ctl, names, requests, n_events):
    """Submit the churn to a ServingQueue, admitting a tenant when it is
    absent from the queued trajectory and evicting it when present (the
    serving harness's burst mode), and drain it."""
    q = serving.ServingQueue(ctl, coalesce_window=JOINT_WINDOW)
    resident = set()
    for name in zipf_stream(names, n_events):
        if name in resident:
            q.submit_evict(name)
            resident.discard(name)
        else:
            q.submit_admit(name, n_tiles_request=requests[name])
            resident.add(name)
    return q, q.drain()


def regressions(events) -> int:
    """Rebalances whose chip throughput fell below the chip's just before
    them (the serving harness's never-regress rule, 1 - 1e-6)."""
    bad, prev = 0, None
    for e in events:
        if e.chip_throughput and e.chip_throughput > 0:
            if e.kind == "rebalance" and prev and e.chip_throughput < prev * (1 - 1e-6):
                bad += 1
            prev = e.chip_throughput
        elif e.kind in ("admit", "evict", "finish"):
            prev = e.chip_throughput or None
    return bad


def drive_storm(ctl, storm):
    """Drive a failure storm through the fault runtime, each pick mapped
    onto the currently bound tiles and resident apps as
    ``benchmarks/faults.py`` maps it.  Checks after every event that no
    resident sits on a dead tile; returns (kind, wall s, displaced) per
    event driven."""
    side = ctl.hw.mesh_shape[1]
    n_tiles = ctl.hw.n_tiles

    def bound_tiles():
        return sorted({int(t) for ts in ctl.running().values() for t in ts})

    def target_link(a, horiz):
        bound = bound_tiles()
        base = bound[a % len(bound)] if bound else a
        if horiz:
            nb = base + 1 if base % side + 1 < side else base - 1
        else:
            nb = base + side if base + side < n_tiles else base - side
        return (min(base, nb), max(base, nb))

    out, heal_map, link_map = [], {}, {}
    for i, ev in enumerate(storm):
        t = time.perf_counter()
        if ev.kind == "fail":
            bound = [x for x in bound_tiles() if not ctl.chip.dead[x]]
            tiles = tuple(sorted({bound[x % len(bound)] for x in ev.tiles} if bound
                                 else {x for x in ev.tiles if not ctl.chip.dead[x]}))
            heal_map[ev.tiles] = tiles
            if not tiles:
                continue
            displaced = ctl.inject_fault(list(tiles))
        elif ev.kind == "heal" and ev.link is not None:
            link = link_map.pop(ev.link, None)
            if link is None or link not in ctl.chip.link_throttle:
                continue
            displaced = ctl.heal(links=[link])
        elif ev.kind == "heal":
            tiles = tuple(x for x in heal_map.pop(ev.tiles, ev.tiles) if ctl.chip.dead[x])
            if not tiles:
                continue
            displaced = ctl.heal(list(tiles))
        elif ev.kind == "throttle":
            a, b = ev.link
            link = target_link(a, horiz=(b - a == 1))
            link_map[ev.link] = link
            displaced = ctl.inject_fault(links=[link], throttle=ev.factor)
        else:
            app = ev.app
            if app not in ctl.state.allocated:
                res = sorted(ctl.state.allocated)
                if not res:
                    continue
                app = res[i % len(res)]
            displaced = ctl.inject_drift(app, ev.factor)
        out.append((ev.kind, time.perf_counter() - t, len(displaced)))
        dead = [n for n, ts in ctl.running().items() if any(ctl.chip.dead[int(x)] for x in ts)]
        check(not dead, f"storm event {i} ({ev.kind}) left {dead} on dead tiles")
    return out


def _leaves(tree):
    """The tensors of a nested dict of parameters."""
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}; run from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    import dataclasses

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.core import apps, engine, lif, maxplus, runtime, serving, workloads
    from repro_torch.core.hardware import DYNAP_SE, DYNAP_SE_1024, DYNAP_SE_16
    from repro_torch.core.sdfg import sdfg_from_clusters
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import maxplus_bellman as kbell
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import mamba as tmamba
    from repro_torch.models.blocks import rms_norm
    from repro_torch.models import transformer as ttf

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. env -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0].strip() if smi else "nvidia-smi: no output"
    t0 = time.perf_counter()
    _build.build_all()
    emit({
        "phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(), "nvidia_smi": smi_line,
        "kernel_build_s": time.perf_counter() - t0,
    })

    def reset():
        ops.reset_launches()
        kbell.reset_counts()

    def device_us(prof):
        """Device µs per kernel or copy of a ``torch.profiler`` run.  Only
        the device's own events count: a host op's row repeats the time of
        the kernels it launched."""
        out = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                out[ev.key] = us
        return out

    def host_split(fn):
        """Run ``fn`` once under ``torch.profiler``: (its result, its wall
        split into the host time inside torch's calls, those of them that
        wait for the card (``SYNC_CALLS``), and the rest (numpy and Python),
        with the card's busy share, K1 launches and the λ-search's host
        reads).  ``profiler_s`` is the time the profiler itself took after
        ``fn`` returned (stopping the trace, reading its events)."""
        k1 = ops.LAUNCHES["relax_round"], ops.LAUNCHES["relax_round_witness"]
        syncs = kbell.COUNTS["syncs"]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
        ]) as prof:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        host_us = {}
        t_done = t + wall
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CPU and ev.self_cpu_time_total > 0:
                host_us[ev.key] = ev.self_cpu_time_total
        torch_s = sum(host_us.values()) / 1e6
        sync_s = sum(v for k, v in host_us.items() if k in SYNC_CALLS) / 1e6
        busy_s = sum(device_us(prof).values()) / 1e6
        return out, {
            "profiler_s": time.perf_counter() - t_done,
            "wall_s": wall, "torch_host_s": torch_s, "torch_dispatch_s": torch_s - sync_s,
            "host_sync_s": sync_s, "host_numpy_python_s": wall - torch_s,
            "device_busy_s": busy_s, "device_busy_share": busy_s / wall,
            "relax_round_launches": ops.LAUNCHES["relax_round"] - k1[0],
            "relax_round_witness_launches": ops.LAUNCHES["relax_round_witness"] - k1[1],
            "host_syncs": kbell.COUNTS["syncs"] - syncs,
            "top_host_us": sorted(host_us.items(), key=lambda kv: -kv[1])[:8],
            "source": "torch.profiler, self CPU time of torch's host events; "
                      "host syncs: " + ", ".join(SYNC_CALLS),
        }

    launches = {k: {} for k in ops.LAUNCHES}   # kernel -> {path: launches}

    def read_into(path):
        for k, v in ops.LAUNCHES.items():
            launches[k][path] = v

    # Every wrapper is spied on: per path, the shapes it was given, and the
    # inputs of its largest call, on which phase 12 times and checks it.
    where = {"path": None, "app": None}
    seen = {k: {} for k in ops.LAUNCHES}        # kernel -> {path: Counter(shape)}
    largest = {}                                # kernel -> dict(work, path, app, shape, args, kwargs)
    flash_largest = {}    # "float32" / "windowed" / "lm_prefill" (qwen2's 32k) -> the same
    path_largest = {k: {} for k in BY_PATH}     # kernel -> {path: the same}
    first_of_shape = {k: {} for k in BY_SHAPE}  # kernel -> {(path, shape): the same}

    def k1_shape(dist, lams, csr):
        return (dist.shape[0] // csr.n_actors, csr.n_actors, int(csr.src.numel()), dist.shape[1])

    shape_of = {      # kernel -> (shape names, shape of a call)
        "relax_round": ("BnEK", k1_shape),
        "relax_round_witness": ("BnEK", k1_shape),
        "maxplus_bmm": ("GMKN", lambda a, b: (*a.shape, b.shape[2])),
        "maxplus_bmv": ("GMK", lambda a, x: tuple(a.shape)),
        "maxplus_matmul": ("MKN", lambda a, b: (*a.shape, b.shape[1])),
        "flash_attention": (("B", "Hq", "Hkv", "Sq", "Skv", "D"),
                            lambda q, k, v, **kw: (*q.shape[:2], k.shape[1], q.shape[2],
                                                   k.shape[2], q.shape[3])),
        "lif_crossbar_step": (("G", "B", "n_in", "n_out"),
                              lambda s, w, v, **kw: ((s.shape[0] if s.dim() == 3 else 1),
                                                     *s.shape[-2:], w.shape[-1])),
        "mamba_chunk_scan": (("B", "L", "D", "N"),
                             lambda x, dt, a, b, c, h0, **kw: (*x.shape, a.shape[1])),
        "mamba_chunk_states": (("B", "L", "D", "N"),
                               lambda x, dt, a, b, **kw: (*x.shape, a.shape[1])),
        "mamba_chunk_combine": (("B", "L", "D", "N"),
                                lambda dt, a, s_local, **kw: (*dt.shape, a.shape[1])),
        "spike_input": (("n", "E"), lambda s, csr: (s.shape[0], int(csr.pre.numel()))),
    }

    def work(name, shape):    # E*K terms for K1, the product of the dims otherwise
        return shape[2] * shape[3] if name.startswith("relax") else math.prod(shape)

    def keep_if_larger(table, key, name, shape, args, kwargs, kept=None):
        """Store this call under ``key`` if it is the larger (``kept``: the
        same call's entry from another table, shared instead of cloned)."""
        if key in table and name in KEEP_LAST_OF_EQUAL:
            larger = work(name, shape) >= table[key]["work"]
        else:
            larger = key not in table or work(name, shape) > table[key]["work"]
        if not larger:
            return None
        table[key] = kept or {
            "work": work(name, shape), "path": where["path"], "app": where["app"],
            "shape": shape, "kwargs": dict(kwargs), "args": tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args),
        }
        return table[key]

    def spy(name):
        orig = getattr(ops, name)

        def call(*args, **kwargs):
            if where["path"] is not None and args[0].is_cuda:
                shape = tuple(int(d) for d in shape_of[name][1](*args, **kwargs))
                seen[name].setdefault(where["path"], collections.Counter())[shape] += 1
                kept = keep_if_larger(largest, name, name, shape, args, kwargs)
                if name in BY_PATH:
                    keep_if_larger(path_largest[name], where["path"], name, shape, args, kwargs,
                                   kept)
                if name in BY_SHAPE:
                    keep_if_larger(first_of_shape[name], (where["path"], shape), name, shape,
                                   args, kwargs)
                if name == "flash_attention":
                    if args[0].dtype == torch.float32:
                        keep_if_larger(flash_largest, "float32", name, shape, args, kwargs)
                    if kwargs.get("window", 0) > 0:
                        keep_if_larger(flash_largest, "windowed", name, shape, args, kwargs)
                    if where["path"] == "lm_prefill":
                        keep_if_larger(flash_largest, "lm_prefill", name, shape, args, kwargs)
            return orig(*args, **kwargs)

        setattr(ops, name, call)

    for name in shape_of:
        spy(name)

    # -- 2. admission (main path) -----------------------------------------
    t_phase = time.perf_counter()
    ctl = runtime.AdmissionController(
        DYNAP_SE_1024, optimize_budget=OPTIMIZE_BUDGET, device=dev
    )
    register_s, snns = {}, {}
    for name in REQUESTS:
        t = time.perf_counter()
        snns[name] = apps.build_app(name)
        ctl.register(snns[name])
        register_s[name] = time.perf_counter() - t
    emit({"phase": "register", "apps": {
        name: {"clusters": ctl.artifacts[(name, DYNAP_SE_1024)].clustered.n_clusters,
               "wall_s": s} for name, s in register_s.items()}})

    # the largest stack the admission phase solves, for phase 4
    solved = {"size": -1}
    mcr_batch = engine.mcr_batch

    def mcr_spy(stack, **kw):
        if stack.n_graphs * stack.n_edges > solved["size"]:
            solved.update(size=stack.n_graphs * stack.n_edges, app=where["app"],
                          stack=stack, lo0=kw.get("lo0"))
        return mcr_batch(stack, **kw)

    engine.mcr_batch = mcr_spy
    where["path"] = "admission"
    reset()
    events = []

    def admit(name, k, profiled=None):
        where["app"] = name
        before = ops.LAUNCHES["relax_round"]
        shapes_before = dict(ctl.cache_stats.shapes)
        syncs_before = kbell.COUNTS["syncs"]
        t = time.perf_counter()
        if profiled is None:
            rep = ctl.admit(name, n_tiles_request=k)
        else:
            rep, split = host_split(lambda: ctl.admit(name, n_tiles_request=k))
            profiled.update(app=name, **split)
        torch.cuda.synchronize()
        # a profiled admission's wall leaves out the profiler's own teardown
        wall = time.perf_counter() - t - (profiled or {}).get("profiler_s", 0.0)
        ev = ctl.events[-1]
        shapes = [list(key[1:]) for key, c in ctl.cache_stats.shapes.items()
                  for _ in range(c - shapes_before.get(key, 0))]
        k1 = ops.LAUNCHES["relax_round"] - before
        check(ev.kind == "admit", f"{name} was not admitted: {ev.kind}")
        check(k1 > 0, f"K1 did not launch while admitting {name}")
        check(math.isfinite(rep.throughput) and rep.throughput > 0,
              f"{name}: throughput {rep.throughput}")
        events.append({
            "kind": ev.kind, "app": name, "tiles": ev.tiles, "wall_s": wall,
            "throughput_per_us": rep.throughput, "cache_hit": ev.cache_hit,
            "analysed_B_n_E": shapes, "relax_round_launches": k1,
            "host_syncs": kbell.COUNTS["syncs"] - syncs_before,
        })
        return rep

    for name, k in REQUESTS.items():
        admit(name, k)
    freed = ctl.finish("CNN-MNIST")
    check(len(freed) == REQUESTS["CNN-MNIST"], "finish freed the wrong tiles")
    events.append({"kind": "finish", "app": "CNN-MNIST", "tiles": freed})
    # the re-admission runs under torch.profiler: its host wall split
    profiled_admission = {}
    rep_again = admit("CNN-MNIST", REQUESTS["CNN-MNIST"], profiled=profiled_admission)
    check(events[-1]["cache_hit"], "re-admission of CNN-MNIST missed the artifact cache")
    running = ctl.running()
    tiles = [t for ts in running.values() for t in ts]
    check(len(tiles) == len(set(tiles)), "tenants share tiles under isolated placement")
    read_into("admission")
    where.update(path=None, app=None)
    engine.mcr_batch = mcr_batch
    emit({"phase": "admission", "events": events, "wall_s": time.perf_counter() - t_phase,
          "optimize_budget": list(OPTIMIZE_BUDGET), "launches": dict(ops.LAUNCHES),
          "host_syncs": kbell.COUNTS["syncs"], "profiled_admission": profiled_admission,
          "cache": ctl.cache_stats.as_dict()})

    # shared inputs of the later phases: the apps' own graphs and orders
    def candidate_stack(name, hw, n_rows, seed, shortcuts=True):
        art = ctl.artifacts[(name, DYNAP_SE_1024)]
        g = sdfg_from_clusters(art.clustered, hw=hw)
        rng = np.random.default_rng(seed)
        b = rng.integers(0, hw.n_tiles, size=(n_rows, g.n_actors))
        ob = engine.project_order_batch(art.single_order, b)
        stack = engine.stack_hardware_aware(g, b, hw, ob, relax_shortcuts=shortcuts)
        lo0 = engine.order_cycle_lower_bounds(g.exec_time, b, ob)
        return g, b, ob, stack, lo0

    # -- 3. dense Eq.-4 path --------------------------------------------
    t_phase = time.perf_counter()
    g_cnn, b_cnn, ob_cnn, st_cnn, lo_cnn = candidate_stack("CNN-MNIST", DYNAP_SE_16, BATCH, 1)
    # Eq.-4 matrices need the plain stack: shortcut edges are not dependencies
    st_plain = engine.stack_hardware_aware(g_cnn, b_cnn, DYNAP_SE_16, ob_cnn)
    where.update(path="dense", app="CNN-MNIST")
    reset()
    rep_s = engine.batch_execute(g_cnn, b_cnn, DYNAP_SE_16, ob_cnn, with_starts=True, device=dev)
    p_dense = maxplus.mcr_batch(st_cnn, backend="dense", lo0=lo_cnn, device=dev)
    t_mat = maxplus.maxplus_matrix_batch(st_plain, device=dev)
    mcm = maxplus.mcm_power_iteration(t_mat[0].cpu().numpy(), iters=64, device=dev)
    torch.cuda.synchronize()
    dense_launches = dict(ops.LAUNCHES)
    read_into("dense")
    where.update(path=None, app=None)
    p_csr = maxplus.mcr_batch(st_cnn, lo0=lo_cnn, device=dev)
    # the dense search on 8 rows, card against host: K2/K3 are bit-exact
    st8 = maxplus.EdgeStack(st_cnn.n_actors, st_cnn.src[:8], st_cnn.dst[:8],
                            st_cnn.tokens[:8], st_cnn.weights[:8])
    dense8_card = maxplus.mcr_batch(st8, backend="dense", lo0=lo_cnn[:8], device=dev)
    dense8_host = maxplus.mcr_batch(st8, backend="dense", lo0=lo_cnn[:8], device="cpu")
    starts_cpu = engine.batch_execute(
        g_cnn, b_cnn[:4], DYNAP_SE_16, engine.project_order_batch(
            ctl.artifacts[("CNN-MNIST", DYNAP_SE_1024)].single_order, b_cnn[:4]),
        with_starts=True, device="cpu").starts
    mcm_cpu = maxplus.mcm_power_iteration(t_mat[0].cpu().numpy(), iters=64, device="cpu")
    dense_rel = float(np.max(np.abs(p_dense - p_csr) / np.abs(p_csr)))
    starts_err = float(np.max(np.abs(rep_s.starts[:4] - starts_cpu)))
    check(np.isfinite(rep_s.starts).all() and rep_s.starts.shape == (BATCH, g_cnn.n_actors),
          "with_starts gave non-finite or misshapen starts")
    check(np.allclose(rep_s.periods, p_csr, rtol=1e-8), "with_starts periods differ from csr")
    # the dense backend's contract against the exact search is the
    # reference's 5e-4 (tests/test_maxplus_backends.py): float32 squaring
    # only calls a cycle positive once it grows past a 1e-4 threshold
    check(dense_rel <= 5e-4, f"dense vs csr relative error {dense_rel}")
    check(np.array_equal(dense8_card, dense8_host), "dense search differs card vs host")
    check(np.allclose(rep_s.starts[:4], starts_cpu, rtol=1e-4, atol=1e-4),
          f"starts on the card vs host differ by {starts_err}")
    check(abs(mcm - mcm_cpu) <= 1e-5 * max(1.0, abs(mcm_cpu)), f"power iteration {mcm} vs {mcm_cpu}")
    emit({"phase": "dense", "stack_B_n_E": [st_cnn.n_graphs, st_cnn.n_actors, st_cnn.n_edges],
          "dense_vs_csr_max_rel": dense_rel,
          "dense_card_equals_host_8_rows": bool(np.array_equal(dense8_card, dense8_host)), "starts_card_vs_host_max_abs": starts_err,
          "power_iteration_card": mcm, "power_iteration_host": mcm_cpu,
          "launches": dense_launches, "wall_s": time.perf_counter() - t_phase})

    # -- 4. cross-checks --------------------------------------------------
    t_phase = time.perf_counter()
    art = ctl.artifacts[("CNN-MNIST", DYNAP_SE_1024)]
    reps, walls = {}, {}

    def replay(d):
        c = runtime.AdmissionController(DYNAP_SE_1024, optimize_budget=OPTIMIZE_BUDGET, device=d)
        c.register(art.clustered)
        t = time.perf_counter()
        reps[d.type] = c.admit("CNN-MNIST", n_tiles_request=REQUESTS["CNN-MNIST"])
        torch.cuda.synchronize()
        walls[d.type] = time.perf_counter() - t

    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        replay(dev)
    replay(torch.device("cpu"))
    # device busy share of one profiled admission (kernels and copies)
    dev_us = device_us(prof)
    busy_s = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    same_binding = bool(np.array_equal(reps["cuda"].binding, reps["cpu"].binding))
    thr_rel = abs(reps["cuda"].throughput - reps["cpu"].throughput) / reps["cpu"].throughput
    check(same_binding, "CNN-MNIST binding differs between device='cuda' and device='cpu'")
    check(thr_rel <= 1e-8, f"CNN-MNIST throughput card vs host rel {thr_rel}")
    st_hc, lo_hc = solved["stack"], solved["lo0"]
    t = time.perf_counter()
    p_card = maxplus.mcr_batch(st_hc, lo0=lo_hc, device=dev)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    p_host = maxplus.mcr_batch(st_hc, backend="edges", lo0=lo_hc, device="cpu")
    host_s = time.perf_counter() - t
    live = np.isfinite(p_host)     # bucket padding adds all--inf rows
    check(np.array_equal(p_card[~live], p_host[~live]) and live.any(),
          "padding rows or live-row count differ between csr and edges")
    hc_rel = float(np.max(np.abs(p_card[live] - p_host[live]) / np.abs(p_host[live])))
    check(hc_rel <= 1e-8, f"{solved['app']} csr vs edges rel {hc_rel}")
    emit({"phase": "crosscheck", "cnn_binding_identical": same_binding,
          "cnn_throughput_rel": thr_rel,
          "cnn_admit_wall_s": walls, "cnn_admit_profiled_device_busy_s": busy_s,
          "cnn_admit_device_busy_share": busy_s / walls["cuda"],
          "cnn_admit_top_device_us": top,
          "largest_admission_stack": {"app": solved["app"], "B_n_E": [
              st_hc.n_graphs, st_hc.n_actors, st_hc.n_edges], "live_rows": int(live.sum())},
          "csr_vs_edges_max_rel": hc_rel,
          "csr_card_s": card_s, "edges_host_s": host_s,
          "wall_s": time.perf_counter() - t_phase})

    # -- 5. joint placement, the serving queue and the fault runtime ------
    t_phase = time.perf_counter()
    jctl, jnames, jrequests = joint_controller(runtime, workloads, DYNAP_SE_1024,
                                               JOINT_TENANTS, dev)
    register_s = time.perf_counter() - t_phase
    # the largest fused stack the phase solves, for phase 6
    fused_seen = {"size": -1}
    fuse_stacks = engine.fuse_stacks

    def fuse_spy(stacks):
        out = fuse_stacks(stacks)
        size = out[0].n_graphs * out[0].n_edges
        if len(stacks) > 1 and size > fused_seen["size"]:
            fused_seen.update(size=size, members=list(stacks), fused=out[0], slices=out[1])
        return out

    # one flush of the drain runs under torch.profiler
    profiled_flush, flush_no = {}, [0]
    flush_rebalances = jctl.flush_rebalances

    def flush():
        flush_no[0] += 1
        if flush_no[0] != PROFILED_FLUSH:
            return flush_rebalances()
        n, split = host_split(flush_rebalances)
        profiled_flush.update(flush=flush_no[0], coalesced_events=n, **split)
        return n

    def metrics_agree(a, b, rtol):
        if a is None or b is None:
            return a is b
        def close(x, y):
            return x == y or (math.isfinite(x) and abs(x - y) <= rtol * abs(y))
        return (a["n_resident"] == b["n_resident"]
                and set(a["app_throughputs"]) == set(b["app_throughputs"])
                and all(close(a[k], b[k]) for k in ("chip_period", "chip_throughput",
                                                     "chip_energy"))
                and all(close(v, b["app_throughputs"][n])
                        for n, v in a["app_throughputs"].items()))

    def pcts(xs):
        return ([float(np.percentile(xs, 50)), float(np.percentile(xs, 99))]
                if xs else [0.0, 0.0])

    jctl.flush_rebalances = flush
    engine.fuse_stacks = fuse_spy
    where.update(path="joint_serving", app="tenants")
    reset()
    t = time.perf_counter()
    q, qstats = drain_churn(serving, jctl, jnames, jrequests, JOINT_EVENTS)
    torch.cuda.synchronize()
    # the drain's wall leaves out the profiler's own teardown
    drain_s = time.perf_counter() - t - profiled_flush.get("profiler_s", 0.0)
    drain_events = list(jctl.events)
    drain_launches = dict(ops.LAUNCHES)
    drain_syncs = kbell.COUNTS["syncs"]
    residents_drain = len(jctl.state.allocated)
    drain_agree = metrics_agree(jctl.chip_metrics(), jctl.chip_metrics(exact=True), 1e-6)
    storm = workloads.failure_storm(JOINT_FAULTS, DYNAP_SE_1024.n_tiles, drift_apps=jnames,
                                    **JOINT_STORM)
    t = time.perf_counter()
    driven = drive_storm(jctl, storm)
    torch.cuda.synchronize()
    storm_s = time.perf_counter() - t
    storm_events = jctl.events[len(drain_events):]
    storm_agree = metrics_agree(jctl.chip_metrics(), jctl.chip_metrics(exact=True), 1e-6)
    joint_launches = dict(ops.LAUNCHES)
    joint_syncs = kbell.COUNTS["syncs"]
    read_into("joint_serving")
    where.update(path=None, app=None)
    engine.fuse_stacks = fuse_stacks
    del jctl.flush_rebalances
    rebalance_walls = [e.wall_s for e in drain_events if e.kind == "rebalance"]
    remap_bad = sum(1 for e in storm_events if e.kind == "remap" and e.seed_throughput > 0
                    and e.chip_throughput < e.seed_throughput * (1 - 1e-6))
    check(q.pending == 0 and qstats["processed"] == JOINT_EVENTS
          and all(tk.status != "pending" for tk in q.tickets),
          f"the drain processed {qstats['processed']} of {JOINT_EVENTS} tickets")
    check(regressions(drain_events) == 0, "a rebalance of the drain regressed chip throughput")
    check(remap_bad == 0, f"{remap_bad} remaps fell below their repaired seed")
    check(drain_agree, "chip_metrics() differs from chip_metrics(exact=True) after the drain")
    check(storm_agree, "chip_metrics() differs from chip_metrics(exact=True) after the storm")
    check(drain_launches["relax_round"] > 0 and joint_launches["relax_round"] > 0,
          "K1 did not launch in joint_serving")
    check(PROFILED_FLUSH <= flush_no[0] and profiled_flush, "no flush was profiled")
    check(fused_seen["size"] > 0, "joint_serving solved no fused stack")
    emit({"phase": "joint_serving", "hw": "DYNAP_SE_1024 (32x32)",
          "tenants": JOINT_TENANTS, "scale": JOINT_SCALE, "joint_budget": list(JOINT_BUDGET),
          "churn_events": JOINT_EVENTS, "coalesce_window": JOINT_WINDOW, "zipf_s": ZIPF_S,
          "storm": {"n_faults": JOINT_FAULTS, **JOINT_STORM,
                    "events": len(storm), "driven": len(driven),
                    "kinds": dict(collections.Counter(k for k, _, _ in driven)),
                    "displaced": sum(d for _, _, d in driven),
                    "dead_tiles_at_end": int(jctl.chip.dead.sum())},
          "reduced": [],
          "register_s": register_s, "drain_s": drain_s, "storm_s": storm_s,
          "admissions_per_s": qstats["admitted"] / drain_s,
          "rebalances": len(rebalance_walls),
          "rebalance_scopes": dict(collections.Counter(
              e.scope for e in drain_events if e.kind == "rebalance")),
          "rebalance_wall_p50_p99_s": pcts(rebalance_walls),
          "recovery_wall_p50_p99_s": pcts([w for _, w, _ in driven]),
          "fail_recovery_wall_p50_p99_s": pcts([w for k, w, _ in driven if k == "fail"]),
          "residents_after_drain": residents_drain,
          "residents_after_storm": len(jctl.state.allocated),
          "remaps": sum(e.kind == "remap" for e in storm_events), "remap_regressions": 0,
          "cached_vs_exact_rtol_1e-6": True,
          "largest_fused_stack_B_n_E": [fused_seen["fused"].n_graphs,
                                        fused_seen["fused"].n_actors,
                                        fused_seen["fused"].n_edges],
          "largest_fused_stack_members": len(fused_seen["members"]),
          "drain": qstats,
          "drain_launches": drain_launches, "drain_host_syncs": drain_syncs,
          "launches": joint_launches, "host_syncs": joint_syncs,
          "profiled_flush": profiled_flush,
          "wall_s": time.perf_counter() - t_phase})

    # -- 6. joint path cross-checks: card against host --------------------
    t_phase = time.perf_counter()
    hw_smoke = dataclasses.replace(DYNAP_SE, n_tiles=SMOKE_TILES)
    smoke = {}
    for key, d, backend in (("card_csr", dev, "csr"), ("host_csr", torch.device("cpu"), "csr"),
                            ("host_edges", torch.device("cpu"), "edges")):
        t = time.perf_counter()
        c, names, requests = joint_controller(runtime, workloads, hw_smoke, SMOKE_TENANTS,
                                              d, backend)
        _, st = drain_churn(serving, c, names, requests, SMOKE_EVENTS)
        driven_smoke = drive_storm(c, workloads.failure_storm(
            SMOKE_FAULTS, SMOKE_TILES, drift_apps=names, **SMOKE_STORM))
        torch.cuda.synchronize()
        smoke[key] = {"ctl": c, "stats": st, "wall_s": time.perf_counter() - t,
                      "storm_driven": len(driven_smoke)}
        check(regressions(c.events) == 0, f"{key}: a rebalance regressed chip throughput")

    def strip(ctl_):
        return [{k: v for k, v in e.items() if k != "wall_s"} for e in ctl_.trajectory()]

    def placement(ctl_):
        return {n: (r.binding.tolist(), r.orders) for n, r in ctl_.reports.items()}

    card, host, edges = (smoke[k]["ctl"] for k in ("card_csr", "host_csr", "host_edges"))
    card_traj = strip(card)
    check(card_traj == strip(host), "the card's csr trajectory differs from the host's")
    check(placement(card) == placement(host), "the card's csr bindings differ from the host's")
    check(card.chip_metrics() == host.chip_metrics()
          and card.chip_metrics(exact=True) == host.chip_metrics(exact=True),
          "chip_metrics differ between the card's and the host's csr runs")
    # every ChipMetrics field of the final placement, card against host
    check(len(card.state.allocated) > 0, "no tenant is resident after the smoke storm")
    _, _, union, order, binding, _ = card._resident_union()
    ob = engine.project_order_batch(order, binding[None, :])
    rate_scale = card._union_rate_scale(
        [card.artifacts[(n, hw_smoke)] for n in sorted(card.state.allocated)])
    (lc, pc, mc), (lh, ph, mh) = (engine.union_component_periods(
        union, binding, hw_smoke, ob, with_metrics=True, chip_state=card.chip,
        rate_scale=rate_scale, backend="csr", device=d) for d in (dev, torch.device("cpu")))
    check(np.array_equal(lc, lh) and np.array_equal(pc, ph)
          and all(np.array_equal(getattr(mc, f.name), getattr(mh, f.name))
                  for f in dataclasses.fields(mc)),
          "the final placement's component periods or ChipMetrics differ card vs host")
    # the edges run: "csr" keeps another candidate where scores tie within
    # its tolerance, and the runs part there; so the card's final placement
    # is scored again by the exact host oracle
    edges_traj = strip(edges)
    same_prefix = next((i for i, (a, b) in enumerate(zip(card_traj, edges_traj))
                        if (a["kind"], a["app"], a["tiles"]) != (b["kind"], b["app"], b["tiles"])),
                       min(len(card_traj), len(edges_traj)))
    first_split = None
    if same_prefix < min(len(card_traj), len(edges_traj)):
        a, b = card_traj[same_prefix], edges_traj[same_prefix]
        first_split = {"event": same_prefix, "kind": a["kind"], "app": a["app"],
                       "csr_tiles": a["tiles"], "edges_tiles": b["tiles"]}
    m_card = card.chip_metrics(exact=True)
    card.backend, card.device = "edges", torch.device("cpu")
    m_oracle = card.chip_metrics(exact=True)
    card.backend, card.device = "csr", dev
    check(metrics_agree(m_card, m_oracle, 1e-8),
          "the card's final placement scores differently under edges (rtol 1e-8)")
    same_bindings = sum(1 for n, r in card.reports.items() if n in edges.reports
                        and np.array_equal(r.binding, edges.reports[n].binding))
    # the largest fused stack of joint_serving: each member's rows, card
    t = time.perf_counter()
    fused, members, slices = fused_seen["fused"], fused_seen["members"], fused_seen["slices"]
    p_fused = maxplus.mcr_batch(fused, device=dev)
    fused_s = time.perf_counter() - t
    fused_rel = 0.0
    for m, sl in zip(members, slices):
        own = maxplus.mcr_batch(m, device=dev)
        check(np.array_equal(p_fused[sl], own),
              "a fused member's rows differ from its own card solve")
        ref_p = maxplus.mcr_batch(m, backend="edges", device="cpu")
        fin = np.isfinite(ref_p)
        check(np.array_equal(fin, np.isfinite(own)) and np.array_equal(own[~fin], ref_p[~fin]),
              "a fused member's non-finite rows differ from edges")
        if fin.any():
            fused_rel = max(fused_rel, float(np.max(np.abs(own[fin] - ref_p[fin])
                                                     / np.abs(ref_p[fin]))))
    check(fused_rel <= 1e-8, f"fused members against edges: rel {fused_rel}")
    emit({"phase": "joint_crosscheck", "hw": f"DYNAP_SE with {SMOKE_TILES} tiles",
          "tenants": SMOKE_TENANTS, "churn_events": SMOKE_EVENTS,
          "storm": {"n_faults": SMOKE_FAULTS, **SMOKE_STORM},
          "runs": {k: {"wall_s": v["wall_s"], "events": len(v["ctl"].events),
                       "storm_driven": v["storm_driven"],
                       "admitted": v["stats"]["admitted"],
                       "residents": len(v["ctl"].state.allocated)} for k, v in smoke.items()},
          "card_equals_host_csr": {"trajectory": True, "bindings": True, "chip_metrics": True,
                                   "component_periods_and_chip_metrics_fields": True},
          "edges": {"events_equal_before_first_split": same_prefix,
                    "events": [len(card_traj), len(edges_traj)], "first_split": first_split,
                    "bindings_equal": same_bindings, "residents": len(card.reports),
                    "card_final_placement_vs_edges_oracle_rtol_1e-8": True},
          "fused": {"B_n_E": [fused.n_graphs, fused.n_actors, fused.n_edges],
                    "members": len(members), "rows_equal_own_card_solve": True,
                    "members_vs_edges_max_rel": fused_rel, "card_s": fused_s},
          "wall_s": time.perf_counter() - t_phase})
    del jctl, smoke, card, host, edges, fused, members

    # -- 7. LM serving path (main path of the LM substrate) --------------
    t_phase = time.perf_counter()
    args = tserve.parse_args([])        # the reference's defaults
    where.update(path="lm_serve", app=args.arch)
    torch.cuda.reset_peak_memory_stats()
    reset()
    cfg, params, prompts = tserve.setup(args, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    res = tserve.serve(cfg, params, prompts, args.gen_tokens, args.max_len, dev,
                       keep_prompt_logits=True)
    t = time.perf_counter()
    prefill_logits = tsteps.make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(prompts, device=dev)})
    torch.cuda.synchronize()
    prefill_step_s = time.perf_counter() - t
    # device time of a few decode steps, profiled after the run: against the
    # unprofiled step wall it says how long the card waits on the host
    step = tsteps.make_serve_step(cfg)
    cache = ttf.init_cache(cfg, args.requests, args.max_len, dtype=torch.float32, device=dev)
    tok = torch.as_tensor(prompts[:, :1], device=dev)
    step(params, cache, tok, 0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for i in range(1, 1 + PROFILED_DECODE_STEPS):
            step(params, cache, tok, i)
        torch.cuda.synchronize()
    decode_us = device_us(prof)
    decode_busy_ms = sum(decode_us.values()) / 1e3 / PROFILED_DECODE_STEPS
    del cache, prof
    serve_launches = dict(ops.LAUNCHES)
    read_into("lm_serve")
    where.update(path=None, app=None)
    check(res.tokens.shape == (args.requests, args.gen_tokens)
          and ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all(), "bad generated tokens")
    check(prefill_logits.shape == (args.requests, args.prompt_len, cfg.vocab)
          and bool(torch.isfinite(prefill_logits).all()), "prefill logits not finite")
    check(serve_launches["flash_attention"] == cfg.n_layers,
          f"the prefill step launched flash attention {serve_launches['flash_attention']} "
          f"times, not once per layer ({cfg.n_layers})")
    fwd, dec = prefill_logits.float(), res.prompt_logits.float()
    serve_err = float((fwd - dec).abs().max())
    check(bool(torch.allclose(fwd, dec, rtol=SERVE_RTOL, atol=SERVE_ATOL)),
          f"prefill vs teacher-forced decode logits differ by {serve_err}")
    first = prefill_logits[:, -1].argmax(dim=-1).cpu().numpy()
    check(np.array_equal(first, res.tokens[:, 0]),
          f"first generated tokens {res.tokens[:, 0]} are not the prefill argmax {first}")
    emit({"phase": "lm_serve", "arch": cfg.name, "params_dtype": "float32",
          "activation_dtype": str(cfg.activation_dtype), "requests": args.requests,
          "prompt_len": args.prompt_len, "gen_tokens": args.gen_tokens, "max_len": args.max_len,
          "setup_s": setup_s, "prefill_teacher_forced_s": res.prefill_s,
          "decode_s": res.decode_s, "decode_tokens_per_s": res.tokens_per_s,
          "prefill_step_s": prefill_step_s,
          "prefill_step_tokens_per_s": prompts.size / prefill_step_s,
          "prefill_vs_decode_logits_max_abs": serve_err,
          "decode_step_ms": 1e3 * res.decode_s / args.gen_tokens,
          "decode_step_device_busy_ms": decode_busy_ms,
          "decode_device_busy_share": decode_busy_ms / (1e3 * res.decode_s / args.gen_tokens),
          "decode_top_device_us": sorted(decode_us.items(), key=lambda kv: -kv[1])[:6],
          "first_token_equals_prefill_argmax": True, "sample": res.tokens[0][:16].tolist(),
          "launches": serve_launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "wall_s": time.perf_counter() - t_phase})
    del params, res, prefill_logits, fwd, dec
    torch.cuda.empty_cache()

    # -- 8. bf16 prefill at full length ------------------------------------
    t_phase = time.perf_counter()
    where["path"] = "lm_prefill"
    reset()
    prefill_runs = []
    # qwen2-1.5b at prefill_32k's length with its batch cut from 32 to 1
    for arch, seq in (("qwen2-1.5b", SHAPES["prefill_32k"]["seq_len"]),
                      ("starcoder2-3b", STARCODER2_TOKENS)):
        cfg = get_arch(arch)
        where["app"] = cfg.name
        params = ttf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                 dtype=cfg.activation_dtype)
        tokens = torch.as_tensor(
            np.random.default_rng(1).integers(0, cfg.vocab, (1, seq)), device=dev)
        before = ops.LAUNCHES["flash_attention"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        logits = tsteps.make_prefill_step(cfg)(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_flash = ops.LAUNCHES["flash_attention"] - before
        check(n_flash == cfg.n_layers, f"{arch}: {n_flash} flash launches for {cfg.n_layers} layers")
        check(logits.shape == (1, seq, cfg.vocab) and logits.dtype == cfg.activation_dtype,
              f"{arch}: logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()), f"{arch}: prefill logits not finite")
        prefill_runs.append({
            "arch": cfg.name, "tokens": [1, seq], "params_dtype": str(cfg.activation_dtype),
            "window": cfg.window, "layers": cfg.n_layers, "wall_s": wall,
            "tokens_per_s": seq / wall, "flash_launches": n_flash,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        })
        del params, tokens, logits
        torch.cuda.empty_cache()
    read_into("lm_prefill")
    where.update(path=None, app=None)
    emit({"phase": "lm_prefill", "runs": prefill_runs,
          "reduced": "batch 1 of prefill_32k's 32 (qwen2-1.5b); starcoder2-3b at 8192 tokens",
          "launches": dict(ops.LAUNCHES), "wall_s": time.perf_counter() - t_phase})

    # -- 9. SNN execution path: spike recording and the crossbar steps ---
    t_phase = time.perf_counter()
    where.update(path="snn_crossbar", app=SNN_APP)
    reset()
    snn = snns[SNN_APP]
    sim_card_s = []
    runs_card = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        runs_card.append(lif.simulate_spikes(snn, n_steps=SNN_STEPS, device=dev))
        sim_card_s.append(time.perf_counter() - t)
    counts_card = runs_card[0]
    draws = lif.input_draws(snn.n_neurons, SNN_STEPS, 0, dev).cpu()
    t = time.perf_counter()
    counts_host = lif._simulate(*lif.snn_tensors(snn, "cpu"), draws,
                                params=lif.LIFParams()).numpy().astype(np.float64)
    sim_host_s = time.perf_counter() - t
    is_in = snn.layer_of == 0
    check(np.array_equal(runs_card[1], counts_card),
          "simulate_spikes: two card runs give different counts")
    differ = int((counts_card != counts_host).sum())
    check(differ == 0, f"simulate_spikes: {differ} neurons' counts differ between card and host")
    check(counts_host[~is_in].sum() > 0, "simulate_spikes: no non-input neuron spiked")

    # the example's path over every cluster: one block each, spikes fed back
    cl = ctl.artifacts[(SNN_APP, DYNAP_SE_1024)].clustered
    t = time.perf_counter()
    blocks_np, n_inputs, n_members = crossbar_blocks(cl)
    build_s = time.perf_counter() - t
    blocks = torch.as_tensor(blocks_np, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    s0 = (torch.rand((cl.n_clusters, CROSSBAR_SAMPLES, blocks.shape[1]), generator=gen,
                     device=dev) < CROSSBAR_RATE).float()
    v0 = torch.zeros((cl.n_clusters, CROSSBAR_SAMPLES, blocks.shape[2]), device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s_k, v_k = s0, v0
    for _ in range(CROSSBAR_STEPS):       # one stacked launch a step over every block
        s_k, v_k = ops.lif_crossbar_step(s_k, blocks, v_k)
    torch.cuda.synchronize()
    crossbar_s = time.perf_counter() - t
    # examples/snn_on_tpu.py's own loop, block by block: G = 1 calls
    t = time.perf_counter()
    example = []
    for c in range(CROSSBAR_EXAMPLE_CLUSTERS):
        s_c, v_c = s0[c], v0[c]
        for _ in range(CROSSBAR_STEPS):
            s_c, v_c = ops.lif_crossbar_step(s_c, blocks[c], v_c)
        example.append((s_c, v_c))
    torch.cuda.synchronize()
    example_s = time.perf_counter() - t
    snn_launches = dict(ops.LAUNCHES)
    read_into("snn_crossbar")
    where.update(path=None, app=None)
    k5 = snn_launches["lif_crossbar_step"]
    check(k5 == CROSSBAR_STEPS * (1 + CROSSBAR_EXAMPLE_CLUSTERS),
          f"K5 launched {k5} times, not {CROSSBAR_STEPS} stacked steps and "
          f"{CROSSBAR_EXAMPLE_CLUSTERS} clusters x {CROSSBAR_STEPS} steps of the example's loop")
    check(all(torch.equal(s_c, s_k[c]) and torch.equal(v_c, v_k[c])
              for c, (s_c, v_c) in enumerate(example)),
          "the example's G = 1 trajectories differ from the stacked step's rows")
    # the whole trajectory, all blocks at once through the plain version
    s_p, v_p = s0, v0
    for _ in range(CROSSBAR_STEPS):
        s_p, v_p = ref.lif_crossbar_step_ref(s_p, blocks, v_p)
    check(torch.equal(s_k, s_p) and torch.equal(v_k, v_p),
          "the crossbar trajectory differs from its plain version")
    emit({"phase": "snn_crossbar", "app": SNN_APP, "neurons": snn.n_neurons,
          "synapses": snn.n_synapses,
          "simulate": {"steps": SNN_STEPS, "card_s": sim_card_s, "host_s": sim_host_s,
                       "counts_identical_card_card_host": True,
                       "non_input_spikes": float(counts_host[~is_in].sum()),
                       "input_spikes": float(counts_host[is_in].sum())},
          "crossbar": {"n_clusters": cl.n_clusters, "samples": CROSSBAR_SAMPLES,
                       "input_rate": CROSSBAR_RATE, "steps": CROSSBAR_STEPS,
                       "build_s": build_s, "wall_s": crossbar_s,
                       "example_clusters": CROSSBAR_EXAMPLE_CLUSTERS,
                       "example_wall_s": example_s,
                       "weight_bytes": int(blocks.numel() * blocks.element_size()),
                       "max_inputs": int(n_inputs.max()), "max_members": int(n_members.max()),
                       "spikes_out": int(s_k.sum()), "plain_trajectory_identical": True,
                       "example_equals_stack_rows": True},
          "launches": snn_launches, "wall_s": time.perf_counter() - t_phase})
    del blocks, s0, v0, example, s_k, v_k, s_p, v_p

    # -- 10. jamba's hybrid serving path -----------------------------------
    # one of jamba's four 8-layer blocks: 1 GQA and 7 Mamba mixers, 4 MoE
    # and 4 SwiGLU FFNs, every layer at full width
    t_phase = time.perf_counter()
    args = tserve.parse_args(["--arch", JAMBA])
    full_cfg = get_arch(JAMBA)
    cfg = dataclasses.replace(full_cfg, stacks=((1, full_cfg.stacks[0][1]),))
    reduced_note = (f"depth: 1 of {JAMBA}'s {full_cfg.stacks[0][0]} blocks "
                    f"({cfg.n_layers} of {full_cfg.n_layers} layers), widths in full")
    n_mamba = sum(spec.mixer == "mamba" for _, specs in cfg.stacks for spec in specs)
    n_gqa = cfg.n_layers - n_mamba
    where.update(path="jamba_serve", app=cfg.name)
    torch.cuda.reset_peak_memory_stats()
    reset()
    cfg, params, prompts = tserve.setup(args, dev, cfg=cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    res = tserve.serve(cfg, params, prompts, args.gen_tokens, args.max_len, dev)
    tokens = torch.as_tensor(prompts, device=dev)
    before = dict(ops.LAUNCHES)
    t = time.perf_counter()
    prefill_logits = tsteps.make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_step_s = time.perf_counter() - t
    k7 = ops.LAUNCHES["mamba_chunk_scan"] - before["mamba_chunk_scan"]
    k6 = ops.LAUNCHES["flash_attention"] - before["flash_attention"]
    step = tsteps.make_serve_step(cfg)
    cache = ttf.init_cache(cfg, args.requests, args.max_len, dtype=torch.float32, device=dev)
    tok = tokens[:, :1]
    step(params, cache, tok, 0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for i in range(1, 1 + PROFILED_DECODE_STEPS):
            step(params, cache, tok, i)
        torch.cuda.synchronize()
    decode_us = device_us(prof)
    decode_busy_ms = sum(decode_us.values()) / 1e3 / PROFILED_DECODE_STEPS
    del cache, prof
    jamba_launches = dict(ops.LAUNCHES)
    serve_combine = ops.COMBINE_LAUNCHES["mamba_scan"]
    read_into("jamba_serve")
    where.update(path=None, app=None)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(res.tokens.shape == (args.requests, args.gen_tokens)
          and ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all(), "jamba: bad generated tokens")
    check(prefill_logits.shape == (args.requests, args.prompt_len, cfg.vocab)
          and bool(torch.isfinite(prefill_logits).all()), "jamba: prefill logits not finite")
    k7_first = {k: ops.LAUNCHES[k] - before[k] for k in ("mamba_chunk_states",
                                                          "mamba_chunk_combine")}
    check(k7 == n_mamba and k6 == n_gqa and not any(k7_first.values()),
          f"jamba's one-chunk prefill step launched K7 {k7}, K6 {k6} times and {k7_first}, "
          f"not {n_mamba}, {n_gqa} and none")
    # K7 in context: the first Mamba layer's prefill against its decode
    check(cfg.stacks[0][1][0].mixer == "mamba", "jamba's layer 0 is not a Mamba layer")

    def first(tree):    # repeat 0 of a stacked layer's parameters
        return {k: first(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[0]

    lp = first(params["stack0"]["l0"])
    with torch.no_grad():
        # the layer's input in float32: the decode casts its scan output to
        # the input's type, which in bf16 would round what the prefill keeps
        h_in = rms_norm(lp["norm1"], params["embed"][tokens].to(cfg.activation_dtype)).float()
        out_prefill = tmamba.mamba_forward(lp["mixer"], h_in, cfg)
        state = tmamba.mamba_init_state(cfg, args.requests, device=dev)
        out_decode = torch.cat([tmamba.mamba_decode(lp["mixer"], h_in[:, i:i + 1], state, cfg)[0]
                                for i in range(args.prompt_len)], dim=1)
    context_err = float((out_prefill.float() - out_decode.float()).abs().max())
    context_rms = float(out_decode.float().square().mean().sqrt())
    context_ratio = context_err / (MAMBA_CONTEXT_TOL * context_rms)
    check(context_ratio <= 1.0,
          f"the first Mamba layer's prefill differs from its decode by {context_err} "
          f"(rms {context_rms}, limit {MAMBA_CONTEXT_TOL} of it)")
    emit({"phase": "jamba_serve", "arch": cfg.name, "reduced": reduced_note,
          "layers": cfg.n_layers, "mamba_layers": n_mamba, "gqa_layers": n_gqa,
          "params": sum(t.numel() for t in _leaves(params)), "params_dtype": "float32",
          "activation_dtype": str(cfg.activation_dtype), "requests": args.requests,
          "prompt_len": args.prompt_len, "gen_tokens": args.gen_tokens, "max_len": args.max_len,
          "setup_s": setup_s, "prefill_teacher_forced_s": res.prefill_s,
          "decode_s": res.decode_s, "decode_tokens_per_s": res.tokens_per_s,
          "decode_step_ms": 1e3 * res.decode_s / args.gen_tokens,
          "decode_step_device_busy_ms": decode_busy_ms,
          "decode_device_busy_share": decode_busy_ms / (1e3 * res.decode_s / args.gen_tokens),
          "decode_top_device_us": sorted(decode_us.items(), key=lambda kv: -kv[1])[:6],
          "prefill_step_s": prefill_step_s, "prefill_step_k7_launches": k7,
          "prefill_step_k6_launches": k6,
          "mamba_context": {"max_abs_err": context_err, "decode_rms": context_rms,
                            "tol": MAMBA_CONTEXT_TOL, "tol_ratio": context_ratio},
          "sample": res.tokens[0][:16].tolist(), "launches": jamba_launches,
          "combine_launches": serve_combine, "peak_gib": peak_gib,
          "wall_s": time.perf_counter() - t_phase})
    del params, res, prefill_logits, lp, h_in, out_prefill, out_decode, state
    torch.cuda.empty_cache()

    # -- 11. jamba's bf16 prefill at full length -----------------------------
    t_phase = time.perf_counter()
    where.update(path="jamba_prefill", app=cfg.name)
    seq = SHAPES["prefill_32k"]["seq_len"]
    scan_parts = ("mamba_chunk_states", "mamba_chunk_combine", "mamba_chunk_scan")
    reset()
    params = ttf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=cfg.activation_dtype)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (1, seq)), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    logits = tsteps.make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(logits.shape == (1, seq, cfg.vocab) and logits.dtype == cfg.activation_dtype,
          f"jamba: logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "jamba: bf16 prefill logits not finite")
    prefill_launches = dict(ops.LAUNCHES)
    combine = ops.COMBINE_LAUNCHES["mamba_scan"]
    read_into("jamba_prefill")
    where.update(path=None, app=None)
    # the Mamba layers' scan split into its three launches: device time by
    # kernel name in a second, profiled run (the first one's wall stays
    # unprofiled; this run's launches are not counted)
    del logits
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        tsteps.make_prefill_step(cfg)(params, {"tokens": tokens})
        torch.cuda.synchronize()
    scan_ms = {"states_pass": 0.0, "combine": 0.0, "full_pass": 0.0}
    for key, us in device_us(prof).items():
        if "mamba_chunk_combine_kernel" in key:
            scan_ms["combine"] += us / 1e3
        elif "mamba_chunk_scan_kernel" in key:   # template <N, T, WRITE_Y>
            scan_ms["full_pass" if ", true>" in key else "states_pass"] += us / 1e3
    del prof
    check(prefill_launches["flash_attention"] == n_gqa
          and all(prefill_launches[k] == n_mamba for k in scan_parts) and combine == n_mamba,
          f"jamba's bf16 prefill launched K6 {prefill_launches['flash_attention']} times, "
          f"{ {k: prefill_launches[k] for k in scan_parts} } and {combine} combines, "
          f"not {n_gqa} and {n_mamba} each")
    emit({"phase": "jamba_prefill", "arch": cfg.name, "tokens": [1, seq],
          "reduced": reduced_note + "; batch 1 of prefill_32k's 32",
          "params_dtype": str(cfg.activation_dtype), "wall_s_prefill": wall,
          "tokens_per_s": seq / wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "combine_launches": combine, "launches": prefill_launches,
          "mamba_scan_device_ms": {**scan_ms, "layers": n_mamba,
                                   "source": "torch.profiler, a second run"},
          "wall_s": time.perf_counter() - t_phase})
    del params, tokens
    torch.cuda.empty_cache()

    # -- 12. kernels against their plain versions --------------------------
    def timed(fn, trials=11, reps=10, warm=3):
        """Device ms per call: median over trials of CUDA-event time of
        ``reps`` back-to-back calls.  A sleep kernel first keeps the card
        busy while the host enqueues them, so the events time the device
        work and not the Python launch overhead.  A call over 10 ms is
        timed alone, 3 times."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if a.elapsed_time(b) > 10.0:
            trials, reps, warm = 3, 1, 0
        for _ in range(warm):
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

    def max_abs_err(x, y):
        check(torch.equal(torch.isfinite(x), torch.isfinite(y)), "finite masks differ")
        fin = torch.isfinite(x)
        check(torch.equal(x[~fin], y[~fin]), "non-finite entries differ")
        return float((x[fin].double() - y[fin].double()).abs().max()) if fin.any() else 0.0

    def bound(nbytes, n_terms, terms_per_s):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_terms / terms_per_s
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    kernels = []

    def record(name, source, replaces, fn, plain, err, nbytes, n_terms, terms_per_s,
               library=None, tol_ratio=None, **extra):
        """One kernels-line entry: the kernel must be bit-identical to its
        plain version, or with ``tol_ratio`` (attention) at most 1."""
        torch.cuda.synchronize()
        b_ms, b_by = bound(nbytes, n_terms, terms_per_s)
        big = largest[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": dict(zip(shape_of[name][0], big["shape"])),
            "inputs_from": {"path": big["path"], "app": big["app"]},
            "path_shapes": {path: {"x".join(map(str, sh)): c for sh, c in cnt.items()}
                            for path, cnt in seen[name].items()},
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            # one figure under the two names its readers look for
            "max_abs_err": err, "max_abs_diff": err, "tolerance": "bit-identical",
            "ms": timed(fn), "plain_ms": timed(plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed(library) if library is not None else None, **extra,
        })
        if tol_ratio is None:
            check(err == 0.0, f"{name} differs from its plain version by {err}")
        else:
            kernels[-1]["tol_ratio"] = tol_ratio
            check(tol_ratio <= 1.0, f"{name} is {tol_ratio} times its tolerance")

    for name in shape_of:
        check(name in largest, f"{name} was never called on the card by phases 2-11")

    def by_path(name, work_of, terms_per_s):
        """Time, bound and launches of ``name`` at each path's largest call."""
        out = {}
        for path, call in path_largest[name].items():
            args, kw = call["args"], call["kwargs"]
            nbytes, n_terms = work_of(*args)
            b_ms, b_by = bound(nbytes, n_terms, terms_per_s)
            out[path] = {
                "shape": dict(zip(shape_of[name][0], call["shape"])), "app": call["app"],
                "launches": launches[name].get(path, 0),
                "ms": timed(lambda: getattr(ops, name)(*args, **kw)),
                "bound_ms": b_ms, "bound_by": b_by,
            }
        return out

    def by_shape(name, work_of, terms_per_s, compare, extra=None, plain=None):
        """Check and time ``name`` at the first call of every distinct shape
        of each path (on a path of ``BY_SHAPE_TOP``, of its most launched
        shapes): (one row per shape, sum over the shapes of launches x (ms -
        bound ms), the launches of the shapes left out, by path, with the
        same sum estimated at the median of its timed rows' ms - bound ms).
        ``compare(args, kw)`` gives the kernel's max abs error against its
        plain version, which must be 0; ``plain(args, kw)``, where given, is
        timed too."""
        rows, total = [], 0.0
        fn = getattr(ops, name)
        top = {path: {sh for sh, _ in seen[name][path].most_common(n)}
               for path, n in BY_SHAPE_TOP.items() if path in seen[name]}
        for (path, shape), call in first_of_shape[name].items():
            if path in top and shape not in top[path]:
                continue
            args, kw = call["args"], call["kwargs"]
            err = compare(args, kw)
            check(err == 0.0, f"{name} differs from its plain version by {err} at {shape}")
            b_ms, b_by = bound(*work_of(*args), terms_per_s)
            launches = seen[name][path][shape]
            ms = timed(lambda: fn(*args, **kw))
            rows.append({
                "path": path, "app": call["app"], "shape": dict(zip(shape_of[name][0], shape)),
                "launches": launches, "max_abs_err": err, "ms": ms, "bound_ms": b_ms,
                "bound_by": b_by, **(extra(*args) if extra else {}),
                **({"plain_ms": timed(lambda: plain(args, kw))} if plain else {}),
            })
            total += launches * (ms - b_ms)
        left_out = {}
        for path, shapes in top.items():
            excess = [r["ms"] - r["bound_ms"] for r in rows if r["path"] == path]
            n = sum(c for sh, c in seen[name][path].items() if sh not in shapes)
            left_out[path] = {"shapes": len(seen[name][path]) - len(shapes), "launches": n,
                              "est_ms": n * statistics.median(excess)}
        return rows, total, left_out

    def k1_compare(name, plain_fn):
        def compare(args, kw):
            out, plain = getattr(ops, name)(*args), plain_fn(*args)
            if name == "relax_round":
                return max_abs_err(out, plain)
            check(torch.equal(out[1], plain[1]), f"{name} psrc differs from its plain version")
            return max_abs_err(out[0], plain[0])
        return compare

    def in_degree(dist, lams, csr):
        deg = torch.diff(csr.indptr.long())
        return {"in_degree_mean": float(deg.double().mean()), "in_degree_max": int(deg.max())}

    def k1_work(witness):
        def work_of(dist, lams, csr):
            nk, k = dist.shape
            e = int(csr.src.numel())
            # row pointers, per edge src/w/t, each node's dist row, lams; best
            # (and psrc) out
            nbytes = (nk + 1) * 4 + e * (4 + 8 + 8) + nk * k * 8 + lams.numel() * 8 \
                + nk * k * 8 * (2 if witness else 1)
            return nbytes, e * k
        return work_of

    # K1 on the inputs of its largest admission call (HeartClass's stack)
    for name, plain_fn in (("relax_round", ref.segment_relax_ref),
                           ("relax_round_witness", ref.segment_relax_witness_ref)):
        dist, lams, csr = largest[name]["args"]
        kern_fn = getattr(ops, name)
        k = dist.shape[1]
        e = int(csr.src.numel())
        nbytes = k1_work(name == "relax_round_witness")(dist, lams, csr)[0]
        library = None
        if name == "relax_round":
            cand = dist[csr.src.long()] + (csr.w[:, None] - lams[csr.dst_row] * csr.t[:, None])
            idx = csr.dst[:, None].expand_as(cand)
            out = torch.full_like(dist, float("-inf"))
            err = max_abs_err(kern_fn(dist, lams, csr), plain_fn(dist, lams, csr))
            library = lambda: out.scatter_reduce(0, idx, cand, "amax", include_self=True)  # noqa: E731
        else:
            bw, pw = kern_fn(dist, lams, csr)
            br, pr = plain_fn(dist, lams, csr)
            check(torch.equal(pw, pr), "relax_round_witness psrc differs from its plain version")
            err = max_abs_err(bw, br)
        record(name, "src/repro_torch/csrc/relax_round.cu",
               "src/repro/kernels/maxplus_bellman.py:116",
               lambda: kern_fn(dist, lams, csr), lambda: plain_fn(dist, lams, csr),
               err, nbytes, e * k, RELAX_TERMS_PER_S, library=library)
        kernels[-1]["by_path"] = by_path(name, k1_work(name == "relax_round_witness"),
                                         RELAX_TERMS_PER_S)
        rows, timed_ms, left_out = by_shape(
            name, k1_work(name == "relax_round_witness"), RELAX_TERMS_PER_S,
            k1_compare(name, plain_fn), extra=in_degree)
        kernels[-1].update(by_shape=rows, rule2_timed_ms=timed_ms, by_shape_left_out=left_out,
                           rule2_ms=timed_ms + sum(v["est_ms"] for v in left_out.values()))

    # K2, K3 and the G = 1 matmul on the inputs of their largest dense-path call
    for name, replaces, plain_fn in (
        ("maxplus_bmm", "src/repro/kernels/maxplus_matmul.py:217", ref.maxplus_bmm_ref),
        ("maxplus_bmv", "src/repro/kernels/maxplus_matmul.py:173", ref.maxplus_bmv_ref),
        ("maxplus_matmul", "src/repro/kernels/maxplus_matmul.py:83", ref.maxplus_matmul_ref),
    ):
        a, b = largest[name]["args"]
        kern_fn = getattr(ops, name)
        out_numel = kern_fn(a, b).numel()
        record(name, "src/repro_torch/csrc/maxplus_matmul.cu", replaces,
               lambda: kern_fn(a, b), lambda: plain_fn(a, b),
               max_abs_err(kern_fn(a, b), plain_fn(a, b)),
               (a.numel() + b.numel() + out_numel) * 4, largest[name]["work"],
               MAXPLUS_TERMS_PER_S)

    # K6 on the inputs of its largest call (jamba's 32k GQA layer), and
    # checked at its largest float32, windowed and lm_prefill calls
    def attn_pairs(sq, skv, causal, window):
        """(query, key) pairs the masks keep, per (batch, head)."""
        i = np.arange(sq, dtype=np.int64)
        hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
        lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq, dtype=np.int64)
        return int(np.maximum(hi - lo + 1, 0).sum())

    def flash_work(q, k, causal, window):
        """(bytes of q, k, v and o; flops; peak flop rate of q's type)."""
        b_, hq, sq, d = q.shape
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
        flops = 4 * d * hq * b_ * attn_pairs(sq, k.shape[2], causal, window)
        return nbytes, flops, BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S

    def sdpa_for(q, k, v, kw):
        """The library yardstick, timed here only: one
        ``F.scaled_dot_product_attention`` call for the same masks, as (call,
        its description, None), or (None, None, why) where no backend takes
        it.  A causal unwindowed call goes to the flash backend (the math
        backend would materialise the (Sq, Skv) scores), else to the
        memory-efficient one; a window goes to the memory-efficient backend
        with a boolean (Sq, Skv) mask.  k and v are expanded to Hq heads
        before the timed call where a backend refuses ``enable_gqa``."""
        mask = None
        plans = [(SDPBackend.EFFICIENT_ATTENTION, "memory-efficient")]
        if kw["causal"] and not kw["window"]:
            plans.insert(0, (SDPBackend.FLASH_ATTENTION, "flash"))
        else:
            i = torch.arange(q.shape[2], device=q.device)[:, None]
            j = torch.arange(k.shape[2], device=q.device)[None, :]
            mask = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool, device=q.device)
            if kw["causal"]:
                mask &= i >= j
            if kw["window"] > 0:
                mask &= (i - j) < kw["window"]
        group = q.shape[1] // k.shape[1]
        refused = []
        for backend, backend_name in plans:
            for gqa in (True, False):
                kk, vv = (k, v) if gqa else (k.repeat_interleave(group, 1),
                                             v.repeat_interleave(group, 1))

                def sdpa(kk=kk, vv=vv, gqa=gqa, backend=backend):
                    with sdpa_kernel([backend]):
                        return F.scaled_dot_product_attention(
                            q, kk, vv, attn_mask=mask, is_causal=mask is None, enable_gqa=gqa)
                try:
                    sdpa()
                    torch.cuda.synchronize()
                except RuntimeError as e:     # this backend takes no such call
                    refused.append(f"{backend_name}, enable_gqa={gqa}: "
                                   + str(e).splitlines()[0][:200])
                    continue
                return sdpa, (
                    "F.scaled_dot_product_attention("
                    + ("is_causal=True" if mask is None else "attn_mask=bool (Sq, Skv)")
                    + (", enable_gqa=True" if gqa else "; k, v expanded to Hq heads")
                    + f"), {backend_name} backend"), None
        return None, None, "; ".join(refused)

    def flash_case(key, call):
        """(the comparison's row, the call's inputs, yardstick and work).
        ``library_tol_ratio`` reads the yardstick against the plain version
        by the same measure: a printed reading, not a check."""
        q, k, v = call["args"]
        kw = {"causal": call["kwargs"].get("causal", True), "window": call["kwargs"].get("window", 0)}
        out, plain = ops.flash_attention(q, k, v, **kw), ref.attention_ref(q, k, v, **kw)
        err, excess = max_abs_err(out, plain), ref.attention_excess(out, plain)
        del out
        sdpa, library_call, library_error = sdpa_for(q, k, v, kw)
        library_ratio = ref.attention_excess(sdpa(), plain) if sdpa is not None else None
        del plain
        rtol, row_tol = ref.ATTN_TOL[q.dtype]
        return {
            "call": key, "path": call["path"], "app": call["app"],
            "dtype": str(q.dtype).split(".")[-1], **kw,
            "shape": dict(zip(shape_of["flash_attention"][0], call["shape"])),
            "max_abs_err": err, "tol_ratio": excess,
            "tolerance": {"rtol": rtol, "row_tol": row_tol},
            "library_call": library_call, "library_tol_ratio": library_ratio,
            "library_error": library_error,
        }, (q, k, v, kw, sdpa, *flash_work(q, k, **kw))

    for key in ("float32", "windowed", "lm_prefill"):
        check(key in flash_largest, f"flash attention had no {key} call in phases 7-11")
    cases = {key: flash_case(key, call) for key, call in
             (("largest", largest["flash_attention"]), *flash_largest.items())}
    emit({"phase": "flash_checks", "checks": [row for row, _ in cases.values()]})
    for key, (row, _) in cases.items():
        check(row["tol_ratio"] <= 1.0,
              f"flash attention ({key} call) is {row['tol_ratio']} times its tolerance "
              f"(max abs err {row['max_abs_err']})")
    for key in ("float32", "windowed", "lm_prefill"):
        row, (q, k, v, kw, sdpa, nbytes, flops, peak) = cases[key]
        row.update(ms=timed(lambda: ops.flash_attention(q, k, v, **kw)),
                   plain_ms=timed(lambda: ref.attention_ref(q, k, v, **kw)),
                   bound_ms=bound(nbytes, flops, peak)[0],
                   library_ms=timed(sdpa) if sdpa is not None else None)
    row, (q, k, v, kw, sdpa, nbytes, flops, peak) = cases["largest"]
    record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:130",
           lambda: ops.flash_attention(q, k, v, **kw), lambda: ref.attention_ref(q, k, v, **kw),
           row["max_abs_err"], nbytes, flops, peak, library=sdpa, tol_ratio=row["tol_ratio"],
           tolerance=row["tolerance"], checks=[r for r, _ in cases.values()],
           library_call=row["library_call"], library_tol_ratio=row["library_tol_ratio"],
           library_error=row["library_error"])
    del q, k, v, sdpa, cases

    # K5 on the inputs of its largest call (the stacked step over every
    # HeartClass block), and at each shape's first call (the stack and the
    # example's G = 1 call)
    def k5_work(s, w, v, **kw):
        # s, W and v in; spikes and v out; a multiply-add per term
        return (s.numel() + w.numel() + 3 * v.numel()) * 4, 2 * v.numel() * s.shape[-1]

    def k5_compare(args, kw):
        (ks, kv), (ps, pv) = ops.lif_crossbar_step(*args, **kw), \
            ref.lif_crossbar_step_ref(*args, **kw)
        return max(max_abs_err(ks, ps), max_abs_err(kv, pv))

    s_in, w_in, v_in = largest["lif_crossbar_step"]["args"]
    kw5 = largest["lif_crossbar_step"]["kwargs"]
    record("lif_crossbar_step", "src/repro_torch/csrc/lif_crossbar.cu",
           "src/repro/kernels/lif_crossbar.py:87",
           lambda: ops.lif_crossbar_step(s_in, w_in, v_in, **kw5),
           lambda: ref.lif_crossbar_step_ref(s_in, w_in, v_in, **kw5),
           k5_compare((s_in, w_in, v_in), kw5), *k5_work(s_in, w_in, v_in),
           FP32_FLOPS_PER_S,
           library_note="none: no single PyTorch call computes a product fused "
                        "with the threshold and reset")
    kernels[-1]["by_shape"], kernels[-1]["rule2_ms"], _ = by_shape(
        "lif_crossbar_step", k5_work, FP32_FLOPS_PER_S, k5_compare,
        plain=lambda args, kw: ref.lif_crossbar_step_ref(*args, **kw))
    del s_in, w_in, v_in, first_of_shape

    # K7 on the inputs of its last largest call (jamba's bf16 32k prefill,
    # a second launch: from the combined chunk states)
    x7, dt7, a7, b7, c7, h07 = largest["mamba_chunk_scan"]["args"]
    chunk7 = largest["mamba_chunk_scan"]["kwargs"].get("chunk", 128)
    (ky, kh), (py, ph) = (ops.mamba_chunk_scan(x7, dt7, a7, b7, c7, h07, chunk=chunk7),
                          ref.mamba_chunk_scan_ref(x7, dt7, a7, b7, c7, h07, chunk=chunk7))
    y_ratio, h_ratio = ref.scan_excess(ky, py, chunk7), ref.state_excess(kh, ph)
    rtol7, row_tol7 = ref.SCAN_TOL[torch.float32]
    y_err, h_err = max_abs_err(ky, py), max_abs_err(kh, ph)
    del ky, kh, py, ph
    # the whole scan of the same layer: ops.mamba_scan (the states pass, the
    # combine and K7) against the plain route (the plain states, combine and
    # chunk scan), within SCAN_TOL
    ry, rh = ops.mamba_scan(x7, dt7, a7, b7, c7, chunk=chunk7)
    ps = ref.mamba_chunk_scan_ref(x7, dt7, a7, b7, c7, torch.zeros_like(h07), chunk=chunk7)[1]
    py, ph = ref.mamba_chunk_scan_ref(x7, dt7, a7, b7, c7,
                                      ref.mamba_combine_ref(dt7, a7, ps, chunk=chunk7),
                                      chunk=chunk7)
    ph = ph[:, -1]
    route = {"route_y_tol_ratio": ref.scan_excess(ry, py, chunk7),
             "route_state_tol_ratio": ref.state_excess(rh, ph),
             "route_bit_identical": bool(torch.equal(ry, py) and torch.equal(rh, ph))}
    del ry, rh, ps, py, ph
    check(max(route["route_y_tol_ratio"], route["route_state_tol_ratio"]) <= 1.0,
          f"ops.mamba_scan lies {route} of SCAN_TOL from the plain route")
    def k7_work(x, dt, a, b, c, h0):
        bsz, length, d = x.shape
        # x, dt and y; B and C; a; h0 and h_out.  Per (b, t, d, n) term seven
        # float32 operations: dt*a, exp, decay*h, (dt*x)*B, the add, h*C and
        # the sum's add (dt*x is per (b, t, d))
        nbytes = (3 * x.numel() + 2 * b.numel()) * x.element_size() + a.numel() * 4 \
            + 2 * h0.numel() * 4
        return nbytes, 7 * bsz * length * d * a.shape[1] + bsz * length * d

    terms7 = x7.shape[0] * x7.shape[1] * x7.shape[2] * a7.shape[1]
    nbytes7, ops7 = k7_work(x7, dt7, a7, b7, c7, h07)
    record("mamba_chunk_scan", "src/repro_torch/csrc/mamba_scan.cu",
           "src/repro/kernels/mamba_scan.py:96",
           lambda: ops.mamba_chunk_scan(x7, dt7, a7, b7, c7, h07, chunk=chunk7),
           lambda: ref.mamba_chunk_scan_ref(x7, dt7, a7, b7, c7, h07, chunk=chunk7),
           max(y_err, h_err), nbytes7, ops7, FP32_FLOPS_PER_S,
           tol_ratio=max(y_ratio, h_ratio),
           tolerance={"rtol": ref.SCAN_TOL[x7.dtype][0], "row_tol": ref.SCAN_TOL[x7.dtype][1],
                      "state_rtol": rtol7, "state_row_tol": row_tol7},
           y_tol_ratio=y_ratio, state_tol_ratio=h_ratio, y_max_abs_err=y_err,
           state_max_abs_err=h_err, **route, dtype=str(x7.dtype).split(".")[-1],
           chunk=chunk7, expf=terms7, expf_bound_ms=1e3 * terms7 / EX2_PER_S,
           library_note="none: no single PyTorch call computes a selective scan")
    kernels[-1]["by_path"] = by_path("mamba_chunk_scan", k7_work, FP32_FLOPS_PER_S)
    del x7, dt7, a7, b7, c7, h07, path_largest

    # K7's states-only pass on the inputs of its largest call (jamba's bf16
    # 32k prefill), from zero states: equal to the plain version's states
    # and to the full launch's
    x7, dt7, a7, b7 = largest["mamba_chunk_states"]["args"]
    chunk7 = largest["mamba_chunk_states"]["kwargs"].get("chunk", 128)
    zeros7 = torch.zeros((x7.shape[0], -(-x7.shape[1] // chunk7), x7.shape[2], a7.shape[1]),
                         device=dev)
    ks = ops.mamba_chunk_states(x7, dt7, a7, b7, chunk=chunk7)
    py, ps = ref.mamba_chunk_scan_ref(x7, dt7, a7, b7, b7, zeros7, chunk=chunk7)
    s_ratio, s_err = ref.state_excess(ks, ps), max_abs_err(ks, ps)
    states_equal_full = bool(torch.equal(ks, ops.mamba_chunk_scan(
        x7, dt7, a7, b7, b7, zeros7, chunk=chunk7)[1]))
    del py
    check(states_equal_full, "the states-only pass differs from the full launch's states")
    check(s_ratio == 0.0, f"the states-only pass is {s_ratio} times the state's limit, not 0")

    def states_work(x, dt, a, b):
        bsz, length, d = x.shape
        # x, dt and B in, a in, the states out; per (b, t, d, n) term dt*a,
        # exp, decay*h, (dt*x)*B and the add
        nbytes = (2 * x.numel() + b.numel()) * x.element_size() + a.numel() * 4 \
            + bsz * (-(-length // chunk7)) * d * a.shape[1] * 4
        return nbytes, 5 * bsz * length * d * a.shape[1] + bsz * length * d

    record("mamba_chunk_states", "src/repro_torch/csrc/mamba_scan.cu",
           "src/repro/kernels/mamba_scan.py:96",
           lambda: ops.mamba_chunk_states(x7, dt7, a7, b7, chunk=chunk7),
           lambda: ref.mamba_chunk_scan_ref(x7, dt7, a7, b7, b7, zeros7, chunk=chunk7),
           s_err, *states_work(x7, dt7, a7, b7), FP32_FLOPS_PER_S, tol_ratio=s_ratio,
           tolerance={"state_rtol": rtol7, "state_row_tol": row_tol7, "limit": 0.0},
           equals_full_launch_states=states_equal_full,
           dtype=str(x7.dtype).split(".")[-1], chunk=chunk7,
           expf_bound_ms=1e3 * terms7 / EX2_PER_S,
           library_note="none: no single PyTorch call computes a selective scan")

    # the combine on the inputs of its largest call (the same prefill)
    dt8, a8, s8 = largest["mamba_chunk_combine"]["args"]
    chunk8 = largest["mamba_chunk_combine"]["kwargs"].get("chunk", 128)
    kc, pc = (ops.mamba_chunk_combine(dt8, a8, s8, chunk=chunk8),
              ref.mamba_combine_ref(dt8, a8, s8, chunk=chunk8))
    c_ratio, c_err = ref.state_excess(kc, pc), max_abs_err(kc, pc)
    del kc, pc
    # dt in, a in, the local states in and the initial states out; per
    # (b, chunk, d, n) the decay's multiply and exp, the update's multiply
    # and add; per (b, t, d) the dt sum's add
    record("mamba_chunk_combine", "src/repro_torch/csrc/mamba_scan.cu",
           "src/repro/kernels/ops.py:219",
           lambda: ops.mamba_chunk_combine(dt8, a8, s8, chunk=chunk8),
           lambda: ref.mamba_combine_ref(dt8, a8, s8, chunk=chunk8),
           c_err, dt8.numel() * dt8.element_size() + a8.numel() * 4 + 2 * s8.numel() * 4,
           4 * s8.numel() + dt8.numel(), FP32_FLOPS_PER_S, tol_ratio=c_ratio,
           tolerance={"state_rtol": rtol7, "state_row_tol": row_tol7}, chunk=chunk8,
           replaces_note="not a Pallas kernel: the lax.scan combine of the reference's "
                         "ops.mamba_scan, between its two Pallas launches",
           library_note="none: no single PyTorch call computes the chunk recurrence")
    del x7, dt7, a7, b7, zeros7, ks, ps, dt8, a8, s8

    # spike_input on the inputs of its largest call (HeartClass's recording),
    # against the plain version on the host (the card's index_add_ adds in no
    # fixed order); the yardstick is one CSR sparse matrix-vector product
    s9, csr9 = largest["spike_input"]["args"]
    csr9_host = ref.SynapseCSR(**{f: getattr(csr9, f).cpu()
                                  for f in ("indptr", "pre", "weight", "post")})
    k9 = ops.spike_input(s9, csr9)
    check(torch.equal(ops.spike_input(s9, csr9), k9), "spike_input differs between two launches")
    err9 = max_abs_err(k9.cpu(), ref.spike_input_ref(s9.cpu(), csr9_host))
    n9, e9 = csr9.n_neurons, int(csr9.pre.numel())
    deg9 = torch.diff(csr9.indptr.long())
    with warnings.catch_warnings():       # sparse CSR support is in beta
        warnings.simplefilter("ignore")
        sparse9 = torch.sparse_csr_tensor(csr9.indptr, csr9.pre, csr9.weight, (n9, n9))
    try:
        (sparse9 @ s9).sum().item()
        library9, library9_error = (lambda: sparse9 @ s9), None
    except RuntimeError as e:      # no sparse product for these index types
        library9, library9_error = None, str(e).splitlines()[0][:200]
    # indptr, pre and w in, s in, i out; a multiply and an add a synapse
    record("spike_input", "src/repro_torch/csrc/spike_input.cu",
           "src/repro/core/lif.py:58",
           lambda: ops.spike_input(s9, csr9), lambda: ref.spike_input_ref(s9, csr9),
           err9, 4 * (n9 + 1) + 8 * e9 + 8 * n9, 2 * e9, FP32_FLOPS_PER_S,
           library=library9, library_call="torch.sparse_csr_tensor(indptr, pre, w) @ s",
           library_error=library9_error, plain_device="cuda (index_add_, no fixed order)",
           replaces_note="not a Pallas kernel: the reference's jax.ops.segment_sum",
           in_degree_mean=float(deg9.double().mean()), in_degree_max=int(deg9.max()),
           equal_in_two_launches=True)
    del s9, csr9, csr9_host, k9, sparse9

    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} never launched on the main path")
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
