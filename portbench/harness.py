"""One run of one cell: set-up, the measured window, the check, one line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the weights and the traffic from the seed on the card, builds
the port's kernels at first use and warms every shape the window runs.
The window runs the cell's traffic for ``--seconds`` (under
``torch.profiler`` with ``--trace 1``).  Then the reference checks a
sample of the window's answers, and the last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (and ``breakdown`` when traced) and, last, ``checks``: each
number compared beside its limit, which also close standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np

from portbench import check, loops, spec, weights, work
from portbench import trace as trace_mod

#: top-level modules a run must never load: the JAX package and JAX itself
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "repro"))


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def use_checkout_caches(root: pathlib.Path) -> None:
    """Every compiler cache at a fixed path inside the checkout."""
    base = root / "build" / "portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def import_port(root: pathlib.Path):
    """The program under test, from the checkout's ``src``."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import blocks, transformer
    return types.SimpleNamespace(get_arch=get_arch, steps=steps, blocks=blocks, tf=transformer)


def port_config(port, config: dict, traffic: dict):
    """The port's config of a configuration file under a traffic mix, held
    to the file's ``model`` block."""
    full = port.get_arch(config["port"]["arch"])
    repeats = config["port"]["repeats"]
    if len(repeats) != len(full.stacks):
        raise ValueError(f"{len(repeats)} repeats for {len(full.stacks)} stacks")
    cfg = dataclasses.replace(
        full, stacks=tuple((r, specs) for r, (_, specs) in zip(repeats, full.stacks)),
        dtype=traffic["activation_dtype"], **config["port"].get("overrides", {}))
    cap = traffic["moe_capacity"]
    # a model without a MoE has nothing for the mix's capacity to bound
    if cfg.moe_experts and cap == "dropless":
        cfg = dataclasses.replace(cfg, moe_capacity=cfg.moe_experts / cfg.moe_top_k)
    elif cfg.moe_experts and cap != "config":
        cfg = dataclasses.replace(cfg, moe_capacity=float(cap))
    model = config["model"]
    layers = [[s.mixer, s.ffn] for r, specs in cfg.stacks for _ in range(r) for s in specs]
    if layers != model["layers"]:
        raise ValueError(f"the port runs layers {layers}, the file states {model['layers']}")
    for key, value in model.items():
        if key not in ("layers", "norm_eps") and getattr(cfg, key) != value:
            raise ValueError(f"the port runs {key}={getattr(cfg, key)}, the file states {value}")
    return cfg


def end_to_end(name: str, stats: dict, setup_s: float) -> float:
    if name == "setup_s":
        return setup_s
    if name in ("prefill_tokens_per_s", "decode_tokens_per_s"):
        return stats["tokens"] / stats["window_s"]
    if name == "tbt_ms.p95":
        return float(np.percentile(stats["tbt_ms"], 95))
    raise KeyError(f"no end-to-end metric {name!r}")


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Run:
    """One cell on one seed: its weights, traffic and loop, made in set-up."""

    def __init__(self, root, workload: str, seed: int, device):
        import torch

        self.root = pathlib.Path(root)
        self.bench = spec.Bench(self.root)
        self.cell = self.bench.cell(workload)
        self.config = self.bench.config(self.cell["config"])
        self.traffic = self.bench.traffic(self.cell["traffic"])
        self.model, self.kind = self.config["model"], self.traffic["kind"]
        self.reference = self.bench.reference(self.config)
        self.kinds = getattr(self.reference, "KINDS", {})
        unknown = work.unknown_kinds(self.model, self.kinds)
        if unknown:
            raise ValueError(f"{self.cell['config']}: layer kinds {unknown} are counted neither by "
                             f"portbench nor by the KINDS of its reference module "
                             f"{self.bench.reference_path(self.config)}")
        t = time.perf_counter()
        self.port = import_port(self.root)
        self.cfg = port_config(self.port, self.config, self.traffic)
        self.cuda = device.type == "cuda"
        if self.cuda:
            torch.cuda.init()
        self.notes = {"import_port_s": time.perf_counter() - t}
        t = time.perf_counter()
        dtype = getattr(torch, self.traffic["params_dtype"])
        meta = self.port.tf.init_params(self.cfg, self.port.blocks.SHAPE_ONLY, dtype=dtype)
        self.params = weights.draw(meta, seed, device, self.config["initializer_range"],
                                   self.reference)
        self.loop = loops.make(self.traffic, self.cfg, self.params, seed, device, self.port.steps,
                               self.port.tf)
        loops.sync(device)
        self.notes["weights_s"] = time.perf_counter() - t

    def warm(self) -> None:
        t = time.perf_counter()
        self.loop.warm()
        self.notes["warm_s"] = time.perf_counter() - t

    def window(self, seconds: float, traced: bool):
        """(the window's stats, its parsed trace or None)."""
        import torch

        if not traced:
            return self.loop.window(seconds), None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(trace_mod.WINDOW):
                stats = self.loop.window(seconds)
        t = time.perf_counter()
        tr = trace_mod.read(prof, stats["window_s"])
        self.notes["trace_read_s"] = time.perf_counter() - t
        return stats, tr

    def context(self, stats: dict, tr, window_peak: int):
        """What the per-layer readers read of this run (``readers.py``)."""
        return types.SimpleNamespace(stats=stats, trace=tr, model=self.model, kinds=self.kinds,
                                     traffic=self.traffic, cuda=self.cuda,
                                     window_peak_bytes=window_peak)

    def judge(self, controls=()) -> tuple[dict, dict]:
        """The window's per-position values against the configuration's
        float32 reference (``"program"``), and for each precision in
        ``controls`` the reference at that precision in the program's place;
        and the numbers of each.  Frees the program's state first."""
        import torch

        logits_at = self.reference.logits_at
        self.loop.free()
        if self.cuda:
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t = time.perf_counter()
        head, layers = weights.per_layer(self.params, self.config["port"]["repeats"],
                                         [len(specs) for _, specs in self.cfg.stacks])
        cap = None if self.traffic["moe_capacity"] == "dropless" else self.cfg.moe_capacity
        cols = getattr(self.loop, "cols", None)
        found = {"program": [], **{c: [] for c in controls}}
        for toks, at, port in self.loop.cases():
            margins = []
            ref = logits_at(head, layers, self.model, toks, at, capacity=cap, margins=margins)
            tie = check.ties(margins, at)
            found["program"] += check.units(self.kind, port, ref, tie, cols)
            for c in controls:
                low = logits_at(head, layers, self.model, toks, at, capacity=cap, precision=c)
                found[c] += check.units(self.kind, self.loop.answer(low), ref, tie, cols)
        near = self.traffic["check"].get("near_tie")
        share_over = self.bench.check(self.cell["name"]).get("share_over")
        out = {k: check.numbers(v, near, share_over) for k, v in found.items()}
        self.notes["check_s"] = time.perf_counter() - t
        return out, found


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool, device):
    """(the result's JSON object, the check's lines) of one run."""
    import torch

    age_at_start = process_age_s()
    run = Run(root, workload, seed, device)
    run.notes["age_at_run_s"] = age_at_start
    run.warm()
    setup_peak = torch.cuda.max_memory_allocated(device) if run.cuda else 0
    if run.cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age_s()
    stats, tr = run.window(seconds, traced)
    window_peak = torch.cuda.max_memory_allocated(device) if run.cuda else 0
    numbers = run.judge()[0]["program"]
    ok, shown = check.verdict(numbers, run.bench.limits(workload))

    if traced:
        ctx = run.context(stats, tr, window_peak)
        metrics = {}
        for m in run.bench.per_layer(workload):
            value = run.bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], stats, setup_s), "unit": m["unit"]}
                   for m in run.bench.end_to_end(workload)}
    dev = {"platform": "gpu" if run.cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if run.cuda else device.type,
           "count": run.cell["chips"], "memory_peak_bytes": max(setup_peak, window_peak)}
    if traced:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    if run.cuda:
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": ok, "attempted": stats.get("requests", stats["tokens"]), "failed": 0,
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = tr.breakdown()
    result["checks"] = shown
    notes = {**run.notes, **{k: v for k, v in stats.items() if k != "tbt_ms"},
             "readings": numbers}
    lines = [f"portbench: {json.dumps(notes)}"]
    lines += [f"check {name} {v['value']!r} limit {v['limit']!r}" for name, v in shown.items()]
    return result, lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = spec.ROOT
    use_checkout_caches(root)
    import torch

    chips = spec.Bench(root).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, lines = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; it may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0
