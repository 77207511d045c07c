"""What the port's spans and counters (``repro_torch.obs``) cost a decode
step, in turns on one card.

For each decode cell of ``BENCHMARK.json`` named, one run's weights and
loop (``portbench.harness.Run``, set up and warmed as the benchmark does),
then turns of ``--turn`` seconds of its decode loop in three modes:

* ``off``: no profiler, so the record is off (what untraced runs pay);
* ``prof``: under ``torch.profiler`` (CPU and CUDA activity, as a traced
  run) with ``obs``'s span and count stubbed out: the profiler alone;
* ``untimed``: under the profiler with the record on but no span timed on
  the card (every span's ``at`` None: ``record_function`` and the host
  record, no CUDA event);
* ``on``: under the profiler with the record on.

``on`` less ``prof`` is what the spans and the MoE's counters cost while
they record; ``on`` less ``untimed`` is the events' share of it.  Modes rotate, each first in turn.  A turn gives its steps,
the window's milliseconds a step (host clock, one sync at its end) and the
median time between consecutive steps (CUDA events after each step).

Run from the repository root on a machine with the card:

    python3 tools/obs_cost.py --cells deepseek.decode,jamba.decode

One JSON line per turn, then one summary line per cell (medians of each
mode over its turns).  ``--device cpu --root <fixture root>`` rehearses it
on the CPU with ``portbench.fixture_root``'s tiny cells.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

MODES = ("off", "prof", "untimed", "on")


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


@contextlib.contextmanager
def mode(name, obs, cuda):
    if name == "off":
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    saved = obs.span, obs.count, obs.enabled
    if name == "prof":
        obs.span = lambda n, at=None: contextlib.nullcontext()
        obs.count = lambda n, v: None
        obs.enabled = lambda: False
    elif name == "untimed":
        obs.span = lambda n, at=None, real=saved[0]: real(n, None)
    try:
        with torch.profiler.profile(activities=acts):
            yield
    finally:
        obs.span, obs.count, obs.enabled = saved


def turn(run, name, seconds, obs):
    loop = run.loop
    first = len(loop.marks.marks)
    obs.reset()
    with mode(name, obs, run.cuda):
        stats = loop.window(seconds)
    marks = range(first, len(loop.marks.marks))
    tbt = [loop.marks.ms(i, i + 1) for i in marks[:-1]]
    out = {"mode": name, "steps": stats["steps"],
           "ms_a_step": 1e3 * stats["window_s"] / stats["steps"],
           "tbt_ms_p50": statistics.median(tbt) if tbt else None}
    if name == "on" and run.cuda:
        snap = obs.snapshot()
        step = snap["spans"]["step.decode"]
        out["span_ms_a_step"] = 1e3 * step["device_s"] / step["count"]
        out["spans_a_step"] = sum(s["count"] for s in snap["spans"].values()) / step["count"]
    obs.reset()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="deepseek.decode,jamba.decode")
    ap.add_argument("--seed", type=int, default=2**31 + 1234)
    ap.add_argument("--turn", type=float, default=2.0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    sink = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    emit({"card": card() if device.type == "cuda" else device.type,
          "torch": torch.__version__})
    for cell in args.cells.split(","):
        run = harness.Run(args.root, cell, args.seed, device)
        run.warm()
        from repro_torch import obs
        rows = []
        for r in range(args.rounds):
            for k in range(len(MODES)):
                name = MODES[(r + k) % len(MODES)]
                row = dict(cell=cell, round=r, **turn(run, name, args.turn, obs))
                rows.append(row)
                emit(row)
        summary = {"cell": cell}
        for name in MODES:
            mine = [x for x in rows if x["mode"] == name]
            summary[name] = {k: statistics.median(x[k] for x in mine)
                             for k in ("ms_a_step", "tbt_ms_p50", "span_ms_a_step")
                             if all(x.get(k) is not None for x in mine)}
        for k in ("ms_a_step", "tbt_ms_p50"):
            if k in summary["on"] and k in summary["prof"]:
                summary[f"obs_cost_{k}"] = summary["on"][k] - summary["prof"][k]
                summary[f"event_cost_{k}"] = summary["on"][k] - summary["untimed"][k]
                summary[f"trace_cost_{k}"] = summary["on"][k] - summary["off"][k]
        emit(summary)
        run.loop.free()
        del run
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
