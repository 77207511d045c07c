"""What a ``torch.profiler`` trace of the window says: the device's busy
time, its operations by name, and its idle gaps by what the host was doing.

The window is the span of the ``WINDOW`` annotation the harness opens
around it.  Device activity is every event the profiler puts on a CUDA
device (kernels, copies, sets) but annotations, which the profiler mirrors
onto the device's timeline; busy time is the length of their union inside
the window.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
from torch.autograd import DeviceType

WINDOW = "portbench.window"
#: entries of each breakdown list
TOP = 10
#: idle gaps whose host activity is looked up, longest first
GAPS_LOOKED_UP = 2000


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    by_name: dict                # device op name -> (seconds, count)
    idle_by_host: dict           # host activity -> seconds of device idle

    def kernel_time(self, *needles: str) -> tuple[float, int]:
        """Summed seconds and count of the device ops whose name holds any
        of ``needles``."""
        secs = count = 0
        for name, (s, c) in self.by_name.items():
            if any(n in name for n in needles):
                secs += s
                count += c
        return secs, count

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top({k: s for k, (s, _) in self.by_name.items()}),
                "idle_gaps": top(self.idle_by_host)}


def _union(starts, ends):
    """Merged intervals of the sorted-by-start ``starts``/``ends``."""
    merged = []
    for s, e in zip(starts, ends):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(prof, window_s: float) -> Trace:
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    dev, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1 or e.name() == WINDOW:
            continue
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((max(s, w0), min(t, w1), e.name()))
        else:
            host.append((s, t, e.name()))
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for s, t, name in dev:
        by_name[name][0] += (t - s) / 1e9
        by_name[name][1] += 1
    dev.sort()
    merged = _union([d[0] for d in dev], [d[1] for d in dev])
    busy_ns = sum(e - s for s, e in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    return Trace(window_s=window_s, busy_s=busy_ns / 1e9,
                 by_name={k: tuple(v) for k, v in by_name.items()},
                 idle_by_host=_idle_by_host(gaps[:GAPS_LOOKED_UP], host))


def _idle_by_host(gaps, host) -> dict:
    """Each gap's length under the innermost host event open at its start
    (of nested events, the latest to start), or "host: between ops"."""
    out = collections.defaultdict(float)
    host.sort()
    starts = np.array([h[0] for h in host], dtype=np.int64)
    for length, at in gaps:
        i = int(np.searchsorted(starts, at, side="right"))
        name = "between ops"
        for s, t, n in reversed(host[max(0, i - 4096):i]):
            if t > at:
                name = n
                break
        out[f"host: {name}"] += length / 1e9
    return dict(out)
