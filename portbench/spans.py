"""What the per-layer metrics of the program's own spans and counters read:
``repro_torch.obs``, the record the program keeps while ``torch.profiler``
collects.  In a run that is the traced window alone: set-up and the check
run unprofiled.

A program without that module (a commit before it) gives None, as does a
run whose spans no card timed: a share is never made up.
"""

from __future__ import annotations

import importlib


def snapshot():
    """The program's record of the window, or None where it keeps none."""
    try:
        obs = importlib.import_module("repro_torch.obs")
    except ImportError:
        return None
    return obs.snapshot()


def span(ctx, name: str):
    """The record's entry of span ``name`` (count, device_s, host_s,
    self_device_s) in a traced run on a card, or None."""
    if not ctx.cuda or ctx.trace is None:
        return None
    snap = snapshot()
    return None if snap is None else snap["spans"].get(name)


def device_share(ctx, part: str, whole: str):
    """100 x the device seconds of span ``part`` over those of ``whole``."""
    p, w = span(ctx, part), span(ctx, whole)
    if p is None or w is None or p["device_s"] is None or not w["device_s"]:
        return None
    return 100.0 * p["device_s"] / w["device_s"]


def counters(ctx):
    """The record's counters in a traced run (on any device), or None."""
    if ctx.trace is None:
        return None
    snap = snapshot()
    return None if snap is None else snap["counters"]
