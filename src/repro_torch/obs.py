"""Spans and counters inside the model step, on exactly while a
``torch.profiler`` is collecting.

The switch is ``torch.autograd._profiler_enabled()``: there is no knob of
its own.  An operator turns the record on by profiling the server, and
reads it with :func:`snapshot` after the profiled window.

* :func:`span` ``(name, at)`` marks a layer boundary.  Off, it makes that
  one check and returns a shared empty context: no event, no record
  function, no tensor op.  On, it opens a record function named
  ``"repro_torch." + name`` (the profiler's fast one, a tenth of
  ``torch.profiler.record_function``'s host time), which puts the span on
  the profiler's host timeline (the device trace's clock), and, where
  ``at`` is a CUDA tensor, records a timing event at each end on that
  device's current stream (the step's, for the spans inside a step).  The
  record keeps the span's name, its parent (the span open when it opened),
  its step (one id a ``step.*`` span, shared by every span under it), its
  host start and end and its device seconds.
* Nothing waits for the device while the record is on.  Events are
  reused, a few steps' worth a window: each ``step.*`` span first reads the
  spans whose end event the device has passed (a query, no wait) and frees
  their events.  (Holding one pair a span until the snapshot, tens of
  thousands a window, slowed a jamba decode step by a quarter on an H100.)
* :func:`count` ``(name, n)`` adds a host int or a device tensor (added
  in place on the device, no sync) to a counter, only while on.  Code
  that computes a device count guards it with :func:`enabled`, so that
  off it runs no op.
* :data:`LAUNCHES` is the always-on ``launches`` family: kernel launches
  per wrapper of ``kernels/ops.py``, which adds one where it launches
  (``ops.LAUNCHES`` is this dict; ``ops.reset_launches`` zeroes it).
* :func:`snapshot` reads the record (waiting for the events still
  unread, and each device counter) and gives the same result until
  something more is recorded; :func:`reset` clears the record.  Nothing is
  written to disk.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

PREFIX = "repro_torch."

#: kernel launches per ``kernels/ops.py`` wrapper since the last
#: ``ops.reset_launches`` (the wrapper names are ops.py's)
LAUNCHES: dict[str, int] = {}

enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
#: timing events already read, free for reuse, per device (kept across
#: :func:`reset`)
_FREE: dict[torch.device, list] = {}


class _Entry:
    __slots__ = ("name", "parent", "step", "host0", "host1", "device", "stream", "ev0", "ev1",
                 "device_s")

    def __init__(self, name, parent, step, device):
        self.name, self.parent, self.step, self.device = name, parent, step, device
        self.host1 = self.stream = self.ev0 = self.ev1 = self.device_s = None


def _event(device: torch.device, stream):
    free = _FREE.get(device)
    ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Record:
    def __init__(self):
        self.spans: list[_Entry] = []
        # timed spans whose events are not read yet, in the order they opened
        self.pending: collections.deque[_Entry] = collections.deque()
        self.open = threading.local()
        self.counts: dict[str, int] = {}
        self.device_counts: dict[str, torch.Tensor] = {}
        self.steps = 0
        # the stream the open step's spans are timed on
        self.stream = None
        self.snap = None

    def stack(self) -> list[int]:
        if not hasattr(self.open, "stack"):
            self.open.stack = []
        return self.open.stack

    def harvest(self, wait: bool) -> None:
        """Read the device seconds of the pending spans the device has
        passed (all closed ones, waiting for them, when ``wait``) and free
        their events."""
        pending = self.pending
        while pending and pending[0].ev1 is not None:
            e = pending[0]
            if wait:
                e.ev1.synchronize()
            elif not e.ev1.query():
                break
            e.device_s = e.ev0.elapsed_time(e.ev1) / 1e3
            _FREE.setdefault(e.device, []).extend((e.ev0, e.ev1))
            e.ev0 = e.ev1 = None
            pending.popleft()


_REC = _Record()


class _Span:
    __slots__ = ("name", "at", "rf", "rec", "entry")

    def __init__(self, name: str, at):
        self.name, self.at = name, at

    def __enter__(self):
        rec = self.rec = _REC
        stack = rec.stack()
        parent = stack[-1] if stack else None
        timed = self.at is not None and self.at.is_cuda
        opens_step = self.name.startswith("step.")
        if opens_step:
            rec.steps += 1
            step = rec.steps
            if timed:
                rec.harvest(wait=False)
        else:
            step = rec.spans[parent].step if parent is not None else None
        self.rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.rf.__enter__()
        e = self.entry = _Entry(self.name, parent, step, self.at.device if timed else None)
        if timed:
            stream = rec.stream
            if opens_step or step is None or stream is None or stream.device != e.device:
                stream = rec.stream = torch.cuda.current_stream(e.device)
            e.stream = stream
            e.ev0 = _event(e.device, stream)
            rec.pending.append(e)
        e.host0 = time.perf_counter_ns()
        stack.append(len(rec.spans))
        rec.spans.append(e)
        rec.snap = None
        return self

    def __exit__(self, *exc):
        e = self.entry
        if e.ev0 is not None:
            e.ev1 = _event(e.device, e.stream)
        e.host1 = time.perf_counter_ns()
        self.rec.stack().pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, at: torch.Tensor | None = None):
    """A context around one layer's work; ``at`` a tensor on the device
    whose stream times it (host time only where it is None or not CUDA)."""
    if not enabled():
        return _OFF
    return _Span(name, at)


def count(name: str, n) -> None:
    """Add ``n`` (a host int, or a device tensor of one element) to the
    counter ``name``, while the record is on."""
    if not enabled():
        return
    rec = _REC
    rec.snap = None
    if isinstance(n, torch.Tensor):
        acc = rec.device_counts.get(name)
        if acc is None:
            rec.device_counts[name] = n.detach().reshape(()).to(torch.int64, copy=True)
        else:
            acc.add_(n.reshape(()))
    else:
        rec.counts[name] = rec.counts.get(name, 0) + int(n)


def entries() -> list[tuple[str, int | None, int | None]]:
    """(name, parent index or None, step id or None) of every recorded
    span, in the order they opened."""
    return [(e.name, e.parent, e.step) for e in _REC.spans]


def snapshot() -> dict:
    """``{"spans": {name: {count, device_s, host_s, self_device_s}},
    "counters": {name: value}}``.  ``device_s`` sums the span's event pairs
    and ``self_device_s`` leaves out its children's; both are None for a
    name no device timed.  ``counters`` holds every counter and
    ``launches.<wrapper>`` for each wrapper with a launch, as it stands.
    The events and device counters are read at the first call after the
    last record; later calls give the same numbers."""
    rec = _REC
    if rec.snap is None:
        rec.harvest(wait=True)
        spans = rec.spans
        child = [0.0] * len(spans)
        for e in spans:
            if e.parent is not None and e.device_s is not None:
                child[e.parent] += e.device_s
        out: dict[str, dict] = {}
        for i, e in enumerate(spans):
            s = out.setdefault(e.name, {"count": 0, "device_s": None, "host_s": 0.0,
                                        "self_device_s": None})
            s["count"] += 1
            if e.host1 is not None:
                s["host_s"] += (e.host1 - e.host0) / 1e9
            if e.device_s is not None:
                s["device_s"] = (s["device_s"] or 0.0) + e.device_s
                s["self_device_s"] = (s["self_device_s"] or 0.0) + e.device_s - child[i]
        counters = dict(rec.counts)
        counters.update({k: int(t.item()) for k, t in rec.device_counts.items()})
        rec.snap = {"spans": out, "counters": counters}
    launches = {f"launches.{k}": v for k, v in LAUNCHES.items() if v}
    return {"spans": rec.snap["spans"], "counters": {**rec.snap["counters"], **launches}}


def reset() -> None:
    """Clear the record (the launch counts are ``ops.reset_launches``')."""
    global _REC
    _REC = _Record()
