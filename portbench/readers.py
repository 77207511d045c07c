"""What the per-layer metrics read, shared by their files in ``metrics/``.

Each reader takes the run's context (``stats`` of the window, the parsed
``trace``, the configuration's ``model`` block and ``kinds``, its reference
module's ``KINDS``, the ``traffic`` mix, the window's allocator peak) and
returns a number, or None where the run has nothing for it to read: no
card, no trace, no matching kernel.  A share of a peak or a roofline is
never made up as 0.
"""

from __future__ import annotations

from portbench import work

ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def device_idle_pct(ctx):
    if not ctx.cuda or ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def peak_mem_gib(ctx):
    return ctx.window_peak_bytes / 2**30 if ctx.cuda else None


def step_mfu(ctx):
    """Model FLOPs of every token the window's steps processed, over the
    window and the peak of the type the step's products run in."""
    if not ctx.cuda:
        return None
    flops = work.model_flops(ctx.model, ctx.stats["processed"], ctx.stats["pairs"], ctx.kinds)
    peak = work.STEP_PEAK_FLOPS_PER_S[ctx.traffic["params_dtype"]]
    return 100.0 * flops / (ctx.stats["window_s"] * peak)


def kernel_roofline(ctx, names, bound_one_s):
    """100 x (launches x one launch's bound) / the launches' device time;
    ``bound_one_s(ctx)`` is asked only where the trace has a launch."""
    if not ctx.cuda or ctx.trace is None:
        return None
    secs, count = ctx.trace.kernel_time(*names)
    if count == 0 or secs <= 0:
        return None
    return 100.0 * count * bound_one_s(ctx) / secs
