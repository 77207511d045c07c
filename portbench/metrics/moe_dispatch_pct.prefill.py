"""The MoE dispatch's share of the prefill step's device time, in %: 100 x
the device seconds of the program's ``moe.dispatch`` spans (the one-hot,
its cumsum, the slots and the buffer fill) over those of ``step.prefill``,
each span timed by CUDA events on its stream."""

from portbench import spans


def read(ctx):
    return spans.device_share(ctx, "moe.dispatch", "step.prefill")
