"""The routed experts' share of the decode step's device time, in %: 100 x
the device seconds of the program's ``moe.experts`` spans (the expert
SwiGLU GEMMs over every expert's capacity rows) over those of
``step.decode``, each span timed by CUDA events on its stream."""

from portbench import spans


def read(ctx):
    return spans.device_share(ctx, "moe.experts", "step.decode")
