"""MLA's dense masked attention's share of the prefill step's device time,
in %: 100 x the device seconds of the program's ``mla.sdpa`` spans (the
float32 scores, mask, softmax and weighted sum of ``_sdpa``) over those of
``step.prefill``, each span timed by CUDA events on its stream."""

from portbench import spans


def read(ctx):
    return spans.device_share(ctx, "mla.sdpa", "step.prefill")
