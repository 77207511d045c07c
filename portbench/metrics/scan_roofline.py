"""The Mamba scan's route (``mamba_scan_route`` in ``csrc/mamba_scan.cu``),
in % of its roofline: each launch's bound (``work.route_work`` at the
cell's (batch, tokens, d_inner) with d_state states, its operations at 67
TFLOP/s on the CUDA cores or its bytes at 3.35 TB/s, the larger) over the
launches' device time."""

from portbench import readers, work

KERNELS = ("mamba_scan_route_kernel",)


def bound_s(ctx):
    m, t = ctx.model, ctx.traffic
    nbytes, flops = work.route_work(t["batch"], t["tokens"], m["mamba_d_inner"], m["mamba_d_state"],
                                    m["mamba_chunk"], readers.ELEM_BYTES[t["params_dtype"]])
    return work.bound_s(nbytes, flops, work.FP32_FLOPS_PER_S)


def read(ctx):
    return readers.kernel_roofline(ctx, KERNELS, bound_s)
