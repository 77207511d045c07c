"""K6, the port's flash attention (``csrc/flash_attention.cu``), in % of
its roofline: each launch's bound (``work.flash_work`` at the cell's
self-attention shape, causal: 4 head_dim flops a kept pair and query head
at 989 TFLOP/s in bf16, three TF32 products a product at 495 in float32,
or its bytes at 3.35 TB/s, the larger) over the launches' device time."""

from portbench import readers, work

KERNELS = ("flash_wgmma_kernel", "flash_tf32_kernel")


def bound_s(ctx):
    m, t = ctx.model, ctx.traffic
    dtype = t["params_dtype"]
    nbytes, flops = work.flash_work(t["batch"], m["n_heads"], m["n_kv_heads"], t["tokens"],
                                    m["head_dim"], readers.ELEM_BYTES[dtype])
    return work.bound_s(nbytes, flops, work.BF16_FLOPS_PER_S if dtype == "bfloat16"
                        else work.TF32_FLOPS_PER_S / 3)


def read(ctx):
    return readers.kernel_roofline(ctx, KERNELS, bound_s)
