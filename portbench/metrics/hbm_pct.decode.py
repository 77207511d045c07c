"""The decode steps' share of the card's memory rate, in %: the bytes the
window's decode steps need (``decode_bytes.window_bytes``: each dense weight
once a step, only the experts hit, the embedding rows, the caches at the
window's kept pairs, the Mamba states) over the device seconds of the
program's ``step.decode`` spans and 3.35 TB/s."""

from portbench import decode_bytes, spans, work


def read(ctx):
    step = spans.span(ctx, "step.decode")
    c = spans.counters(ctx)
    if step is None or not step["device_s"] or c is None:
        return None
    moe = any(f == "moe" for _, f in ctx.model["layers"])
    if moe and "moe.experts_hit" not in c:
        return None
    nbytes = decode_bytes.window_bytes(ctx.model, ctx.traffic, step["count"],
                                       ctx.stats["processed"], ctx.stats["pairs"],
                                       c.get("moe.experts_hit", 0), ctx.kinds)
    return 100.0 * nbytes / (step["device_s"] * work.HBM_BYTES_PER_S)
