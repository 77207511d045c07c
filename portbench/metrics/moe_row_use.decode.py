"""The share of the expert rows a decode step computes that carry a kept
choice, in %: 100 x the program's ``moe.kept`` counter (choices within
capacity) over ``moe.rows`` (experts x capacity, every MoE layer of every
step).  A count: it reads the same on any device."""

from portbench import spans


def read(ctx):
    c = spans.counters(ctx)
    if not c or not c.get("moe.rows"):
        return None
    return 100.0 * c["moe.kept"] / c["moe.rows"]
