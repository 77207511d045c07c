"""The work of a kernel call: the bytes it must move and the operations it
does, from its inputs' shapes.

One formula each for flash attention (K6), the chunk scan (K7), its
states-only pass, the chunk combine, the scan's route, the synaptic sum and
the LIF recording.  ``chip_smoke.py`` divides them by the card's rates for
each kernel's ``bound_ms``; the dry run (``launch/dryrun.py``) charges the
first five for each wrapper call, on every device, in place of the plain
version's operations.  Bytes count each
input read once and each output written once; a multiply-add is two
operations.
"""

from __future__ import annotations

import numpy as np


def attn_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep, per (batch, head)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(q, k, *, causal: bool, window: int) -> tuple[int, int]:
    """K6: (bytes of q, k, v and o; flops): per kept pair and query head a
    D-long dot product for the score and a D-long multiply-add into the
    output, 4 D flops."""
    b, hq, sq, d = q.shape
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    return nbytes, 4 * d * hq * b * attn_pairs(sq, k.shape[2], causal, window)


def scan_work(x, a, b, h0, *, chunk: int) -> tuple[int, int]:
    """K7, the chunk scan: x, dt and y; B and C; a; h0 (none read where it
    is None: zero states) and h_out.  Per (b, t, d, n) term seven float32
    operations: dt*a, exp, decay*h, (dt*x)*B, the add, h*C and the sum's
    add (dt*x is per (b, t, d))."""
    bsz, length, d = x.shape
    states = bsz * (-(-length // chunk)) * d * a.shape[1]
    nbytes = (3 * x.numel() + 2 * b.numel()) * x.element_size() + a.numel() * 4 \
        + (states if h0 is None else states + h0.numel()) * 4
    return nbytes, 7 * bsz * length * d * a.shape[1] + bsz * length * d


def states_work(x, a, b, *, chunk: int) -> tuple[int, int]:
    """K7's states-only pass: x, dt and B in, a in, the states out.  Per
    (b, t, d, n) term dt*a, exp, decay*h, (dt*x)*B and the add."""
    bsz, length, d = x.shape
    nbytes = (2 * x.numel() + b.numel()) * x.element_size() + a.numel() * 4 \
        + bsz * (-(-length // chunk)) * d * a.shape[1] * 4
    return nbytes, 5 * bsz * length * d * a.shape[1] + bsz * length * d


def combine_work(dt, a, s_local) -> tuple[int, int]:
    """The chunk combine: dt, a and the local states in, the initial states
    out.  Per (b, chunk, d, n) the decay's multiply and exp, the update's
    multiply and add; per (b, t, d) the dt sum's add."""
    nbytes = dt.numel() * dt.element_size() + a.numel() * 4 + 2 * s_local.numel() * 4
    return nbytes, 4 * s_local.numel() + dt.numel()


def route_work(x, a, b, *, chunk: int) -> tuple[int, int]:
    """The scan's route in one walk: x, dt and y; B and C; a; the last
    state out.  Per (b, t, d, n) term K7's seven operations, and in the
    chunks between the first and the last two more for the states from zero
    (decay*h and the add: in the first chunk those are the states from
    H(0) = 0, the last needs none); per (b, t, d) dt*x, and the dt sum's
    add in every chunk but the last; per (b, d, n) at each of those chunks'
    ends the combine's four (dt sum*a, exp, decay*H, the add)."""
    bsz, length, d = x.shape
    n = a.shape[1]
    nc = -(-length // chunk)
    nbytes = (3 * x.numel() + 2 * b.numel()) * x.element_size() + a.numel() * 4 \
        + bsz * d * n * 4
    between = max(nc - 2, 0) * chunk
    return nbytes, (7 * length + 2 * between) * bsz * d * n + bsz * length * d \
        + (nc - 1) * (chunk * bsz * d + 4 * bsz * d * n)


def spike_input_work(n: int, e: int, active: int | None = None) -> tuple[int, int]:
    """The synaptic sum over n neurons' E synapses: indptr, pre and w in, s
    in, i out, and a multiply and an add a synapse.  With ``active``, the
    synapses whose source fired: w's bytes and the operations only for
    those (the kernel loads w and adds only where s is nonzero)."""
    if active is None:
        return 4 * (n + 1) + 8 * e + 8 * n, 2 * e
    return 4 * (n + 1) + 4 * e + 4 * active + 8 * n, 2 * active


def lif_record_work(n: int, e: int, n_steps: int, n_inputs: int,
                    active: int | None = None) -> tuple[int, int]:
    """The LIF recording of n neurons (``n_inputs`` of them input neurons)
    over E synapses for ``n_steps`` steps: indptr, pre, w and is_input read
    once (the synapses stay in the L2 from step to step), the input
    neurons' draws, counts, v and refr written once; a multiply and an add
    a synapse a step, or with ``active`` (synapse-steps whose source fired)
    only for those."""
    nbytes = 4 * (n + 1) + 8 * e + n + 4 * n_inputs * n_steps + 12 * n
    return nbytes, 2 * (e * n_steps if active is None else active)
