"""The benchmark's yardstick: the card's published peaks, the work of the
two kernels whose rooflines it reports, and a model's FLOPs.

The kernel formulas are frozen copies of the program's own at the time the
benchmark was written (K6's ``flash_work`` and the scan route's
``route_work``), so that a change there cannot move a roofline here.
Bytes count each input read once and each output written once; a
multiply-add is two operations.

A model's counts know the layer kinds ``MIXERS`` and ``FFNS``.  A
configuration whose layers use another kind brings its counts in its
reference module's ``KINDS``: for each kind it adds, the functions named in
``COUNTS``, each given the ``model`` block.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
#: float32 outside the tensor cores: PyTorch's default leaves TF32 off
FP32_FLOPS_PER_S = 67e12

#: the peak a model step's products run at, by the type of its parameters
STEP_PEAK_FLOPS_PER_S = {"bfloat16": BF16_FLOPS_PER_S, "float32": FP32_FLOPS_PER_S}

#: the layer kinds counted here and in ``decode_bytes.py``
MIXERS = ("gqa", "mla", "mamba")
FFNS = ("swiglu", "moe", "none")
#: what a reference module's ``KINDS[kind]`` gives for a kind it adds:
#: ``matmul_params(m)``, the parameters a token multiplies in one such layer;
#: ``pair_flops(m)``, its FLOPs per kept (query, key) pair; ``dense_params(m)``,
#: the parameters a decode step reads whole in it (norms aside);
#: ``window_bytes(m, tokens, pairs, cache_bytes)``, its cache or state bytes
#: over a window's decode tokens and kept pairs
COUNTS = ("matmul_params", "pair_flops", "dense_params", "window_bytes")


def unknown_kinds(m: dict, kinds: dict) -> list[str]:
    """The layer kinds of ``m`` counted neither here nor in full by ``kinds``
    (a reference module's ``KINDS``)."""
    used = {kind for layer in m["layers"] for kind in layer}
    return sorted(k for k in used - set(MIXERS + FFNS) if not set(COUNTS) <= set(kinds.get(k, ())))


def added(kinds, kind: str, count: str):
    """The function ``count`` of a layer kind not counted here, from
    ``kinds``; a ValueError where it has none."""
    if count not in (kinds or {}).get(kind, {}):
        raise ValueError(f"no {count} for layer kind {kind!r}: portbench does not count it and "
                         f"the configuration's reference module gives no KINDS for it")
    return kinds[kind][count]


def causal_pairs(sq: int) -> int:
    """(query, key) pairs a causal mask keeps over ``sq`` positions."""
    return sq * (sq + 1) // 2


def flash_work(b, hq, hkv, sq, d, elem_bytes) -> tuple[int, int]:
    """K6, causal without a window, self-attention of ``sq`` positions: (bytes
    of q, k, v and o; flops), 4 d flops per kept pair and query head."""
    nbytes = 2 * (b * hq * sq * d + b * hkv * sq * d) * elem_bytes
    return nbytes, 4 * d * hq * b * causal_pairs(sq)


def route_work(b, length, d, n, chunk, elem_bytes) -> tuple[int, int]:
    """The scan's route over (b, length, d) with n states from a zero state:
    x, dt and y; B and C; a; the last state out.  Per (b, t, d, n) term
    seven operations, two more in the chunks between the first and the last
    (the states from zero); per (b, t, d) dt*x, and at each chunk's end but
    the last the dt sum's adds and the combine's four a state."""
    nc = -(-length // chunk)
    nbytes = (3 * b * length * d + 2 * b * length * n) * elem_bytes + d * n * 4 + b * d * n * 4
    between = max(nc - 2, 0) * chunk
    return nbytes, (7 * length + 2 * between) * b * d * n + b * length * d \
        + (nc - 1) * (chunk * b * d + 4 * b * d * n)


def bound_s(nbytes: int, flops: int, flops_per_s: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


def matmul_params_per_token(m: dict, kinds=None) -> int:
    """Parameters a token multiplies in matrix products, in every layer and
    the LM head: the MoE's router, top-k routed experts and shared experts
    (no capacity padding); no embedding, norm, convolution or scan.  A kind
    not counted here is counted by ``kinds``."""
    d = m["d_model"]
    total = d * m["vocab"]
    for mixer, ffn in m["layers"]:
        if mixer == "gqa":
            hd = m["head_dim"]
            total += 2 * d * m["n_heads"] * hd + 2 * d * m["n_kv_heads"] * hd
        elif mixer == "mla":
            h, dn, dr, dv = m["n_heads"], m["mla_nope_dim"], m["mla_rope_dim"], m["mla_v_dim"]
            rq, rkv = m["mla_q_rank"], m["mla_kv_rank"]
            total += d * rq + rq * h * (dn + dr) + d * (rkv + dr) + rkv * h * (dn + dv) + h * dv * d
        elif mixer == "mamba":
            di, rk, n = m["mamba_d_inner"], m["mamba_dt_rank"], m["mamba_d_state"]
            total += d * 2 * di + di * (rk + 2 * n) + rk * di + di * d
        else:
            total += added(kinds, mixer, "matmul_params")(m)
        if ffn == "swiglu":
            total += 3 * d * m["d_ff"]
        elif ffn == "moe":
            total += d * m["moe_experts"] \
                + 3 * d * m["moe_d_ff"] * (m["moe_top_k"] + m["moe_shared"])
        elif ffn != "none":
            total += added(kinds, ffn, "matmul_params")(m)
    return total


def attention_flops_per_pair(m: dict, kinds=None) -> int:
    """FLOPs of one kept (query, key) pair, summed over the layers' heads:
    4 head_dim a head in GQA, 2 (d_qk + d_v) a head in MLA, none in Mamba
    or an FFN here; a kind not counted here, as ``kinds`` counts it."""
    total = 0
    for mixer, ffn in m["layers"]:
        if mixer == "gqa":
            total += 4 * m["head_dim"] * m["n_heads"]
        elif mixer == "mla":
            d_qk = m["mla_nope_dim"] + m["mla_rope_dim"]
            total += 2 * (d_qk + m["mla_v_dim"]) * m["n_heads"]
        elif mixer not in MIXERS:
            total += added(kinds, mixer, "pair_flops")(m)
        if ffn not in FFNS:
            total += added(kinds, ffn, "pair_flops")(m)
    return total


def model_flops(m: dict, tokens: int, pairs: int, kinds=None) -> int:
    """FLOPs of ``tokens`` tokens whose queries kept ``pairs`` (query, key)
    pairs in every attention layer; ``kinds`` counts the kinds not counted
    here."""
    return 2 * matmul_params_per_token(m, kinds) * tokens \
        + attention_flops_per_pair(m, kinds) * pairs
