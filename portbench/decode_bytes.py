"""The bytes a window of decode steps needs from memory, each byte once, at
the traffic's types: what ``hbm_pct.decode`` puts over the steps' device
time.

* Every dense weight matrix once a step: the mixers, norms, a MoE's router
  and shared experts, the dense FFNs, the LM head (parameters' type).
* Of the routed experts only those hit: each layer's experts with at least
  one kept choice a step (the program's ``moe.experts_hit``), 3 D F_moe
  parameters each.
* The embedding rows gathered: D a token.
* The caches at the window's kept (query, key) pairs in every attention
  layer (the cache's type): GQA's K and V, 2 H_kv head_dim a position;
  MLA's latent and RoPE key, kv_rank + rope_dim.
* A Mamba layer's float32 states, read and written a token: d_inner x
  (d_state + d_conv - 1).

A layer kind not counted here (``work.MIXERS``, ``work.FFNS``) is counted
by its configuration's reference module: ``KINDS[kind]``'s ``dense_params``
and ``window_bytes``.

Nothing the program reads beyond that counts: padded expert rows, experts
with no token, cache slots past the fill, intermediates.
"""

from __future__ import annotations

from portbench.readers import ELEM_BYTES
from portbench.work import FFNS, added

#: the port keeps recurrent states in float32 whatever the cache's type
STATE_BYTES = 4


def dense_params(m: dict, kinds=None) -> int:
    """Parameters every decode step reads whole (routed experts aside);
    ``kinds`` counts the kinds not counted here."""
    d = m["d_model"]
    total = d * m["vocab"] + d                    # LM head, final norm
    for mixer, ffn in m["layers"]:
        total += d                                # norm1
        if mixer == "gqa":
            hd = m["head_dim"]
            total += 2 * d * m["n_heads"] * hd + 2 * d * m["n_kv_heads"] * hd
        elif mixer == "mla":
            h, dn, dr, dv = m["n_heads"], m["mla_nope_dim"], m["mla_rope_dim"], m["mla_v_dim"]
            rq, rkv = m["mla_q_rank"], m["mla_kv_rank"]
            total += d * rq + rq * h * (dn + dr) + d * (rkv + dr) + rkv * h * (dn + dv) + h * dv * d
        elif mixer == "mamba":
            di, rk, n = m["mamba_d_inner"], m["mamba_dt_rank"], m["mamba_d_state"]
            total += d * 2 * di + m["mamba_d_conv"] * di + di * (rk + 2 * n) + rk * di \
                + di * n + di + di * d
        else:
            total += added(kinds, mixer, "dense_params")(m)
        if ffn != "none":
            total += d                            # norm2
        if ffn == "swiglu":
            total += 3 * d * m["d_ff"]
        elif ffn == "moe":
            total += d * m["moe_experts"] + 3 * d * m["moe_d_ff"] * m["moe_shared"]
        elif ffn != "none":
            total += added(kinds, ffn, "dense_params")(m)
    return total


def window_bytes(m: dict, traffic: dict, steps: int, tokens: int, pairs: int,
                 experts_hit: int, kinds=None) -> int:
    """Bytes of ``steps`` decode steps over ``tokens`` tokens whose queries
    kept ``pairs`` (query, key) pairs a layer, with ``experts_hit`` experts
    hit over all steps and MoE layers; ``kinds`` counts the kinds not
    counted here."""
    pb = ELEM_BYTES[traffic["params_dtype"]]
    cb = ELEM_BYTES[traffic["cache_dtype"]]
    d = m["d_model"]
    expert = 3 * d * m["moe_d_ff"] if any(f == "moe" for _, f in m["layers"]) else 0
    total = (steps * dense_params(m, kinds) + experts_hit * expert + tokens * d) * pb
    for mixer, ffn in m["layers"]:
        if mixer == "gqa":
            total += pairs * 2 * m["n_kv_heads"] * m["head_dim"] * cb
        elif mixer == "mla":
            total += pairs * (m["mla_kv_rank"] + m["mla_rope_dim"]) * cb
        elif mixer == "mamba":
            di = m["mamba_d_inner"]
            total += tokens * 2 * di * (m["mamba_d_state"] + m["mamba_d_conv"] - 1) * STATE_BYTES
        else:
            total += added(kinds, mixer, "window_bytes")(m, tokens, pairs, cb)
        if ffn not in FFNS:
            total += added(kinds, ffn, "window_bytes")(m, tokens, pairs, cb)
    return total
