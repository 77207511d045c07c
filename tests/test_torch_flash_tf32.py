"""The arithmetic of K6's float32 body (3xTF32 on the tensor cores),
emulated on the CPU and held to ``ATTN_TOL`` against the port's and the JAX
reference's plain attention.

The body splits every float32 operand x into hi = x rounded to TF32 (10
mantissa bits, ties away from zero: ``cvt.rna.tf32.f32``) and lo = x - hi
rounded again, and forms each product as a_lo b_hi + a_hi b_lo + a_hi b_hi.
The emulation does the same in float32 torch code: the scores of one
64-key tile, the online softmax in log2 units over the tiles, P split as
the A operand, and each tile's P V summed in a fresh accumulator and added
to the running output after the rescale.  TF32 products are exact in
float32 (two 11-bit significands), so what is left to the card is the
order and rounding of the sums, which the card tests check against the
same tolerance.  One pass of TF32 (hi b_hi only) is printed beside it as a
reading, not an assertion: it is why the split is there.

Shapes: qwen2-1.5b's train call (8, 12, 256, 128) / (8, 2, 256, 128), cut
to 2 query heads over 1 KV head, at D = 64, 96 and 128; inputs from numpy
with a seed.  The JAX reference's ``attention_ref`` runs on the CPU.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import ref as tref

TILE = 64   # keys per kv tile of the body


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, ties away
    from zero (add half of the dropped 13 bits' unit to the magnitude and
    clear them; finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` with TF32 operands: 3 passes (the body's 3xTF32: the two
    small products, then the large one) or 1 (plain TF32)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if passes == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def tf32_attention(q, k, v, *, causal=True, window=0, passes=3) -> torch.Tensor:
    """The float32 body's arithmetic: (B, Hq, Sq, D) x (B, Hkv, Skv, D)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kx = k.repeat_interleave(hq // hkv, dim=1)
    vx = v.repeat_interleave(hq // hkv, dim=1)
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    qi = torch.arange(sq)[:, None]
    m = torch.full((b, hq, sq, 1), -math.inf)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, skv, TILE):
        kj = torch.arange(k0, min(k0 + TILE, skv))[None, :]
        keep = torch.ones((sq, kj.shape[1]), dtype=torch.bool)
        if causal:
            keep &= qi >= kj
        if window > 0:
            keep &= qi - kj < window
        s = product(q, kx[:, :, k0:k0 + TILE].transpose(2, 3), passes)
        s = torch.where(keep, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        m_safe = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_safe)
        p = torch.exp2(s * scale_log2 - m_safe)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = product(p, vx[:, :, k0:k0 + TILE], passes)   # a fresh accumulator
        acc = acc * alpha + pv
        m = m_new
    return acc / torch.where(l == 0, 1.0, l)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0**-10                       # representable in TF32
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, one + 2.0**-11,
                      1.0 + 2.0**-11 - 2.0**-23])
    assert tf32_rna(x).tolist() == [one, -one, 1.0, 1.0 + 2.0**-9, 1.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    hi, lo = split(y)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all() and (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((y - (hi + lo)).abs() <= 2.0**-22 * y.abs()).all()


@pytest.mark.parametrize("d", [64, 96, 128])
def test_3xtf32_attention_holds_attn_tol(d):
    rng = np.random.default_rng(d)
    # qwen2-1.5b's train call cut to 2 query heads over 1 KV head
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((8, 2, 256, d), (8, 1, 256, d), (8, 1, 256, d)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = tf32_attention(tq, tk, tv)
    plain = tref.attention_ref(tq, tk, tv, causal=True)
    reference = torch.from_numpy(np.array(rref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)))
    ratio = tref.attention_excess(out, plain)
    ratio_jax = tref.attention_excess(out, reference)
    one_pass = tref.attention_excess(tf32_attention(tq, tk, tv, passes=1), plain)
    print(f"D={d}: 3xTF32 {ratio:.4f} of ATTN_TOL against ref.attention_ref, "
          f"{ratio_jax:.4f} against the JAX reference; one TF32 pass {one_pass:.2f}")
    assert out.shape == tq.shape and torch.isfinite(out).all()
    assert ratio <= 1.0 and ratio_jax <= 1.0


@pytest.mark.parametrize("window,causal", [(24, True), (0, False)])
def test_3xtf32_attention_holds_attn_tol_under_other_masks(window, causal):
    """A window narrower than a tile, and no mask, at ragged lengths."""
    rng = np.random.default_rng(window + 1)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, 150, 128), (2, 2, 200, 128), (2, 2, 200, 128)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = tf32_attention(tq, tk, tv, causal=causal, window=window)
    reference = torch.from_numpy(np.array(rref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window)))
    assert tref.attention_excess(out, reference) <= 1.0
