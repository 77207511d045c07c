"""K7, the Mamba chunk scan, on the CPU: the one-chunk scan from zero states
against the JAX reference, the lane schedule of the card's body modelled
in numpy float32, and K7's work with no h0.

* ``ops.mamba_scan`` over at most one chunk (K7 from zero states, no h0
  passed) against the reference's ``ops.mamba_scan`` (its Pallas chunk scan
  in interpret mode) at 1, 7 and ``chunk`` steps: float32, 1e-5 absolute on
  outputs of size up to about 7 (XLA's exp and sum over n may round
  otherwise), and ``ref.scan_excess``/``ref.state_excess`` <= 1.
* The card's body (``csrc/mamba_scan.cu``) gives a channel's N states to
  N / G adjacent lanes, G states each; lane g walks step t at iteration
  t + g and adds its G products to the partial y sum lane g - 1 passed on.
  A numpy float32 model of that schedule, with each product and add
  rounded alone, equals ``ref.mamba_chunk_scan_ref`` bit for bit.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as rops

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import work

from test_torch_lm import _np, _t

F32 = np.float32
SCAN_ATOL = 1e-5


def _inputs(B, L, D, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, D)).astype(F32),
            (0.01 + 0.1 * rng.random((B, L, D))).astype(F32),
            (-np.exp(rng.normal(size=(D, N)))).astype(F32),
            rng.normal(size=(B, L, N)).astype(F32),
            rng.normal(size=(B, L, N)).astype(F32))


@pytest.mark.parametrize("B,L,N", [(1, 1, 8), (2, 7, 16), (3, 16, 8), (1, 16, 16), (2, 1, 16)])
def test_one_chunk_scan_from_zero_matches_the_reference(B, L, N):
    D, chunk = 64, 16
    inputs = _inputs(B, L, D, N, 11 * L + N + B)
    y, h = tops.mamba_scan(*map(_t, inputs), chunk=chunk)
    assert y.shape == (B, L, D) and h.shape == (B, D, N) and h.dtype == torch.float32
    ry, rh = (np.asarray(t) for t in rops.mamba_scan(*inputs, chunk=chunk, interpret=True))
    np.testing.assert_allclose(_np(y), ry, atol=SCAN_ATOL)
    np.testing.assert_allclose(_np(h), rh, atol=SCAN_ATOL)
    assert tref.scan_excess(y, _t(ry), chunk) <= 1.0
    assert tref.state_excess(h, _t(rh)) <= 1.0
    # no h0 is the chunk scan from zero states, bit for bit
    ky, kh = tops.mamba_chunk_scan(*map(_t, inputs), None, chunk=chunk)
    zy, zh = tref.mamba_chunk_scan_ref(*map(_t, inputs), torch.zeros((B, 1, D, N)), chunk=chunk)
    assert torch.equal(ky, zy) and torch.equal(kh, zh)
    assert torch.equal(y, zy) and torch.equal(h, zh[:, -1])


def _lane_model(x, dt, a, b, c, h0, chunk, G):
    """The card's schedule in numpy float32: per chunk and channel, lane g
    of N / G holds states [gG, gG + G) and walks step t at iteration t + g;
    its partial y sum of step t starts from lane g - 1's (from -0 at lane
    0) and takes its G products in increasing n.  The decays are the plain
    version's own ``torch.exp`` of the same float32 products."""
    bsz, length, d = x.shape
    n = a.shape[1]
    k = n // G
    nc = -(-length // chunk)
    y = np.zeros((bsz, length, d), F32)
    h_out = np.zeros((bsz, nc, d, n), F32)
    for ci in range(nc):
        t0 = ci * chunk
        steps = min(chunk, length - t0)
        h = h0[:, ci].copy()                                  # (B, D, N)
        carry = np.zeros((k, bsz, d), F32)
        for i in range(steps + k - 1):
            passed = carry.copy()                             # last iteration's sums
            for g in range(k):
                t = i - g
                if not 0 <= t < steps:
                    continue
                row = t0 + t
                sl = slice(g * G, (g + 1) * G)
                decay = torch.exp(_t(dt[:, row, :, None]) * _t(a)).numpy()[..., sl]
                dtx = dt[:, row] * x[:, row]                  # (B, D)
                acc = np.full((bsz, d), -0.0, F32) if g == 0 else passed[g - 1]
                for m in range(G):
                    s = g * G + m
                    h[..., s] = decay[..., m] * h[..., s] + dtx * b[:, row, None, s]
                    acc = acc + h[..., s] * c[:, row, None, s]
                carry[g] = acc
                if g == k - 1:
                    y[:, row] = acc
        h_out[:, ci] = h
    return y, h_out


LANE_CASES = [(G, *case) for case in [(2, 13, 5, 16, 16), (1, 40, 3, 8, 16), (2, 1, 4, 16, 16)]
              for G in (2, 4, 8, 16) if case[3] % G == 0]


@pytest.mark.parametrize("G,B,L,D,N,chunk", LANE_CASES)
def test_lane_lagged_sum_equals_the_plain_version_bit_for_bit(G, B, L, D, N, chunk):
    x, dt, a, b, c = _inputs(B, L, D, N, L * D + G)
    x[:, ::3, 1] = -0.0                     # -0 in x
    a[::2, 1] = -1e4                        # decays that underflow
    h0 = np.random.default_rng(G).normal(size=(B, -(-L // chunk), D, N)).astype(F32)
    my, mh = _lane_model(x, dt, a, b, c, h0, chunk, G)
    py, ph = tref.mamba_chunk_scan_ref(*map(_t, (x, dt, a, b, c, h0)), chunk=chunk)
    assert np.array_equal(my.view(np.int32), py.numpy().view(np.int32))
    assert np.array_equal(mh.view(np.int32), ph.numpy().view(np.int32))


def test_scan_work_without_h0_reads_no_states():
    """K7's bytes and operations by hand: x, dt and y; B and C; a; h_out
    and, when given, h0."""
    x, a, b = torch.empty((8, 32, 8192)), torch.empty((8192, 16)), torch.empty((8, 32, 16))
    h_out = 8 * 1 * 8192 * 16 * 4
    io = 3 * 8 * 32 * 8192 * 4 + 2 * 8 * 32 * 16 * 4 + 8192 * 16 * 4
    assert work.scan_work(x, a, b, None, chunk=128) == (
        io + h_out, 7 * 8 * 32 * 8192 * 16 + 8 * 32 * 8192)
    assert work.scan_work(x, a, b, torch.empty((8, 1, 8192, 16)), chunk=128)[0] \
        == io + 2 * h_out
    # bf16, ragged chunks: 3 chunks of the 70 steps at 32
    x, b = torch.empty((2, 70, 8), dtype=torch.bfloat16), torch.empty((2, 70, 16))
    assert work.scan_work(x, torch.empty((8, 16)), b.bfloat16(), None, chunk=32)[0] \
        == (3 * 2 * 70 * 8 + 2 * 2 * 70 * 16) * 2 + 8 * 16 * 4 + 2 * 3 * 8 * 16 * 4


def test_one_chunk_scan_charges_no_h0_and_passes_meta_shapes():
    """The dry run's charge of a one-chunk ``mamba_scan`` is K7's work from
    zero states, and a meta call returns the kernel's shapes."""
    B, L, D, N, chunk = 2, 20, 8, 16, 32
    x = torch.empty((B, L, D), dtype=torch.bfloat16, device="meta")
    a = torch.empty((D, N), device="meta")
    b = torch.empty((B, L, N), dtype=torch.bfloat16, device="meta")
    charged = []

    def hook(name, cost, run):
        charged.append((name, cost))
        return run()

    tops.CHARGE_HOOKS.append(hook)
    try:
        y, h = tops.mamba_scan(x, x, a, b, b, chunk=chunk)
    finally:
        tops.CHARGE_HOOKS.remove(hook)
    assert (y.shape, y.dtype, h.shape) == ((B, L, D), torch.bfloat16, (B, D, N))
    assert charged == [("mamba_chunk_scan", work.scan_work(x, a, b, None, chunk=chunk))]
    assert charged[0][1][0] == (3 * B * L * D + 2 * B * L * N) * 2 + D * N * 4 + B * D * N * 4


def test_plain_scan_leaves_a_negative_zero_state_past_l():
    """A state the last real step leaves at -0 (its decay underflows to 0,
    x is -0) keeps its bits over a ragged chunk's steps past L, as the
    kernel, which stops at L, leaves it; a zero-padded step would add +0."""
    x = torch.tensor([[[-0.0, 1.0]]])                # (1, 1, 2): one step
    dt = torch.full((1, 1, 2), 0.05)
    a = torch.full((2, 3), -1e4)
    b = torch.ones((1, 1, 3))
    h0 = -torch.ones((1, 1, 2, 3))
    y, h = tref.mamba_chunk_scan_ref(x, dt, a, b, b, h0, chunk=4)
    assert h[0, 0, 0].view(torch.int32).tolist() == [-2**31] * 3       # -0
    assert torch.equal(h[0, 0, 1], torch.full((3,), 0.05))
    # the model of the card's schedule stops at L too
    my, mh = _lane_model(*(t.numpy() for t in (x, dt, a, b, b, h0)), 4, 1)
    assert np.array_equal(mh.view(np.int32), h.numpy().view(np.int32))
    assert np.array_equal(my.view(np.int32), y.numpy().view(np.int32))
