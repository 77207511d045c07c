"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel in ``csrc/`` computes.  The
(max,+) products round one add per term and the relaxation rounds
``w - lam*t`` and the add separately, while max is exact; the LIF crossbar
step adds its products in increasing k; so on the same inputs kernel and
plain version agree bit for bit; so do the synaptic sum, which adds each
node's synapses in synapse order, and the LIF recording built on it.
Attention sums in another order than its kernel, and the chunk scan's
``exp`` may differ from the kernel's ``expf`` by an ulp (the states-only
pass and the chunk combine compute theirs otherwise too), so those agree
within a stated tolerance.
:mod:`repro_torch.kernels.ops` routes CPU tensors here; ``chip_smoke.py``
holds every kernel against these on the card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

NEG_INF = float("-inf")

#: elements of the broadcast (G, M, chunk, N) intermediate per step
_BMM_CHUNK_ELEMS = 1 << 24
#: query rows per step of the plain attention: bounds the (Sq, Skv) scores
_ATTN_CHUNK = 2048


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """Masked softmax attention with grouped KV heads, in float32.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); query head ``h`` reads KV
    head ``h // (Hq // Hkv)``.  Query ``i`` sees key ``j`` when ``i >= j``
    (``causal``) and ``i - j < window`` (``window > 0``); a row that sees
    no key gives 0.  Scores, softmax and the weighted sum are float32 and
    the result has q's dtype.  Queries go in chunks of 2048 rows, so the
    score tensor stays bounded at long sequence lengths.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    kv_idx = torch.arange(skv, device=q.device)[None, :]
    outs = []
    for start in range(0, sq, _ATTN_CHUNK):
        stop = min(start + _ATTN_CHUNK, sq)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, start:stop].float(), kf) * scale
        q_idx = torch.arange(start, stop, device=q.device)[:, None]
        mask = torch.ones((stop - start, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_idx >= kv_idx
        if window > 0:
            mask &= (q_idx - kv_idx) < window
        # out of place: autograd follows this function (softmax's backward
        # reads its own output); the values are the same
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
        del s
        p = p.masked_fill(torch.isnan(p), 0.0)          # fully masked rows
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vf).to(q.dtype))
        del p
    return torch.cat(outs, dim=3).reshape(b, hq, sq, d)


#: how far a kernel's attention output may lie from :func:`attention_ref`'s,
#: per element: ``rtol`` of the element (one rounding step of the output
#: type, since both round a float32 value once) plus ``row_tol`` of the
#: root mean square of its (b, h, q) row (another float32 summation order,
#: which moves a row of 4096 keys by about 5e-6 of its size).  Row by row,
#: because a long causal row averages many values of v and its outputs
#: shrink with its length.
ATTN_TOL = {torch.float32: (2.0**-20, 2.0**-14), torch.bfloat16: (2.0**-7, 2.0**-14)}


def attention_excess(out: torch.Tensor, plain: torch.Tensor) -> float:
    """The largest ``|out - plain| / (rtol |plain| + row_tol rms(plain row))``
    over the elements, with :data:`ATTN_TOL` of ``plain``'s type; ``out``
    agrees with ``plain`` when it is at most 1."""
    rtol, row_tol = ATTN_TOL[plain.dtype]
    ref_f = plain.float()
    diff = (out.float() - ref_f).abs()
    limit = rtol * ref_f.abs() + row_tol * ref_f.square().mean(dim=-1, keepdim=True).sqrt()
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / limit)
    return float(ratio.max()) if ratio.numel() else 0.0


# ----------------------------------------------------------------------
# (max,+) products
# ----------------------------------------------------------------------
def maxplus_bmm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[g,i,j] = max_k A[g,i,k] + B[g,k,j] for (G,M,K) x (G,K,N).

    The K axis is folded in chunks so the broadcast intermediate stays
    bounded; max is exact, so chunking never changes a bit.
    """
    g, m, k = a.shape
    n = b.shape[2]
    out = torch.full((g, m, n), NEG_INF, dtype=a.dtype, device=a.device)
    step = max(1, _BMM_CHUNK_ELEMS // max(1, g * m * n))
    for k0 in range(0, k, step):
        part = (a[:, :, k0:k0 + step, None] + b[:, None, k0:k0 + step, :]).amax(dim=2)
        torch.maximum(out, part, out=out)
    return out


def maxplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i,j] = max_k A[i,k] + B[k,j] (the G = 1 case of the batched form)."""
    return maxplus_bmm_ref(a[None], b[None])[0]


def maxplus_bmv_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[g,i] = max_k A[g,i,k] + x[g,k] for (G,M,K) x (G,K)."""
    g, m, k = a.shape
    if k == 0:
        return torch.full((g, m), NEG_INF, dtype=a.dtype, device=a.device)
    return (a + x[:, None, :]).amax(dim=2)


# ----------------------------------------------------------------------
# one relaxation round of the lambda-search
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RelaxCSR:
    """A batched EdgeStack as one flat dst-sorted CSR, on one device.

    Node ids are flat: ``row * n_actors + actor``.  Edges are sorted by
    destination; ``indptr[v]:indptr[v+1]`` are node v's incoming edges.
    ``dst``/``dst_row`` repeat what ``indptr`` implies, per edge, for the
    scatter of the plain version.
    """

    n_actors: int
    indptr: torch.Tensor   # (n_nodes + 1,) int32
    src: torch.Tensor      # (E,) int32 flat source node ids
    w: torch.Tensor        # (E,) float64 weights
    t: torch.Tensor        # (E,) float64 tokens
    dst: torch.Tensor      # (E,) int64 flat destination node ids
    dst_row: torch.Tensor  # (E,) int64 stack row of each edge

    @property
    def n_nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1


def _candidates(dist: torch.Tensor, lams: torch.Tensor, csr: RelaxCSR):
    ww = csr.w[:, None] - lams[csr.dst_row] * csr.t[:, None]
    return dist[csr.src.long()] + ww


def segment_relax_ref(
    dist: torch.Tensor, lams: torch.Tensor, csr: RelaxCSR
) -> torch.Tensor:
    """(n_nodes, K) ``best[v,k] = max_e dist[src_e,k] + (w_e - lam[row_v,k]*t_e)``.

    ``-inf`` where v has no incoming edge.  ``dist`` is (n_nodes, K),
    ``lams`` (B, K) per-row probe lambdas.
    """
    cand = _candidates(dist, lams, csr)
    best = torch.full_like(dist, NEG_INF)
    idx = csr.dst[:, None].expand_as(cand)
    return best.scatter_reduce_(0, idx, cand, "amax", include_self=True)


def segment_relax_witness_ref(
    dist: torch.Tensor, lams: torch.Tensor, csr: RelaxCSR
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_relax_ref` plus ``psrc``, an argmax predecessor.

    ``psrc[v,k]`` is the largest source node id among v's incoming edges
    whose candidate equals ``best[v,k]``; -1 where v has no incoming edge.
    """
    cand = _candidates(dist, lams, csr)
    idx = csr.dst[:, None].expand_as(cand)
    best = torch.full_like(dist, NEG_INF).scatter_reduce_(
        0, idx, cand, "amax", include_self=True
    )
    at_max = cand >= best[csr.dst]
    src = csr.src.long()[:, None].expand_as(cand)
    tagged = torch.where(at_max, src, torch.full_like(src, -1))
    psrc = torch.full(dist.shape, -1, dtype=torch.int64, device=dist.device)
    psrc.scatter_reduce_(0, idx, tagged, "amax", include_self=True)
    return best, psrc


# ----------------------------------------------------------------------
# fused LIF crossbar step
# ----------------------------------------------------------------------
def lif_crossbar_step_ref(
    spikes: torch.Tensor, weights: torch.Tensor, v: torch.Tensor,
    *, leak: float = 0.9, v_th: float = 1.0, v_reset: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Crossbar current and LIF update: ``(out_spikes, v_next)``.

    ``i = s @ W`` in float32, accumulated over ``n_in`` in increasing k
    order, one rounded product and one rounded add per k; then
    ``v' = leak*v + i``, ``spike = v' >= v_th``, ``v_next = v_reset`` where
    it spiked and ``v'`` elsewhere.  ``leak``, ``v_th`` and ``v_reset`` are
    float32 constants, as JAX makes a weak-typed Python float.  Spikes come
    back in the spikes' dtype.  The fixed k order is what the CUDA kernel
    repeats, so the two agree bit for bit.  s (..., B, n_in), W (...,
    n_in, n_out) and v (..., B, n_out) may share leading dimensions: a
    stack of blocks, each the same as its own call.
    """
    s = spikes.float()
    w = weights.float()
    acc = torch.zeros(v.shape, dtype=torch.float32, device=s.device)
    for k in range(w.shape[-2]):
        acc = acc + s[..., k, None] * w[..., k, None, :]

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=s.device)

    v_new = f32(leak) * v.float() + acc
    fired = v_new >= f32(v_th)
    out_v = torch.where(fired, f32(v_reset), v_new)
    return fired.to(spikes.dtype), out_v.to(v.dtype)


# ----------------------------------------------------------------------
# the synaptic input of the spike recording
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SynapseCSR:
    """An SNN's synapses sorted by their postsynaptic neuron, on one device.

    The sort is stable, so each neuron's incoming synapses keep their order
    in the synapse list; ``indptr[v]:indptr[v+1]`` are neuron v's.  ``post``
    repeats what ``indptr`` implies, per synapse, for the plain version's
    ``index_add_``.
    """

    indptr: torch.Tensor   # (n_neurons + 1,) int32
    pre: torch.Tensor      # (E,) int32 presynaptic neuron of each synapse
    weight: torch.Tensor   # (E,) float32
    post: torch.Tensor     # (E,) int64, non-decreasing

    @property
    def n_neurons(self) -> int:
        return int(self.indptr.shape[0]) - 1


def spike_input_ref(s: torch.Tensor, csr: SynapseCSR) -> torch.Tensor:
    """(n_neurons,) ``i[v] = sum of weight_e * s[pre_e]`` over v's incoming
    synapses: one rounded product each, added to 0 in synapse order (the
    CPU's ``index_add_`` adds in index order, and the stable sort kept each
    neuron's synapses in the order of the unsorted list, so this is also
    the sum over the unsorted list)."""
    out = torch.zeros(csr.n_neurons, dtype=s.dtype, device=s.device)
    return out.index_add_(0, csr.post, csr.weight * s[csr.pre.long()])


def lif_record_ref(
    csr: SynapseCSR, is_input: torch.Tensor, draws: torch.Tensor, params,
    *, spike_input=spike_input_ref,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The LIF spike recording, ``(counts, v, refr)`` after ``draws.shape[0]``
    steps: float32 spike counts, the last membrane potentials and the last
    int32 refractory counters (see ``core.lif.LIFParams`` for ``params``).

    is_input: (n,) bool; draws: (n_steps, n) uniform float32, input neuron
    i spiking at step t where ``draws[t, i] < input_rate``.  The parameters
    are Python numbers that each op rounds to float32, as the reference's
    weak-typed scalars are.  ``spike_input(s, csr)`` is each step's
    synaptic sum (``chip_smoke.py`` passes ``ops.spike_input``: the step
    loop around the kernel, the recording's route before ``lif_record``)."""
    n_steps, n = draws.shape
    dev, dtype = csr.weight.device, csr.weight.dtype
    v = torch.zeros((n,), dtype=dtype, device=dev)
    refr = torch.zeros((n,), dtype=torch.int32, device=dev)
    counts = torch.zeros((n,), dtype=dtype, device=dev)
    not_input = ~is_input
    for t in range(n_steps):
        in_spike = (draws[t] < params.input_rate) & is_input
        fired = ((v >= params.v_threshold) & (refr <= 0) & not_input) | in_spike
        s = fired.to(dtype)
        i_syn = spike_input(s, csr)
        v = torch.where(fired, params.v_reset, v * params.leak) \
            + torch.where(is_input, 0.0, i_syn)
        refr = torch.where(fired, params.refractory, torch.clamp_min(refr - 1, 0)).to(torch.int32)
        counts += s
    return counts, v, refr


# ----------------------------------------------------------------------
# chunked selective (S6) scan
# ----------------------------------------------------------------------
def mamba_chunk_scan_ref(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    c: torch.Tensor, h0: torch.Tensor, *, chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan every chunk of ``chunk`` steps from its own initial state.

    x, dt: (B, L, D); a: (D, N) float32; b, c: (B, L, N); h0:
    (B, ceil(L/chunk), D, N) float32.  Per step, in float32:
    ``h = exp(dt*a) * h + (dt*x) * b_t`` and ``y_t = sum_n h[:, n] * c_t[n]``
    summed in increasing n.  Returns ``(y, h_final)``: y (B, L, D) in x's
    dtype and each chunk's final state (B, n_chunks, D, N) float32.  Steps
    past L (the last chunk's ragged end) leave the state unchanged, bit for
    bit: a zero-padded step would add +0 to it, which turns a -0 state
    into +0.
    """
    bsz, length, d = x.shape
    n = a.shape[1]
    nc = -(-length // chunk)
    if tuple(h0.shape) != (bsz, nc, d, n):
        raise ValueError(f"h0 must be {(bsz, nc, d, n)}, got {tuple(h0.shape)}")
    pad = nc * chunk - length

    def chunks(t):   # (B, L, W) -> (chunk, B, nc, W) float32, zero past L
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
        return t.reshape(bsz, nc, chunk, t.shape[-1]).permute(2, 0, 1, 3)

    xs, dts, bs, cs = chunks(x), chunks(dt), chunks(b), chunks(c)
    a = a.float()
    h = h0.float().clone()
    ys = []
    for t in range(chunk):
        dt_t = dts[t][..., None]                          # (B, nc, D, 1)
        h_t = torch.exp(dt_t * a) * h + (dts[t] * xs[t])[..., None] * bs[t][:, :, None, :]
        h = h_t if t < chunk - pad else torch.cat([h_t[:, :-1], h[:, -1:]], dim=1)
        prod = h * cs[t][:, :, None, :]
        y = prod[..., 0]
        for k in range(1, n):
            y = y + prod[..., k]
        ys.append(y)
    y = torch.stack(ys, dim=2).reshape(bsz, nc * chunk, d)[:, :length]
    return y.to(x.dtype), h


def mamba_combine_ref(
    dt: torch.Tensor, a: torch.Tensor, s_local: torch.Tensor, *, chunk: int = 128,
) -> torch.Tensor:
    """Each chunk's initial state from the chunks' local end states
    ``s_local`` (B, nc, D, N) float32 (each chunk scanned from zero):
    ``H(0) = 0``, ``H(c) = exp(a * sum of chunk c-1's dt) * H(c-1) +
    s_local(c-1)`` in float32, one ``torch.addcmul`` a chunk: the
    combine of ``repro.kernels.ops.mamba_scan`` (its ``lax.scan``).  dt (B, L, D),
    a (D, N) float32; L need not be a multiple of ``chunk`` (only the
    complete chunks before the last are summed).  Out of place, so that
    autograd can follow it."""
    bsz, length, d = dt.shape
    nc = s_local.shape[1]
    full = (nc - 1) * chunk
    dt_sum = dt[:, :full].reshape(bsz, nc - 1, chunk, d).sum(dim=2, dtype=torch.float32)
    decay = torch.exp(dt_sum[..., None] * a.float())
    states = [torch.zeros_like(s_local[:, 0])]
    for ci in range(1, nc):
        states.append(torch.addcmul(s_local[:, ci - 1], decay[:, ci - 1], states[-1]))
    return torch.stack(states, dim=1)


def mamba_route_ref(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    c: torch.Tensor, *, chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``ops.mamba_scan``'s route, ``(y, h_final (B,
    D, N))`` from a zero state: each chunk's end state from zero, the
    combine, and the chunk scan from the combined states (one chunk: the
    scan from zero alone)."""
    bsz, length, d = x.shape
    h_init = torch.zeros((bsz, -(-length // chunk), d, a.shape[1]), dtype=torch.float32,
                         device=x.device)
    if length > chunk:
        s_local = mamba_chunk_scan_ref(x, dt, a, b, b, h_init, chunk=chunk)[1]
        h_init = mamba_combine_ref(dt, a, s_local, chunk=chunk)
    y, h = mamba_chunk_scan_ref(x, dt, a, b, c, h_init, chunk=chunk)
    return y, h[:, -1]


def mamba_scan_ref(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    c: torch.Tensor, h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential S6 scan over the whole sequence, the oracle of the
    chunked form: ``(y (B, L, D) in x's dtype, h_final (B, D, N) float32)``
    from ``h0`` (zeros when None)."""
    bsz, length, d = x.shape
    a = a.float()
    h = (torch.zeros((bsz, d, a.shape[1]), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(length):
        dt_t = dt[:, t].float()
        h = torch.exp(dt_t[..., None] * a) * h + (dt_t * x[:, t].float())[..., None] \
            * b[:, t, None, :].float()
        ys.append((h * c[:, t, None, :].float()).sum(dim=-1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((bsz, 0, d), device=x.device)
    return y.to(x.dtype), h


#: how far a kernel's scan output may lie from :func:`mamba_chunk_scan_ref`'s,
#: per element: ``rtol`` of the element (one rounding of the output type:
#: the kernel's ``expf`` and the plain version's ``torch.exp`` may differ
#: by an ulp, and a float32 difference that small can flip the rounding to
#: bf16) plus ``row_tol`` of the root mean square of its (b, chunk,
#: channel) row (an ulp of a decay carried through the chunk's 128 steps
#: moves the state by about 128 * 2^-24 of its size, about 2^-17).  The
#: float32 limits also hold the states (:func:`state_excess`), and with
#: them the combine's summed dt.
SCAN_TOL = {torch.float32: (2.0**-20, 2.0**-14), torch.bfloat16: (2.0**-7, 2.0**-14)}


def scan_excess(out: torch.Tensor, plain: torch.Tensor, chunk: int) -> float:
    """The largest ``|out - plain| / (rtol |plain| + row_tol rms(row))`` over
    the elements of a (B, L, D) scan output, rows being the ``chunk`` steps
    of one (b, chunk, channel), with :data:`SCAN_TOL` of ``plain``'s type;
    at most 1 means ``out`` agrees with ``plain``."""
    rtol, row_tol = SCAN_TOL[plain.dtype]
    bsz, length, d = plain.shape
    nc = -(-length // chunk)
    ref_f = plain.float()
    sq = torch.nn.functional.pad(ref_f.square(), (0, 0, 0, nc * chunk - length))
    counts = torch.full((nc,), float(chunk), device=plain.device)
    counts[-1] = length - (nc - 1) * chunk
    rms = (sq.reshape(bsz, nc, chunk, d).sum(dim=2) / counts[None, :, None]).sqrt()
    rms = rms.repeat_interleave(chunk, dim=1)[:, :length]
    diff = (out.float() - ref_f).abs()
    limit = rtol * ref_f.abs() + row_tol * rms
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / limit)
    return float(ratio.max()) if ratio.numel() else 0.0


#: how far a whole model's gradients on the card may lie from the host's,
#: in units of :data:`ATTN_TOL` (equal to :data:`SCAN_TOL`) with the whole
#: leaf as the row: the forward's differences (K6 or the scan route against
#: the plain versions, the card's matmuls against the host's) are carried
#: through a few layers and back
TRAIN_GRAD_SCALE = 2.0**4


def grad_excess(out: torch.Tensor, plain: torch.Tensor, scale: float = 1.0) -> float:
    """The largest ``|out - plain| / (scale (rtol |plain| + row_tol rms))``
    over a gradient leaf, ``rms`` that of the whole leaf, with
    :data:`ATTN_TOL` of ``plain``'s type; at most 1 means ``out`` agrees
    with ``plain``."""
    rtol, row_tol = ATTN_TOL[plain.dtype]
    ref_f = plain.float()
    diff = (out.float() - ref_f).abs()
    limit = scale * (rtol * ref_f.abs() + row_tol * ref_f.square().mean().sqrt())
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / limit)
    return float(ratio.max()) if ratio.numel() else 0.0


def state_excess(out: torch.Tensor, plain: torch.Tensor) -> float:
    """The largest ``|out - plain| / (rtol |plain| + row_tol rms(row))`` over
    the elements of float32 scan states (..., N), rows being the N states
    of one channel, with :data:`SCAN_TOL`'s float32 limits; at most 1 means
    ``out`` agrees with ``plain``."""
    rtol, row_tol = SCAN_TOL[torch.float32]
    diff = (out - plain).abs()
    limit = rtol * plain.abs() + row_tol * plain.square().mean(dim=-1, keepdim=True).sqrt()
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / limit)
    return float(ratio.max()) if ratio.numel() else 0.0
