"""Kernel wrappers: route by the tensor's device and by nothing else.

A CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`.
A CUDA tensor goes to the hand-written kernel in ``csrc/`` or the call
raises: there is no size threshold below which the plain version takes
over, and no fallback when the library cannot be built or a launch fails.
Each wrapper adds one to :data:`LAUNCHES` where it launches its kernel.
Flash attention, the Mamba scan's four wrappers and the MoE's kept-row
pair also take ``meta`` tensors: they return a ``meta`` output of the
kernel's shape and type (the dry run, ``launch/dryrun.py``), after the
checks the card makes.
A DTensor raises: the models run each rank's shard through
``launch.sharding.local_call``, so a kernel sees its local tensors.

Attention and the Mamba scan are also differentiable.  On inputs that
require a gradient they go through :class:`FlashAttentionFn` and
:class:`MambaScanFn`, on both devices: the forward is the device's (the
kernel on CUDA, the plain version on the CPU), the backward the gradient of
the plain version recomputed under autograd.  The reference has no backward
kernel either: off the TPU it differentiates its plain attention and scan.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor

from .. import obs
from . import _build, ref, work
from .ref import RelaxCSR, SynapseCSR

#: kernel launches per wrapper since the last :func:`reset_launches`:
#: ``obs.LAUNCHES``, the tracing module's always-on ``launches`` family
LAUNCHES = obs.LAUNCHES
LAUNCHES.update({
    "relax_round": 0,
    "relax_round_witness": 0,
    "maxplus_bmm": 0,
    "maxplus_bmv": 0,
    "maxplus_matmul": 0,
    "flash_attention": 0,
    "lif_crossbar_step": 0,
    "mamba_chunk_scan": 0,
    "mamba_chunk_states": 0,
    "mamba_chunk_combine": 0,
    "mamba_scan_route": 0,
    "spike_input": 0,
    "lif_record": 0,
    "moe_gate_up": 0,
    "moe_down": 0,
})

#: probe counts relax_round.cu instantiates: the search's K = 3 and the
#: single-lambda deadlock probe
PROBE_COUNTS = (1, 3)
#: head dims flash_attention.cu instantiates: every GQA config, full or reduced
FLASH_HEAD_DIMS = (64, 96, 128)
#: state sizes mamba_scan.cu instantiates: every Mamba config's 16 and the
#: reference's tests' 8
SCAN_STATES = (8, 16)
#: the scan kernel stages a chunk's B and C (2 * chunk * N float32) in at
#: most 48 KB of shared memory
SCAN_SMEM_BYTES = 48 * 1024


#: observers of each call of the flash attention, Mamba scan and kept-row
#: MoE wrappers (the dry run's counter), innermost last.  The innermost is
#: called as ``hook(name, (nbytes, flops), run)`` on every device, with the
#: call's work from :mod:`.work`, and returns ``run()``, the call's leg.
CHARGE_HOOKS: list = []


def _charged(name: str, work_of, run):
    """``run()``, through the innermost charge hook if there is one
    (``work_of()`` gives the call's work)."""
    if not CHARGE_HOOKS:
        return run()
    return CHARGE_HOOKS[-1](name, work_of(), run)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    if any(isinstance(t, DTensor) for t in ts):
        # a DTensor has no storage a kernel could read, and its plain
        # version would run on DTensor ops: neither is this wrapper's route
        raise TypeError("the kernel wrappers take plain tensors; run a DTensor's shards "
                        "through launch.sharding.local_call")
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}; use a CPU or CUDA tensor")
    return False


def _leg(*ts: torch.Tensor) -> str:
    """The route of a wrapper that also takes ``meta`` tensors: ``"meta"``
    when every operand is a plain ``meta`` tensor, else ``"cpu"`` or
    ``"cuda"`` by :func:`_on_cpu`."""
    if not any(isinstance(t, DTensor) for t in ts) and all(t.is_meta for t in ts):
        return "meta"
    return "cpu" if _on_cpu(*ts) else "cuda"


def _check(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@contextlib.contextmanager
def _launch_on(t: torch.Tensor):
    """Make ``t``'s device the current one for a launch (a kernel launches
    on the current device, and K5 sizes its grid from it); yields the
    stream to launch on."""
    with torch.cuda.device(t.device):
        yield _stream(t)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with cudaError_t {err}")


# ======================================================================
# K1: one relaxation round of the lambda-search
# ======================================================================
def _check_probes(dist: torch.Tensor) -> None:
    if dist.shape[1] not in PROBE_COUNTS:
        raise ValueError(f"relax_round takes {PROBE_COUNTS} probes, got {dist.shape[1]}")


def _relax_launch(dist, lams, csr: RelaxCSR, witness: bool):
    n, k = dist.shape
    if n != csr.n_nodes or lams.shape != (n // csr.n_actors, k):
        raise ValueError(
            f"shape mismatch: dist {tuple(dist.shape)}, lams {tuple(lams.shape)}, "
            f"{csr.n_nodes} nodes of {csr.n_actors} actors"
        )
    for t, dt, name in (
        (dist, torch.float64, "dist"), (lams, torch.float64, "lams"),
        (csr.indptr, torch.int32, "indptr"), (csr.src, torch.int32, "src"),
        (csr.w, torch.float64, "w"), (csr.t, torch.float64, "t"),
    ):
        _check(t, dt, name)
    best = torch.empty_like(dist)
    psrc = torch.empty(dist.shape, dtype=torch.int64, device=dist.device) if witness else None
    if n == 0:
        return best, psrc
    fn = _build.library("relax_round").relax_round
    with _launch_on(dist) as stream:
        err = fn(
            dist.data_ptr(), lams.data_ptr(), csr.indptr.data_ptr(),
            csr.src.data_ptr(), csr.w.data_ptr(), csr.t.data_ptr(),
            best.data_ptr(), psrc.data_ptr() if witness else None,
            n, csr.n_actors, k, int(witness), stream,
        )
    name = "relax_round_witness" if witness else "relax_round"
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return best, psrc


def relax_round(dist: torch.Tensor, lams: torch.Tensor, csr: RelaxCSR) -> torch.Tensor:
    """(n_nodes, K) best candidate per node and probe (see ``ref.segment_relax_ref``)."""
    _check_probes(dist)
    if _on_cpu(dist, lams, csr.src):
        return ref.segment_relax_ref(dist, lams, csr)
    return _relax_launch(dist, lams, csr, witness=False)[0]


def relax_round_witness(
    dist: torch.Tensor, lams: torch.Tensor, csr: RelaxCSR
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(best, psrc)``: :func:`relax_round` plus the largest-src argmax."""
    _check_probes(dist)
    if _on_cpu(dist, lams, csr.src):
        return ref.segment_relax_witness_ref(dist, lams, csr)
    return _relax_launch(dist, lams, csr, witness=True)


# ======================================================================
# K2 / K3: float32 (max,+) products
# ======================================================================
def _bmm_launch(a: torch.Tensor, b: torch.Tensor, name: str) -> torch.Tensor:
    g, m, k = a.shape
    g2, k2, n = b.shape
    if g != g2 or k != k2:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x {tuple(b.shape)}")
    _check(a, torch.float32, "a")
    _check(b, torch.float32, "b")
    c = torch.empty((g, m, n), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    fn = _build.library("maxplus_matmul").maxplus_bmm
    with _launch_on(a) as stream:
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), g, m, n, k, stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return c


def maxplus_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[g] = A[g] (x) B[g] in (max,+), (G,M,K) x (G,K,N) float32."""
    if _on_cpu(a, b):
        return ref.maxplus_bmm_ref(a, b)
    return _bmm_launch(a, b, "maxplus_bmm")


def maxplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A (x) B in (max,+), (M,K) x (K,N) float32: the G = 1 launch of K2
    (whose C entry takes N = 1, the matvec, with K3's body)."""
    if _on_cpu(a, b):
        return ref.maxplus_matmul_ref(a, b)
    return _bmm_launch(a[None], b[None], "maxplus_matmul")[0]


def maxplus_bmv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[g] = A[g] (x) x[g] in (max,+), (G,M,K) x (G,K) float32."""
    if _on_cpu(a, x):
        return ref.maxplus_bmv_ref(a, x)
    g, m, k = a.shape
    if x.shape != (g, k):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x {tuple(x.shape)}")
    _check(a, torch.float32, "a")
    _check(x, torch.float32, "x")
    y = torch.empty((g, m), dtype=torch.float32, device=a.device)
    if y.numel() == 0:
        return y
    fn = _build.library("maxplus_matmul").maxplus_bmv
    with _launch_on(a) as stream:
        err = fn(a.data_ptr(), x.data_ptr(), y.data_ptr(), g, m, k, stream)
    _raise_on(err, "maxplus_bmv")
    LAUNCHES["maxplus_bmv"] += 1
    return y


# ======================================================================
# K6: flash attention
# ======================================================================
def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` when K6 can load it as it lies, else a contiguous copy.  Both
    bodies load 16-byte pieces of rows (the bf16 body by TMA, the float32
    body by cp.async): a 16-byte aligned base and 16-byte multiples as the
    strides of the (b, h, s) dims; a dim of extent 1 is never stepped, so
    its stride does not matter (the bf16 body replaces it)."""
    per_16 = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            st % per_16 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _recompute_grads(ctx, plain, grad_outputs):
    """The gradients of ``plain`` (a tensor or a tuple of them) of the
    inputs ``ctx`` saved, against ``grad_outputs`` (None where an output
    has none), recomputed under autograd; None for an input that needs
    none.  The plain versions compute in float32 whatever their inputs'
    type, so they are recomputed from float32 copies: an input used in
    several places gets its gradient summed in float32 and rounded to its
    own type once."""
    saved = ctx.saved_tensors
    with torch.enable_grad():
        xs = [t.detach().float().requires_grad_(need)
              for t, need in zip(saved, ctx.needs_input_grad)]
        outs = plain(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g.float()) for o, g in zip(outs, grad_outputs) if g is not None]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], [x for x in xs if x.requires_grad],
                                         [g for _, g in pairs]))
    return tuple(next(grads).to(t.dtype) if x.requires_grad else None for t, x in zip(saved, xs))


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` under autograd: the device's forward (K6 on
    CUDA), the backward ``ref.attention_ref``'s gradient recomputed from q,
    k and v.  Use :func:`flash_attention`, which routes here."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = {"causal": causal, "window": window}
        return _flash_forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, d_o):
        grads = _recompute_grads(
            ctx, lambda q, k, v: ref.attention_ref(q, k, v, **ctx.mask), (d_o,))
        return (*grads, None, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """(B,Hq,Sq,D) x (B,Hkv,Skv,D) -> (B,Hq,Sq,D) masked softmax attention
    in q's dtype (see ``ref.attention_ref``).  Sq and Skv may be any length;
    nothing is padded.  Differentiable (:class:`FlashAttentionFn`)."""
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _flash_forward(q, k, v, causal, window)


def _flash_forward(q, k, v, causal, window):
    return _charged("flash_attention", lambda: work.flash_work(q, k, causal=causal, window=window),
                    lambda: _flash_leg(q, k, v, causal, window))


def _flash_leg(q, k, v, causal, window):
    b, hq, sq, d = q.shape
    leg = _leg(q, k, v)
    if leg == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q, k, v of one type, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {FLASH_HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous head dimension")
    if leg == "meta":
        return torch.empty((b, hq, sq, d), dtype=q.dtype, device="meta")
    q, k, v = (_aligned_rows(t) for t in (q, k, v))
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = _build.library("flash_attention").flash_attention
    with _launch_on(q) as stream:
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), b, hq, k.shape[1], sq, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window), stream,
        )
    _raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


# ======================================================================
# K5: fused LIF crossbar step
# ======================================================================
def lif_crossbar_step(
    spikes: torch.Tensor, weights: torch.Tensor, v: torch.Tensor,
    *, leak: float = 0.9, v_th: float = 1.0, v_reset: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One crossbar step: (B, n_in) spikes x (n_in, n_out) weights with
    membrane state (B, n_out) -> ``(out_spikes, v_next)`` (see
    ``ref.lif_crossbar_step_ref``); or a stack of G independent blocks,
    (G, B, n_in) x (G, n_in, n_out) with (G, B, n_out), in one launch.
    The 2-D call is the G = 1 launch.  W is never broadcast over G.  Any
    B, n_in and n_out; nothing is padded."""
    if spikes.dim() not in (2, 3) or not spikes.dim() == weights.dim() == v.dim():
        raise ValueError(
            f"lif_crossbar_step takes 2-D spikes, weights and v or a stack of them, all "
            f"3-D; got {spikes.dim()}-D, {weights.dim()}-D and {v.dim()}-D"
        )
    *lead, b, n_in = spikes.shape
    if (list(weights.shape[:-2]) != lead or weights.shape[-2] != n_in
            or tuple(v.shape) != (*lead, b, weights.shape[-1])):
        raise ValueError(
            f"shape mismatch: spikes {tuple(spikes.shape)}, weights "
            f"{tuple(weights.shape)}, v {tuple(v.shape)}"
        )
    if _on_cpu(spikes, weights, v):
        return ref.lif_crossbar_step_ref(spikes, weights, v, leak=leak, v_th=v_th, v_reset=v_reset)
    for t, name in ((spikes, "spikes"), (weights, "weights"), (v, "v")):
        _check(t, torch.float32, name)
    out_s, out_v = torch.empty_like(v), torch.empty_like(v)
    if out_v.numel() == 0:
        return out_s, out_v
    fn = _build.library("lif_crossbar").lif_crossbar_step
    with _launch_on(v) as stream:
        err = fn(
            spikes.data_ptr(), weights.data_ptr(), v.data_ptr(), out_s.data_ptr(),
            out_v.data_ptr(), lead[0] if lead else 1, b, n_in, weights.shape[-1], leak, v_th,
            v_reset, stream,
        )
    _raise_on(err, "lif_crossbar_step")
    LAUNCHES["lif_crossbar_step"] += 1
    return out_s, out_v


# ======================================================================
# the spike recording: one step's synaptic input, and the whole recording
# ======================================================================
def spike_input(s: torch.Tensor, csr: SynapseCSR) -> torch.Tensor:
    """(n_neurons,) float32 synaptic input ``i[v] = sum of w_e * s[pre_e]``
    over v's incoming synapses in synapse order (see ``ref.spike_input_ref``),
    bit for bit the same on every device and in every run for finite
    weights (the kernel adds only the nonzero products, and skips w where
    s is 0)."""
    if _on_cpu(s, csr.pre, csr.weight):
        return ref.spike_input_ref(s, csr)
    if s.shape != (csr.n_neurons,):
        raise ValueError(f"shape mismatch: s {tuple(s.shape)} for {csr.n_neurons} neurons")
    for t, dt, name in ((s, torch.float32, "s"), (csr.weight, torch.float32, "weight"),
                        (csr.indptr, torch.int32, "indptr"), (csr.pre, torch.int32, "pre")):
        _check(t, dt, name)
    out = torch.empty_like(s)
    if out.numel() == 0:
        return out
    fn = _build.library("spike_input").spike_input
    with _launch_on(s) as stream:
        err = fn(csr.indptr.data_ptr(), csr.pre.data_ptr(), csr.weight.data_ptr(),
                 s.data_ptr(), out.data_ptr(), csr.n_neurons, stream)
    _raise_on(err, "spike_input")
    LAUNCHES["spike_input"] += 1
    return out


def lif_record(
    csr: SynapseCSR, is_input: torch.Tensor, draws: torch.Tensor, params,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole LIF spike recording over ``draws.shape[0]`` steps, ``(counts,
    v, refr)`` (see ``ref.lif_record_ref``), bit for bit the same on every
    device for finite weights; one cooperative launch on the card, which
    raises where the card cannot hold its grid.  ``params`` has
    ``core.lif.LIFParams``' fields, rounded to float32 for the kernel as
    each op of the plain version rounds them."""
    n = csr.n_neurons
    if is_input.shape != (n,) or draws.dim() != 2 or draws.shape[1] != n:
        raise ValueError(f"shape mismatch: is_input {tuple(is_input.shape)}, draws "
                         f"{tuple(draws.shape)} for {n} neurons")
    if _on_cpu(draws, is_input, csr.pre, csr.weight):
        return ref.lif_record_ref(csr, is_input, draws, params)
    for t, dt, name in ((draws, torch.float32, "draws"), (is_input, torch.bool, "is_input"),
                        (csr.weight, torch.float32, "weight"),
                        (csr.indptr, torch.int32, "indptr"), (csr.pre, torch.int32, "pre")):
        _check(t, dt, name)
    n_steps = draws.shape[0]
    # the kernel's prologue zeros the state; the two alternating fired
    # bitmasks of ceil(n/32) words are its scratch
    new = torch.zeros if n == 0 or n_steps == 0 else torch.empty
    counts, v = (new((n,), dtype=torch.float32, device=draws.device) for _ in range(2))
    refr = new((n,), dtype=torch.int32, device=draws.device)
    if n == 0 or n_steps == 0:
        return counts, v, refr
    masks = torch.empty((2 * (-(-n // 32)),), dtype=torch.int32, device=draws.device)
    fn = _build.library("lif_record").lif_record
    with _launch_on(draws) as stream:
        err = fn(csr.indptr.data_ptr(), csr.pre.data_ptr(), csr.weight.data_ptr(),
                 is_input.view(torch.uint8).data_ptr(), draws.data_ptr(), counts.data_ptr(),
                 v.data_ptr(), refr.data_ptr(), masks.data_ptr(), n, int(csr.pre.numel()),
                 n_steps, params.v_threshold, params.v_reset, params.leak,
                 int(params.refractory), params.input_rate, stream)
    _raise_on(err, "lif_record")
    LAUNCHES["lif_record"] += 1
    return counts, v, refr


# ======================================================================
# K7: chunked selective scan
# ======================================================================
def _scan_leg(x, dt, a, b, c, h0, chunk) -> str:
    """The chunk scan's leg (:func:`_leg`), after checking its operands'
    shapes (on every device) and what the kernel takes (on CUDA and meta);
    ``c`` and ``h0`` may be None."""
    bsz, length, d = x.shape
    n = a.shape[1]
    nc = -(-length // chunk)
    if (dt.shape != x.shape or a.shape != (d, n) or b.shape != (bsz, length, n)
            or (c is not None and c.shape != b.shape)
            or (h0 is not None and h0.shape != (bsz, nc, d, n))):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}, c {None if c is None else tuple(c.shape)}, "
            f"h0 {None if h0 is None else tuple(h0.shape)} at chunk {chunk}"
        )
    leg = _leg(*(t for t in (x, dt, a, b, c, h0) if t is not None))
    if leg == "cpu":
        return leg
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mamba_chunk_scan takes float32 or bfloat16 x, got {x.dtype}")
    for t, name in ((x, "x"), (dt, "dt"), (b, "b"), (c, "c")):
        if t is not None:
            _check(t, x.dtype, name)
    _check(a, torch.float32, "a")
    if h0 is not None:
        _check(h0, torch.float32, "h0")
    if n not in SCAN_STATES:
        raise ValueError(f"mamba_chunk_scan takes state sizes {SCAN_STATES}, got {n}")
    if chunk < 1 or 2 * chunk * n * 4 > SCAN_SMEM_BYTES:
        raise ValueError(f"mamba_chunk_scan takes 1 <= chunk <= "
                         f"{SCAN_SMEM_BYTES // (8 * n)} at N = {n}, got {chunk}")
    return leg


def _scan_launch(x, dt, a, b, c, h0, y, h_out, chunk, name):
    """One K7 launch; ``y`` None scans states only (``c`` unused), ``h0``
    None starts every chunk from zero."""
    bsz, length, d = x.shape
    fn = _build.library("mamba_scan").mamba_chunk_scan
    with _launch_on(x) as stream:
        err = fn(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            None if c is None else c.data_ptr(), None if h0 is None else h0.data_ptr(),
            None if y is None else y.data_ptr(), h_out.data_ptr(),
            int(x.dtype == torch.bfloat16), bsz, length, d, a.shape[1], chunk, stream,
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1


def mamba_chunk_scan(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    c: torch.Tensor, h0: torch.Tensor | None, *, chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan every ``chunk`` steps of (B, L, D) x and dt with (D, N) a and
    (B, L, N) b, c from the chunks' initial states h0 (B, ceil(L/chunk),
    D, N), or from zero states where h0 is None (the card reads none) ->
    ``(y, h_final)`` (see ``ref.mamba_chunk_scan_ref``).  L need not be a
    multiple of ``chunk``; nothing is padded."""
    return _charged("mamba_chunk_scan", lambda: work.scan_work(x, a, b, h0, chunk=chunk),
                    lambda: _chunk_scan_leg(x, dt, a, b, c, h0, chunk))


def _chunk_scan_leg(x, dt, a, b, c, h0, chunk):
    bsz, length, d = x.shape
    shape = (bsz, -(-length // chunk), d, a.shape[1])
    leg = _scan_leg(x, dt, a, b, c, h0, chunk)
    if leg == "cpu":
        if h0 is None:
            h0 = torch.zeros(shape, dtype=torch.float32, device=x.device)
        return ref.mamba_chunk_scan_ref(x, dt, a, b, c, h0, chunk=chunk)
    y = torch.empty_like(x)
    h_out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if y.numel() and leg == "cuda":
        _scan_launch(x, dt, a, b, c, h0, y, h_out, chunk, "mamba_chunk_scan")
    return y, h_out


def mamba_chunk_states(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, chunk: int = 128,
) -> torch.Tensor:
    """Every chunk's end state (B, ceil(L/chunk), D, N) float32, each chunk
    scanned from zero: the states of :func:`mamba_chunk_scan` from zero
    states bit for bit, without y (K7's states-only launch on the card)."""
    return _charged("mamba_chunk_states", lambda: work.states_work(x, a, b, chunk=chunk),
                    lambda: _states_leg(x, dt, a, b, chunk))


def _states_leg(x, dt, a, b, chunk):
    bsz, length, d = x.shape
    nc = -(-length // chunk)
    leg = _scan_leg(x, dt, a, b, None, None, chunk)
    if leg == "cpu":
        zeros = torch.zeros((bsz, nc, d, a.shape[1]), dtype=torch.float32, device=x.device)
        return ref.mamba_chunk_scan_ref(x, dt, a, b, b, zeros, chunk=chunk)[1]
    h_out = torch.empty((bsz, nc, d, a.shape[1]), dtype=torch.float32, device=x.device)
    if h_out.numel() and leg == "cuda":
        _scan_launch(x, dt, a, b, None, None, None, h_out, chunk, "mamba_chunk_states")
    return h_out


def mamba_chunk_combine(
    dt: torch.Tensor, a: torch.Tensor, s_local: torch.Tensor, *, chunk: int = 128,
) -> torch.Tensor:
    """Each chunk's initial state (B, nc, D, N) float32 from the chunks'
    end states scanned from zero (see ``ref.mamba_combine_ref``), in one
    launch on the card."""
    bsz, length, d = dt.shape
    n = a.shape[1]
    nc = -(-length // chunk)
    if s_local.shape != (bsz, nc, d, n) or a.shape != (d, n):
        raise ValueError(f"shape mismatch: dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
                         f"s_local {tuple(s_local.shape)} at chunk {chunk}")
    return _charged("mamba_chunk_combine", lambda: work.combine_work(dt, a, s_local),
                    lambda: _combine_leg(dt, a, s_local, chunk))


def _combine_leg(dt, a, s_local, chunk):
    bsz, length, d = dt.shape
    n = a.shape[1]
    leg = _leg(dt, a, s_local)
    if leg == "cpu":
        return ref.mamba_combine_ref(dt, a, s_local, chunk=chunk)
    if dt.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mamba_chunk_combine takes float32 or bfloat16 dt, got {dt.dtype}")
    _check(dt, dt.dtype, "dt")
    _check(a, torch.float32, "a")
    _check(s_local, torch.float32, "s_local")
    h_init = torch.empty_like(s_local)
    if h_init.numel() == 0 or leg == "meta":
        return h_init
    fn = _build.library("mamba_scan").mamba_chunk_combine
    with _launch_on(dt) as stream:
        err = fn(dt.data_ptr(), a.data_ptr(), s_local.data_ptr(), h_init.data_ptr(),
                 int(dt.dtype == torch.bfloat16), bsz, length, d, n, chunk, stream)
    _raise_on(err, "mamba_chunk_combine")
    LAUNCHES["mamba_chunk_combine"] += 1
    return h_init


def mamba_scan_route(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    c: torch.Tensor, *, chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence scan from a zero state, ``(y (B, L, D), h_final
    (B, D, N))``, by the reference's route (each chunk's states from zero,
    the chunk combine, the chunk scan from the combined states: see
    ``ref.mamba_route_ref``) in one launch on the card: a walk over the
    chunks in order that computes each term's decay once and equals the
    three launches (:func:`mamba_chunk_states`, :func:`mamba_chunk_combine`,
    :func:`mamba_chunk_scan`) bit for bit."""
    return _charged("mamba_scan_route", lambda: work.route_work(x, a, b, chunk=chunk),
                    lambda: _route_leg(x, dt, a, b, c, chunk))


def _tma_rows(*ts: torch.Tensor) -> tuple:
    """``ts`` (one shape, last dim W) as TMA loads them, and their row
    stride in elements: each as it lies when its rows and base are 16-byte
    multiples, else copied into rows padded to the next multiple (the
    kernel reads no element past W)."""
    w, size = ts[0].shape[-1], ts[0].element_size()
    ld = -(-w * size // 16) * 16 // size
    out = []
    for t in ts:
        if ld != w or t.data_ptr() % 16:
            padded = torch.empty((*t.shape[:-1], ld), dtype=t.dtype, device=t.device)
            padded[..., :w] = t
            t = padded
        out.append(t)
    return (*out, ld)


def _route_leg(x, dt, a, b, c, chunk):
    bsz, length, d = x.shape
    n = a.shape[1]
    leg = _scan_leg(x, dt, a, b, c, None, chunk)
    if leg == "cpu":
        return ref.mamba_route_ref(x, dt, a, b, c, chunk=chunk)
    y = torch.empty_like(x)
    h_final = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or leg == "meta":
        return y, h_final
    x, dt, ld = _tma_rows(x, dt)
    b, c, _ = _tma_rows(b, c)
    fn = _build.library("mamba_scan").mamba_scan_route
    with _launch_on(x) as stream:
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 y.data_ptr(), h_final.data_ptr(), int(x.dtype == torch.bfloat16), bsz,
                 length, d, ld, n, chunk, stream)
    _raise_on(err, "mamba_scan_route")
    LAUNCHES["mamba_scan_route"] += 1
    return y, h_final


class MambaScanFn(torch.autograd.Function):
    """:func:`mamba_scan` under autograd: the device's forward (the route's
    kernel, or K7 over one chunk, on CUDA), the backward the gradient of the
    plain route ``ref.mamba_route_ref`` recomputed from x, dt, a, b and c.
    Use :func:`mamba_scan`, which routes here."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _mamba_scan_forward(x, dt, a, b, c, chunk)

    @staticmethod
    def backward(ctx, d_y, d_h):
        grads = _recompute_grads(
            ctx, lambda *xs: ref.mamba_route_ref(*xs, chunk=ctx.chunk), (d_y, d_h))
        return (*grads, None)


def mamba_scan(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    c: torch.Tensor, *, chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence S6 scan from a zero state, ``(y (B, L, D),
    h_final (B, D, N))``, by the reference's route: each chunk's end state
    from zero, the chunk combine ``H_init(c) = Decay(c-1) * H_init(c-1) +
    S_local(c-1)``, and the chunk scan from ``H_init``, all three in
    :func:`mamba_scan_route`'s one launch.  A sequence of one chunk is the
    chunk scan from zero states (:func:`mamba_chunk_scan` without h0).  Differentiable
    (:class:`MambaScanFn`)."""
    if _needs_grad(x, dt, a, b, c):
        return MambaScanFn.apply(x, dt, a, b, c, chunk)
    return _mamba_scan_forward(x, dt, a, b, c, chunk)


def _mamba_scan_forward(x, dt, a, b, c, chunk):
    if x.shape[1] > chunk:
        return mamba_scan_route(x, dt, a, b, c, chunk=chunk)
    y, h_fin = mamba_chunk_scan(x, dt, a, b, c, None, chunk=chunk)
    return y, h_fin[:, -1]


# ======================================================================
# the MoE's routed experts on the kept choices' rows
# ======================================================================
def moe_gate_up(x: torch.Tensor, idx: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """(T*k, F) float32 ``silu(x[t] @ w_gate[e]) * (x[t] @ w_up[e])`` at each
    choice c = t*k + j of ``idx`` (T, k) whose expert e = idx[t, j] has
    fewer than ``capacity`` earlier choices in flat order, 0 at every other
    (see ``ref.moe_gate_up_ref``); x (T, D), the weights (E, D, F).  On the
    card only the experts with a kept choice are read."""
    t, d = x.shape
    if (idx.dim() != 2 or idx.shape[0] != t or w_gate.dim() != 3
            or w_gate.shape[1] != d or w_up.shape != w_gate.shape):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, idx {tuple(idx.shape)}, "
                         f"w_gate {tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}")
    return _charged("moe_gate_up", lambda: work.moe_rows_work(x, idx, w_gate, mats=2),
                    lambda: _moe_leg("moe_gate_up", x, idx, {"w_gate": w_gate, "w_up": w_up},
                                     capacity))


def moe_down(h: torch.Tensor, idx: torch.Tensor, w_down: torch.Tensor, *,
             capacity: int) -> torch.Tensor:
    """(T*k, D) float32 ``h[c] @ w_down[e]`` at each kept choice c (as
    :func:`moe_gate_up`'s), 0 at every other (see ``ref.moe_down_ref``); h
    (T*k, F), w_down (E, F, D)."""
    if (h.dim() != 2 or idx.dim() != 2 or h.shape[0] != idx.numel() or w_down.dim() != 3
            or w_down.shape[1] != h.shape[1]):
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, idx {tuple(idx.shape)}, "
                         f"w_down {tuple(w_down.shape)}")
    return _charged("moe_down", lambda: work.moe_rows_work(h, idx, w_down, mats=1),
                    lambda: _moe_leg("moe_down", h, idx, {"w_down": w_down}, capacity))


def _moe_leg(name, src, idx, weights: dict, capacity):
    ws = tuple(weights.values())
    leg = _leg(src, idx, *ws)
    if leg == "cpu":
        plain = ref.moe_gate_up_ref if name == "moe_gate_up" else ref.moe_down_ref
        return plain(src, idx, *ws, capacity=capacity)
    for tname, t in (("x" if name == "moe_gate_up" else "h", src), *weights.items()):
        _check(t, torch.float32, tname)
    if idx.dtype != torch.int64 or idx.stride(1) != 1:
        raise TypeError(f"{name} takes int64 idx with unit column stride, got {idx.dtype} "
                        f"with strides {idx.stride()}")
    n_experts, depth, width = ws[0].shape
    if depth % 4 or width % 4 or any(t.data_ptr() % 16 for t in (src, *ws)):
        raise ValueError(f"{name} takes widths that are multiples of 4 and 16-byte aligned "
                         f"operands, got weights {tuple(ws[0].shape)}")
    if capacity < 1:
        raise ValueError(f"{name} takes a capacity of at least 1, got {capacity}")
    out = torch.empty((idx.numel(), width), dtype=torch.float32, device=src.device)
    if out.numel() == 0 or leg == "meta":
        return out
    t, k = idx.shape
    fn = getattr(_build.library("moe_experts"), name)
    with _launch_on(src) as stream:
        err = fn(src.data_ptr(), idx.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(),
                 t, k, idx.stride(0), n_experts, depth, width, int(capacity), stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out
