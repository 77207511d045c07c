"""LIF simulator, the repo's CARLsim analogue (workflow Fig. 2): the port of
``repro.core.lif``.

Simulates the SNN for ``n_steps`` discrete timesteps with Poisson-encoded
input on layer 0 and leaky-integrate-and-fire dynamics everywhere else, and
records per-neuron spike counts.  Those counts feed the partitioner exactly
like the CARLsim recordings in the paper (§2.4).

The whole recording is ``kernels.ops.lif_record``: one persistent launch
on the card, the plain step loop on the host.  Its synaptic accumulate
(``I[post] += w * s[pre]``) runs over the synapses sorted stably by
``post`` and adds each neuron's synapses in synapse order, so the counts
are the same bit for bit on the card, on the host and from run to run (the
counts feed ``partition_greedy``, whose clustering is bit-identical); the
*clustered* execution path (dense 128x128 crossbar blocks) is K5,
``kernels.ops.lif_crossbar_step``.

The reference draws its Poisson input with ``jax.random``, which PyTorch
cannot reproduce: :func:`_simulate` takes the uniform draws themselves, and
:func:`simulate_spikes` makes them from ``torch.Generator(device)`` seeded
with ``seed``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from ..kernels import ops
from ..kernels.ref import SynapseCSR
from .snn import SNN


@dataclasses.dataclass(frozen=True)
class LIFParams:
    v_threshold: float = 1.0
    v_reset: float = 0.0
    leak: float = 0.9           # membrane decay per step
    refractory: int = 2         # steps
    input_rate: float = 0.08    # Poisson rate per input neuron per step


@torch.no_grad()
def _simulate(
    synapses: SynapseCSR,
    is_input: torch.Tensor,
    draws: torch.Tensor,
    *,
    params: LIFParams,
) -> torch.Tensor:
    """Run LIF dynamics; returns per-neuron spike counts (float32).

    synapses: the destination-sorted float32 synapses; is_input:
    (n_neurons,) bool; draws: (n_steps, n_neurons) uniform [0, 1) float32,
    step t's input neuron i spiking where ``draws[t, i] < input_rate``.
    All on one device.
    """
    return ops.lif_record(synapses, is_input, draws, params)[0]


def simulate_spikes(
    snn: SNN,
    *,
    n_steps: int = 256,
    params: LIFParams = LIFParams(),
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Record per-neuron spike counts for one application iteration
    (float64, host).  ``device=None`` is the card."""
    dev = resolve(device)
    draws = input_draws(snn.n_neurons, n_steps, seed, dev)
    counts = _simulate(*snn_tensors(snn, dev), draws, params=params)
    return counts.cpu().numpy().astype(np.float64)


def input_draws(n_neurons: int, n_steps: int, seed: int, device) -> torch.Tensor:
    """The (n_steps, n_neurons) float32 uniform draws of :func:`simulate_spikes`,
    from ``torch.Generator(device)`` seeded with ``seed``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((n_steps, n_neurons), generator=gen, dtype=torch.float32, device=dev)


def snn_tensors(snn: SNN, device):
    """(synapses, is_input) of ``snn`` on ``device``, as the simulator takes
    them: the synapses sorted stably by their postsynaptic neuron (a CSR
    whose neurons keep their synapses in the SNN's order), with
    excitatory-biased weights ``|w| / 2`` so that activity propagates
    through rate-coded nets, and layer 0 as input."""
    dev = resolve(device)
    synapses = synapse_csr(snn.pre, snn.post, np.abs(snn.weight) * 0.5, snn.n_neurons, dev)
    return synapses, torch.as_tensor(snn.layer_of == 0, device=dev)


def synapse_csr(pre, post, weight, n_neurons: int, device) -> SynapseCSR:
    """The synapses ``(pre, post, weight)`` (numpy, one entry a synapse) as a
    float32 :class:`SynapseCSR` on ``device``, sorted stably by ``post``."""
    order = np.argsort(post, kind="stable")
    post = np.asarray(post, dtype=np.int64)[order]
    indptr = np.zeros(n_neurons + 1, dtype=np.int64)
    np.cumsum(np.bincount(post, minlength=n_neurons), out=indptr[1:])
    return SynapseCSR(
        indptr=torch.as_tensor(indptr, dtype=torch.int32, device=device),
        pre=torch.as_tensor(np.asarray(pre)[order], dtype=torch.int32, device=device),
        weight=torch.as_tensor(np.asarray(weight)[order], dtype=torch.float32, device=device),
        post=torch.as_tensor(post, device=device),
    )


def with_simulated_spikes(snn: SNN, **kw) -> SNN:
    """Return a copy of ``snn`` whose spike counts come from LIF simulation."""
    counts = simulate_spikes(snn, **kw)
    # Guard: the partitioner needs strictly nonnegative rates; keep tiny floor
    # so channels exist wherever synapses exist.
    counts = np.maximum(counts, 1e-3)
    return dataclasses.replace(snn, spikes=counts)
