"""Compile-and-admit path of the port (isolated placement) and the LIF
spike recording of the Fig.-2 workflow."""

from .lif import LIFParams, simulate_spikes, with_simulated_spikes

__all__ = ["LIFParams", "simulate_spikes", "with_simulated_spikes"]
