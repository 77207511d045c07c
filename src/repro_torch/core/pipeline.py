"""BEYOND-PAPER: the paper's SDFG/Max-Plus machinery applied to pipeline-
parallel transformer execution across H100s joined by NVLink.

Mapping (paper concept -> LM concept):
  cluster/actor        -> pipeline stage (contiguous layer group)
  crossbar capacity    -> per-device HBM budget (Alg.-1-style bin packing)
  spikes per channel   -> activation bytes per microbatch
  AER link bandwidth   -> NVLink bandwidth, one direction
  buffer back-edges    -> bounded in-flight microbatches (pipeline depth)
  TDMA static order    -> 1F1B / GPipe stage schedules
  1/MCM                -> steady-state microbatch throughput

This gives closed-form throughput/bubble analysis for any of the
architectures at any stage count, cross-checked against the standard
pipeline formula ``(M + S - 1) / M`` in tests.  The port's copy of
``repro.core.pipeline``: the same model with the device constants of an
H100 in place of the reference's TPU ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import ArchConfig
from .maxplus import mcr_howard
from .sdfg import SDFG, Channel

# Device constants of the model, from NVIDIA's H100 Tensor Core GPU
# datasheet (SXM5 part); they are not measurements.
#: dense bf16 tensor-core peak, FLOP/s
PEAK_FLOPS = 989e12
#: NVLink 4 is 900 GB/s per GPU counting both directions; a stage-to-stage
#: activation (or its gradient) moves one way, so the channel takes the
#: 450 GB/s of one direction
LINK_BW = 450e9
#: HBM3 per GPU, bytes: the default per-stage memory budget
HBM_BYTES = 80e9


@dataclasses.dataclass(frozen=True)
class StagePlan:
    boundaries: tuple            # layer index ranges per stage
    stage_flops: tuple           # per-microbatch forward flops per stage
    stage_bytes: tuple           # parameter bytes per stage
    act_bytes: int               # activation bytes crossing a boundary


def layer_costs(cfg: ArchConfig, *, micro_tokens: int) -> tuple[list, list]:
    """Per-layer (flops, param_bytes) for one microbatch forward pass."""
    flops, pbytes = [], []
    d = cfg.d_model
    for repeat, specs in cfg.stacks:
        for _ in range(repeat):
            for spec in specs:
                p = 0
                if spec.mixer == "gqa":
                    p += d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                    p += cfg.n_heads * cfg.head_dim * d
                elif spec.mixer == "mla":
                    p += d * cfg.mla_q_rank + cfg.mla_q_rank * cfg.n_heads * (
                        cfg.mla_nope_dim + cfg.mla_rope_dim
                    )
                    p += d * (cfg.mla_kv_rank + cfg.mla_rope_dim)
                    p += cfg.mla_kv_rank * cfg.n_heads * (
                        cfg.mla_nope_dim + cfg.mla_v_dim
                    )
                    p += cfg.n_heads * cfg.mla_v_dim * d
                elif spec.mixer == "mamba":
                    di = cfg.mamba_d_inner
                    p += d * 2 * di + di * (cfg.mamba_dt_rank + 2 * cfg.mamba_d_state)
                    p += cfg.mamba_dt_rank * di + di * d
                elif spec.mixer in ("mlstm", "slstm"):
                    di = cfg.xlstm_d_inner
                    p += d * 4 * di + di * d
                if spec.ffn == "swiglu":
                    p += 3 * d * cfg.d_ff
                elif spec.ffn == "gelu":
                    p += 2 * d * cfg.d_ff
                elif spec.ffn == "moe":
                    # active params only for compute; full bytes for memory
                    p += 3 * d * cfg.moe_d_ff * cfg.moe_experts
                active = p
                if spec.ffn == "moe":
                    active = p - 3 * d * cfg.moe_d_ff * (
                        cfg.moe_experts - cfg.moe_top_k - cfg.moe_shared
                    )
                flops.append(2.0 * active * micro_tokens)
                pbytes.append(2 * p)  # bf16
    return flops, pbytes


def plan_stages(cfg: ArchConfig, n_stages: int, *, micro_tokens: int,
                micro_batch: int = 1) -> StagePlan:
    """Greedy balanced partition of layers into stages (Alg.-1 spirit:
    pack layers into bins under a balance objective)."""
    flops, pbytes = layer_costs(cfg, micro_tokens=micro_tokens)
    total = sum(flops)
    target = total / n_stages
    bounds, acc, start = [], 0.0, 0
    for i, f in enumerate(flops):
        acc += f
        if acc >= target and len(bounds) < n_stages - 1:
            bounds.append((start, i + 1))
            start, acc = i + 1, 0.0
    bounds.append((start, len(flops)))
    stage_flops = tuple(sum(flops[a:b]) for a, b in bounds)
    stage_bytes = tuple(sum(pbytes[a:b]) for a, b in bounds)
    act_bytes = micro_tokens * cfg.d_model * 2
    return StagePlan(tuple(bounds), stage_flops, stage_bytes, act_bytes)


def pipeline_sdfg(plan: StagePlan, *, n_microbatches: int,
                  in_flight: int = 1, bwd_ratio: float = 2.0) -> SDFG:
    """SDFG of a 1F1B-style pipeline (fwd+bwd actor per stage).

    Actors 0..S-1 are forwards, S..2S-1 are backwards (reverse order).
    ``in_flight`` bounds stage-to-stage buffered microbatches (back-edges),
    which is exactly the paper's buffer modeling; the TDMA order on a
    "tile" (device) is (fwd_s, bwd_s) alternation — 1F1B.
    """
    s = len(plan.stage_flops)
    tau = [f / PEAK_FLOPS for f in plan.stage_flops]
    tau += [bwd_ratio * f / PEAK_FLOPS for f in reversed(plan.stage_flops)]
    comm = plan.act_bytes / LINK_BW

    channels = [Channel(i, i, 1, 1.0, kind="self") for i in range(2 * s)]
    # forward chain 0 -> 1 -> ... -> s-1
    for i in range(s - 1):
        channels.append(Channel(i, i + 1, 0, 1.0, delay=comm))
        channels.append(Channel(i + 1, i, in_flight, 1.0, kind="buffer"))
    # fwd s-1 feeds bwd of stage s-1 (actor s)
    channels.append(Channel(s - 1, s, 0, 1.0))
    # backward chain s -> s+1 -> ... -> 2s-1
    for i in range(s, 2 * s - 1):
        channels.append(Channel(i, i + 1, 0, 1.0, delay=comm))
    # device sharing: fwd_i and bwd_(2s-1-i) run on the same device.  In
    # 1F1B stage i holds (s - i) in-flight activations, i.e. its forward
    # may lead its backward by s-i microbatches: that is exactly an order
    # cycle with s-i initial tokens on the bwd->fwd edge (the paper's
    # buffer-as-back-edge modeling, §4.4 step 1).
    for i in range(s):
        b = 2 * s - 1 - i
        channels.append(Channel(i, b, 0, 1.0, kind="order"))
        channels.append(Channel(b, i, s - i, 1.0, kind="order"))
    g = SDFG(n_actors=2 * s, exec_time=np.array(tau), channels=channels,
             name=f"pipeline-{s}stages")
    g.validate()
    return g


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    n_stages: int
    period_s: float              # steady-state per-microbatch period (MCM)
    step_time_s: float           # M microbatches + fill/drain
    bubble_frac: float
    tokens_per_s: float
    hbm_fit: bool


def analyze_pipeline(cfg: ArchConfig, *, n_stages: int, n_microbatches: int,
                     micro_tokens: int, hbm_budget: float = HBM_BYTES,
                     in_flight: int = 1) -> PipelineReport:
    plan = plan_stages(cfg, n_stages, micro_tokens=micro_tokens)
    g = pipeline_sdfg(plan, n_microbatches=n_microbatches, in_flight=in_flight)
    period = mcr_howard(g)
    # fill/drain: pipeline depth x max stage time
    fill = (n_stages - 1) * max(g.exec_time)
    step = n_microbatches * period + 2 * fill
    ideal = n_microbatches * (sum(g.exec_time[: n_stages]) +
                              sum(g.exec_time[n_stages:])) / n_stages
    bubble = 1.0 - ideal / step
    tokens = n_microbatches * micro_tokens / step
    fit = max(plan.stage_bytes) * 3 <= hbm_budget  # params+grads+opt rough
    return PipelineReport(n_stages, period, step, max(bubble, 0.0), tokens, fit)
