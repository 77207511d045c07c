"""Core of the port: SNN compilation to neuromorphic hardware on PyTorch.

Pipeline (paper Fig. 2), as in the JAX reference's ``repro.core``:
  SNN (apps.py / snn.py)
    -> spike recording (lif.py; or calibrated counts)
    -> crossbar-aware clustering (partition.py, Alg. 1)
    -> SDFG (sdfg.py) + Max-Plus analysis (maxplus.py, Eq. 6)
    -> binding (binding.py, Eq. 7) + static-order scheduling (schedule.py)
    -> run-time admission via self-timed execution (runtime.py, Lemma 1),
       joint and region placement, the fault runtime, and the serving
       queue (serving.py) over synthetic tenants (workloads.py)

Every name of the reference's public API is exported here;
:data:`NOT_PORTED` (now empty) would map one the port did not have to its
item of ``ROADMAP.md`` queue 1.  ``export`` and ``pipeline`` are
submodules, as in the reference.
"""

from .apps import APP_NAMES, APP_SPECS, all_apps, build_app, small_app
from .binding import (
    BindingResult,
    LoadWeights,
    bind_ours,
    bind_pycarl,
    bind_spinemap,
    cut_spikes,
    cut_spikes_batch,
)
from .engine import (
    ChipMetrics,
    CompileCacheStats,
    EngineReport,
    OrderBatch,
    PreparedExec,
    batch_execute,
    batch_execute_fused,
    batch_throughputs,
    compile_cache_stats,
    finish_execution,
    fuse_stacks,
    order_cycle_lower_bounds,
    pad_stack_to_buckets,
    prepare_execution,
    project_order_batch,
    record_cache_stats,
    reset_compile_cache_stats,
    stack_hardware_aware,
    union_component_periods,
    weak_components,
)
from .explore import (
    BINDERS,
    SubsetScores,
    SweepPoint,
    SweepReport,
    analyze_candidates,
    build_candidates,
    candidate_subsets,
    score_free_tile_subsets,
    sweep,
)
from .hardware import (
    DYNAP_SE,
    DYNAP_SE_9,
    DYNAP_SE_16,
    DYNAP_SE_1024,
    ChipState,
    CrossbarConfig,
    HardwareConfig,
    TileConfig,
    hardware_by_name,
)
from .lif import LIFParams, simulate_spikes, with_simulated_spikes
from .maxplus import (
    EdgeStack,
    evolve_batch,
    maxplus_matrix,
    maxplus_matrix_batch,
    mcm_power_iteration,
    mcr_batch,
    mcr_binary_search,
    mcr_howard,
    stack_graphs,
    throughput,
    throughput_batch,
)
from .optimize import (
    GenerationStat,
    OptimizeReport,
    ParetoPoint,
    bind_optimized,
    optimize_binding,
    optimize_binding_graph,
    optimize_binding_graphs_fused,
)
from .partition import (
    Cluster,
    ClusteredSNN,
    partition_greedy,
    partition_greedy_reference,
)
from .runtime import (
    AdmissionController,
    AdmissionError,
    AdmissionEvent,
    CompileReport,
    DesignArtifact,
    HardwareState,
    design_time_compile,
    project_order,
    runtime_admit,
    single_tile_order,
    verify_deadlock_free,
)
from .schedule import (
    ExecutionTrace,
    SelfTimedExecutor,
    analyze_throughput,
    build_static_orders,
    build_static_orders_batch,
    measured_throughput,
    random_orders,
)
from .sdfg import (
    SDFG,
    Channel,
    ChannelTable,
    as_channel_table,
    disjoint_union,
    hardware_aware_sdfg,
    order_edges,
    sdfg_from_clusters,
)
from .serving import PrecompilePool, ServiceTicket, ServingQueue
from .snn import SNN, calibrate_spikes, feedforward
from .workloads import (
    TABLE1_FIT,
    FaultEvent,
    WorkloadSpec,
    failure_storm,
    sample_workload,
    workload_suite,
)

#: Names of the reference's ``repro.core`` that the port does not have
#: yet, each mapped to its item of ``ROADMAP.md`` queue 1: none.
NOT_PORTED: dict[str, str] = {}

__all__ = [k for k in dir() if not k.startswith("_") and k != "NOT_PORTED"]
