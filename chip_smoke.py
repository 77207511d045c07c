"""Drive the PyTorch/CUDA port's compile-and-admit, joint placement and serving,
design-space sweep, sharded λ-search, SNN execution, LM serving (dense GQA,
jamba's hybrid, deepseek-v3's MLA and MoE, xlstm-350m), LM training and LM
mesh (DTensor training, expert parallelism, meshed serving, re-mesh
restore, shape-only init) paths on one GPU.

Run from the repository root:  ``PYTHONPATH=src python3 chip_smoke.py``
(the script also finds ``src/`` beside itself).  It needs one CUDA device
and ``nvcc``; it builds the kernels under ``build/repro_torch_kernels/``
first.  Without a CUDA device, or without the repository beside it, it
exits non-zero and prints no result.

Phases (each one fails the run if it fails; JSON lines on stdout):

1. env        torch/CUDA versions, card name and power limit, kernel build time
2. admission  the main path: an isolated-placement AdmissionController on the
              32x32 chip registers the eight Table-1 apps at their published
              sizes and admits each (2..16 tiles), then finishes one and
              re-admits it (a cache hit), that one under torch.profiler (its
              host wall split into numpy and Python, torch's dispatch and the
              host's waits on the card).  K1 must launch on every admission.
3. dense      the Eq.-4 start-time path and the dense backend on the card
              (K2, K3 and the G = 1 matmul), held against the exact search
4. crosscheck one admission replayed with device="cpu" (identical binding,
              throughput within 1e-8) and the largest stack the admission
              phase solved (HeartClass's) by "csr" on the card against
              "edges" on the host (rtol 1e-8)
5. joint_serving the joint, region-scoped controller on the 32x32 chip at the
              stress and serving harnesses' defaults: 224 synthetic tenants
              (scale 0.06) registered, 640 Zipf-1.1 churn events drained
              through a ServingQueue in windows of 16 (one flush profiled),
              then the faults harness's 30-fault storm through inject_fault,
              inject_drift and heal; every ticket processed, no rebalance
              below the chip throughput before it, no remap below its seed,
              no resident on a dead tile after any storm event, cached chip
              metrics within 1e-6 of the exact union's after the drain and
              the storm; K1 must launch
6. joint_crosscheck the faults harness's smoke configuration (64 tiles, 10
              tenants, 16 churn events through a ServingQueue, a 6-fault
              storm) with "csr" on the card and on the host: trajectory,
              bindings, chip metrics and every ChipMetrics field equal; with
              "edges" on the host, the card run's final placement scored
              again within 1e-8 (the runs part where scores tie within the
              search's tolerance; where is printed); the largest fused stack
              of phase 5 on the card, each member's rows equal to its own
              solve and within 1e-8 of "edges"
7. sweep      the sweep benchmark at full size (benchmarks/sweep.py): the
              eight Table-1 apps x 4, 9 and 16 tiles x the binders ours,
              spinemap and pycarl at crossbar 128 on DYNAP_SE through
              repro_torch.core.sweep on the card (72 candidates, "csr"): every
              throughput within 1e-6 of per-graph Howard on the host and 1e-8
              of "edges" on the host, "dense" on the card within 5e-4 (K2,
              K3), each card Pareto front undominated under "edges"; then
              the speedup section's walls (MLP-MNIST, 48 candidates, 16
              tiles: one batched card solve, the host's binary-search and
              Howard loops); K1 must launch
8. sharded    mcr_batch(devices=[cuda:0] * k), k = 2, 3, 4, one stream a chunk,
              on HeartClass's admission stack and the sweep's 72 rows, each
              twice: every row equal to the unsharded card solve; then phase
              6's card configuration again with a controller scoring on
              Mesh((cuda:0, cuda:0)): trajectory, bindings, chip metrics and
              every ChipMetrics field equal to phase 6's card run
9. export_pipeline the sweep's LeNet-MNIST graph at 16 tiles through to_json
              and from_json, solved again on the card: its throughput equal
              to the sweep's bit for bit; analyze_pipeline for the ten
              architectures at 2, 4 and 8 stages under the H100 constants
              (printed, not timed)
10. lm_serve  the LM serving path: qwen2-1.5b at full width, float32 params
              from a seeded generator, served with the reference's defaults
              (8 requests, 32 prompt + 32 generated tokens, greedy); the
              prefill step on the same prompts (flash kernel, float32) held
              against the serve loop's teacher-forced decode logits (plain
              attention) at the reference's 2e-2, and its last argmax against
              the first generated token
11. lm_prefill the prefill step in bf16 params (as the reference's prefill cell
              lowers it): qwen2-1.5b at (1, 32768) tokens, prefill_32k's
              length with the batch cut from 32 to 1, then starcoder2-3b at
              (1, 8192), whose 4096-token window runs the kernel's window
              branch; each model is freed before the next
12. snn_crossbar the SNN execution path on HeartClass (24,732 neurons, 2.4M
              synapses): (a) simulate_spikes on the card, 256 steps, twice,
              one lif_record launch each and no other, and on the host with
              the same draws: every neuron's count the same in all three (the
              synaptic sum adds in a fixed order); then, off the path, the
              route before lif_record (the per-step eager loop around
              spike_input) on the same draws, equal to the host's counts, v
              and refr, its wall and each step's share of synapses whose
              source fired printed; (b) the example's path over every cluster of
              the admission phase's clustering: one 128x128 crossbar block
              per cluster, 8 samples of rate-0.15 input spikes, 5 steps with
              spikes fed back, each step one stacked K5 launch over all the
              blocks; then the example's own 2-D loop (G = 1 calls) over its
              first 4 clusters, equal to the stack's rows bit for bit; the
              whole stacked trajectory bit-identical to the plain version and
              K5 launched 5 x (1 + 4) times
13. jamba_serve jamba-v0.1-52b cut to one of its four 8-layer blocks, float32
              params from seed 0, served at the reference's defaults; the
              prefill step on the same prompts (one chunk) launches K7 7 times
              (no route, states pass or combine) and K6 once; the first Mamba
              layer's prefill output (K7) held against its token-by-token
              decode (plain) within MAMBA_CONTEXT_TOL of the decode output's rms
14. jamba_prefill the same cut in bf16 params at (1, 32768) tokens,
              prefill_32k's length with the batch cut from 32 to 1: each of
              the 7 Mamba layers launches the scan's route once (no states
              pass, combine or K7); a second, profiled run reads the route
              kernel's device time
15. deepseek_serve deepseek-v3-671b cut to one dense-prefix (MLA, SwiGLU) and
              one MoE (MLA, 256 experts top-8 + 1 shared) layer at full width,
              float32 params from seed 0 (about 13.9 B), served at the
              reference's defaults with no token dropped (capacity experts /
              top_k); the prefill step (decompressed MLA) against the
              teacher-forced decode (absorbed MLA) with float32 activations at
              the reference's 2e-2 (the bf16 run's difference printed,
              unchecked: routing amplifies the decode's bf16 rounding);
              the first MLA layer's prefill against its token-by-token decode
              within MLA_CONTEXT_TOL of the decode output's rms; no kernel of
              ops launches; decode step against the bound of reading the
              weights, peak memory beside the parameters' bytes
16. deepseek_prefill the same cut in bf16 params at the config's capacity,
              one prefill step at (1, 4096) tokens; a second, profiled run
              splits its device time into the MLA attention's float32
              einsums (_sdpa), the MoE and the rest
17. xlstm_serve xlstm-350m in full (24 layers), float32 params from seed 0,
              served at the reference's defaults; layer 0 (sLSTM) and layer 1
              (mLSTM, chunkwise) against their decode recurrences in float32
              within the reference's atol 2e-4 / rtol 1e-3; no kernel of ops
              launches.  The whole model's prefill against its teacher-forced
              decode (float32 and bf16 activations) is printed against the
              reference's recurrent-family contract, not checked: at random
              init the mLSTMs amplify a rounding so far that the reference
              misses that contract itself at this shape
18. xlstm_prefill the whole model in bf16 params, one prefill step at (1, 4096)
              tokens (64 mLSTM chunks a layer, 4096 sLSTM steps in each of 3
              layers); a prefill of its first 512 tokens under torch.profiler
              splits its wall into torch's dispatch and the card's busy time
19. train     the trainer's main path: launch.train.main at its defaults
              (qwen2-1.5b at full width and depth, batch 8 x seq 256 from
              TokenStream(seed 0), float32 params and moments, remat "full",
              lr 1e-3), 4 steps of its own loop: losses finite, step 1's
              within TRAIN_LOSS0_TOL of ln(vocab); every layer of every
              gradient leaf finite and not all zero; K6 launched 2 x 28 times
              a step (each GQA layer's forward, and again in remat's
              recompute; the backward is the plain recompute); step wall
              (data excluded), tokens/s, peak memory beside its reckoning, the
              card's busy share in the profiled last step
20. train_crosscheck reduced qwen2-1.5b and reduced jamba from the same
              params and batch on the card (K6; the scan's route, two chunks)
              and the host (the plain versions): loss within 1e-5,
              every gradient leaf within ref.TRAIN_GRAD_SCALE of
              ref.grad_excess (ATTN_TOL's limits, the leaf as the row); one
              int8-moment AdamW update on both, every q equal except within
              INT8_BOUNDARY_ULPS of a rounding boundary; the same gradient
              twice on the card (the leaves that part, if any, are named);
              the reduced restart: 6 straight steps twice, and 3 steps, a
              checkpoint and 3 resumed steps
21. mesh_train the train phase again under the LM mesh: a world of one NCCL
              rank that the script makes (and destroys after phase 26),
              make_local_mesh()'s (1, 1) ("data", "model") mesh, and
              launch.train.main(mesh=) at the train phase's arguments, seed
              and batches: params and moments DTensors laid out by
              params_shardings / opt_state_shardings, each batch by
              batch_shardings; K6 runs on each rank's shard under local_map
              and must launch; losses and updated params equal the train
              phase's bit for bit, else within MESH_TRAIN_RTOL with the
              parted leaves printed; step wall and the card's busy share
22. remesh_restore mesh_train's params and moments saved, and restored with
              load_checkpoint(shardings=) onto a ("data",) mesh of one: every
              leaf bit-equal (it comes before phase 23, while the card holds
              mesh_train's state and nothing larger)
23. mesh_moe  deepseek-moe-16b cut to its dense layer and one MoE layer at full
              width (64 experts top-6, 2 shared, moe_d_ff 1408, d_model 2048),
              float32 params and activations from seed 0, one batch of the
              train phase's shape:
              loss and gradients through _dispatch_shard_map on the mesh
              against the gather path without one (MESH_MOE_LOSS_RTOL,
              MESH_MOE_GRAD_RTOL), then one train step under the mesh
24. mesh_serve deepseek_serve's cut, params and prompts served by
              serve(mesh=): params_shardings(inference=True), inference_ep,
              the caches by cache_shardings; the tokens equal
              deepseek_serve's; decode step time and busy share beside
              deepseek_serve's; no kernel of ops launches
25. abstract  init_abstract, input_specs and decode_cache_specs of the ten
              architectures at full size and the four shape cells: every
              tensor on meta, no allocation by the card's allocator (its
              count of allocations, memory_allocated() and its peak all
              unchanged); the parameter counts printed
26. dryrun    the dry run (launch/dryrun.py, meta tensors on a fake production
              mesh): (a) three production cells through its CLI, each in a
              process of its own, side by side: qwen2-1.5b train_4k and
              jamba-v0.1-52b prefill_32k (K6 and K7's route through their
              meta leg) on (16, 16), deepseek-v3-671b decode_32k (inference
              EP over both axes) on (2, 16, 16); every record without error,
              nothing allocated on the card in the child (its allocator's
              count, memory_allocated() and its peak all 0); per-device
              flops, bytes, collectives by kind, argument and peak bytes
              against 80 GB, the three roofline terms (data-sheet
              arithmetic) and the cell's wall printed; (b) lower_cell's
              count of the train phase's step (qwen2-1.5b in full, 8 x 256
              tokens, float32 params and moments, remat "full") on the (1, 1)
              mesh, held against the same counting around one extra step of
              mesh_train's world on the card: flops equal, no collective in
              either, the argument bytes equal to the card's params, moments
              and batch; the peak estimate beside the card's
              max_memory_allocated(), the terms beside mesh_train's measured
              step wall and device time (the extra step's K6 launches count
              on no path); (c) in a process of its own, beside (a): reduced
              deepseek-v3's train step on a fake (2, 2, 2) ("pod", "data",
              "model") mesh, microbatches of 2 rows on 4 batch ranks, so the
              MoE's tokens shard over more axes than (B, S) carry (the
              production cell deepseek-v3 train_4k on (2, 16, 16) in small):
              it lowers, each MoE output's local shard is the one its
              placements give, and the MoE input's gradient comes back in the
              input's own layout
27. kernels   every kernel against its plain PyTorch version on the card, with
              times and bounds, on the inputs of its largest call in phases
              2-20 (the mesh phases' launches count on the kernels line): K1-K5 bit-identical; flash attention, also at its largest
              float32 call, its largest windowed call, its largest
              dense-model prefill call (qwen2-1.5b's 32k, timed against SDPA
              as the largest is) and its largest train call (with the time
              of the plain backward recompute), within kernels/ref.py's ATTN_TOL (per
              element one rounding step of the output type plus 2^-14 of its
              row's root mean square); all four flash comparisons are
              printed before any is checked; each flash call also timed
              against one F.scaled_dot_product_attention call for the same
              masks (a boolean mask for the window), whose own distance from
              the plain version is printed as library_tol_ratio;
              the scan's route at its largest call (jamba's first 32k Mamba
              layer) equal bit for bit to the three launches it replaced
              (states pass, combine, K7; timed beside it) and within
              kernels/ref.py's SCAN_TOL of the plain route; on the same
              inputs, off every path, the states pass equal to the plain
              states and the full launch's, the combine within the state's
              limit, K7 from the combined (nonzero) chunk states within
              SCAN_TOL; lif_record's counts, last v and refr bit-identical to
              the host's, beside its barrier floor (its grid meeting once a
              step, doing nothing), the launch floor (an empty launch) and the
              per-step loop it replaced; spike_input, off every path, on the
              fired flags of recorded step SI_STEP, bit-identical to the
              host's; K1, K7 and
              the route, launched on
              several paths, also timed at each path's largest call; K1 and
              K5 also checked and timed at the first call of every distinct
              shape of each path (``by_shape``: K5's stacked step and the
              example's G = 1 call; K2's dense and sweep shapes; K1's
              admission, dense and sweep shapes
              and the 10 joint_serving and 10 sharded shapes with the most
              launches, with the launch-weighted ``rule2_ms``)

Launch counts are set to 0 just before each path's phase (2, 3, 5, 7, 8, 10-21,
23, 24) and read just after, and reported per path (phases 15-18 and 24 must
launch none);
launches made to compare or time kernels do not count.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import io
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet peaks (dense, without sparsity, at 700 W);
#: the flop rates count an FMA, one instruction, as two flops
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12     # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12    # TF32 on the tensor cores
FP64_FLOPS_PER_S = 34e12     # float64 outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # bf16 on the tensor cores
#: a (max,+) term is two float32 instructions (FADD, FMNMX), so it takes
#: the dispatch slots of four data-sheet flops; FMNMX's own rate on sm_90
#: (64 per clock per SM, half the FADD rate) gives the same bound
MAXPLUS_TERMS_PER_S = FP32_FLOPS_PER_S / 4
#: a K1 term dist + (w - lam*t) against the running max is four float64
#: instructions (DMUL, DADD, DADD, DSETP)
RELAX_TERMS_PER_S = FP64_FLOPS_PER_S / 8
#: each of K7's expf issues one MUFU.EX2: 16 a clock per SM, 132 SMs, at the
#: H100 SXM's 1.98 GHz boost clock (a second bound, beside the table's)
EX2_PER_S = 132 * 16 * 1.98e9
#: thread-instructions a second: a warp instruction a clock from each of an
#: SM's 4 schedulers, 132 SMs, 1.98 GHz (K7's issue floor)
THREAD_INSTR_PER_S = 132 * 4 * 32 * 1.98e9

#: n_tiles_request per app, each between 2 and 16
REQUESTS = {
    "ImgSmooth": 2, "EdgeDet": 4, "MLP-MNIST": 2, "HeartEstm": 8,
    "HeartClass": 16, "CNN-MNIST": 4, "LeNet-MNIST": 8, "LeNet-CIFAR": 16,
}
OPTIMIZE_BUDGET = (2, 64)
BATCH = 64                   # candidate rows of the dense-path stack
#: tokens of starcoder2-3b's bf16 prefill: twice its 4096-token window
STARCODER2_TOKENS = 8_192
#: the reference's own decode-vs-forward contract (tests/test_models_smoke.py)
SERVE_RTOL = SERVE_ATOL = 2e-2
PROFILED_DECODE_STEPS = 4
#: the SNN execution path: the largest Table-1 app and the example's inputs
SNN_APP = "HeartClass"
SNN_STEPS = 256              # simulate_spikes' default
#: the recorded step whose fired flags spike_input is checked and timed on
SI_STEP = SNN_STEPS // 2
CROSSBAR_SAMPLES, CROSSBAR_RATE, CROSSBAR_STEPS = 8, 0.15, 5
#: clusters the example's own 2-D loop (one G = 1 call a step) runs over
CROSSBAR_EXAMPLE_CLUSTERS = 4
#: the first Mamba layer's prefill (chunked scan, K7) against its decode
#: recurrence (plain), float32: at most this share of the decode output's rms
MAMBA_CONTEXT_TOL = 1e-4
JAMBA = "jamba-v0.1-52b"
#: deepseek-v3 cut to one dense-prefix and one MoE layer; the first MLA
#: layer's decompressed prefill against its absorbed decode, float32: at most
#: this share of the decode output's rms
DEEPSEEK, MLA_CONTEXT_TOL = "deepseek-v3-671b", 1e-4
#: xlstm-350m in full; each layer kind's prefill form against its decode, the
#: reference's chunkwise-against-sequential contract (tests/test_models_smoke.py)
XLSTM, XLSTM_LAYER_ATOL, XLSTM_LAYER_RTOL = "xlstm-350m", 2e-4, 1e-3
#: the reference's decode-vs-forward contract for recurrent families
#: (tests/test_models_smoke.py): fewer than this share of logits beyond
#: atol + rtol |forward|, and the argmax of the first positions equal;
#: xlstm_serve prints the whole model's figures against it
RECURRENT_ATOL, RECURRENT_RTOL, RECURRENT_SHARE, RECURRENT_ARGMAX_POSITIONS = 5e-2, 5e-2, 0.08, 4
#: tokens of the deepseek-v3 and xlstm-350m bf16 prefills (batch 1), and of
#: xlstm's profiled prefill: the trace of 4096 tokens (some 600,000 host and
#: device events) takes the profiler minutes to read
DEEPSEEK_PREFILL_TOKENS = XLSTM_PREFILL_TOKENS = 4_096
XLSTM_PROFILED_TOKENS = 512
#: kernels launched on more than one path at different shapes: each is also
#: timed at every path's largest call (the rule-2 order weighs launches by it)
BY_PATH = ("relax_round", "relax_round_witness", "mamba_chunk_scan", "mamba_scan_route")
#: kernels off every path: the scan's states pass and combine since its route
#: became one walk (checked and timed as the route's yardstick on its largest
#: call's inputs), spike_input since the recording became one launch
#: (checked and timed on the fired flags of recorded step SI_STEP)
OFF_PATH = ("mamba_chunk_states", "mamba_chunk_combine", "spike_input")
#: kernels also checked and timed at the first call of every distinct shape
#: of each path
BY_SHAPE = ("relax_round", "relax_round_witness", "lif_crossbar_step", "maxplus_bmm")
#: paths with hundreds of K1 shapes: only this many, those with the most
#: launches, are checked and timed by shape
BY_SHAPE_TOP = {"joint_serving": 10, "sharded": 10}
#: joint_serving: the stress and serving harnesses' defaults
#: (benchmarks/stress.py, benchmarks/serving.py): tenants drawn at this
#: scale, the joint search budget, Zipf-1.1 churn drained in windows
JOINT_TENANTS, JOINT_SCALE, JOINT_BUDGET = 224, 0.06, (1, 6)
JOINT_EVENTS, JOINT_WINDOW, ZIPF_S = 640, 16, 1.1
#: then the faults harness's full storm (benchmarks/faults.py)
JOINT_FAULTS = 30
JOINT_STORM = dict(seed=2, tiles_per_fault=2, heal_after=4.0, p_throttle=0.15,
                   p_drift=0.15, max_dead_frac=0.10)
#: the flush of the drain that is run under torch.profiler (of 40)
PROFILED_FLUSH = 20
#: joint_crosscheck: the faults harness's smoke configuration
SMOKE_TILES, SMOKE_TENANTS, SMOKE_EVENTS, SMOKE_FAULTS = 64, 10, 16, 6
SMOKE_STORM = dict(seed=2, tiles_per_fault=1, heal_after=2.0, p_throttle=0.15,
                   p_drift=0.15, max_dead_frac=0.15)
#: sweep: the sweep benchmark's sections at full size (benchmarks/sweep.py:
#: 44-128): the eight apps x these tile counts x binders at crossbar 128 on
#: DYNAP_SE, then one app's candidates for the speedup walls
SWEEP_TILES, SWEEP_BINDERS = (4, 9, 16), ("ours", "spinemap", "pycarl")
SPEEDUP_APP, SPEEDUP_CANDIDATES, SPEEDUP_TILES = "MLP-MNIST", 48, 16
#: sharded: row chunks over streams of one card, each solve run twice
SHARD_COUNTS, SHARD_RUNS = (2, 3, 4), 2
#: export_pipeline: the graph round-tripped, and the pipeline analysis grid
EXPORT_POINT = ("LeNet-MNIST", 16, "ours")
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_TOKENS = (2, 4, 8), 16, 4096
#: train: qwen2-1.5b at full width and depth through launch.train.main at its
#: defaults (batch 8, seq 256, float32 params and moments, remat "full" from
#: the config, lr 1e-3), this many steps; the last one under torch.profiler
TRAIN_ARCH, TRAIN_STEPS, PROFILED_TRAIN_STEP = "qwen2-1.5b", 4, 3
#: step 1's loss at random init lies within this of ln(vocab): the logits of
#: a normalised stream against 0.02-scale tied embeddings spread by about
#: 0.8, which adds about 0.3 to the logsumexp
TRAIN_LOSS0_TOL = 1.0
#: train_crosscheck: reduced models on one batch of (2, 64) tokens (two of
#: jamba's 32-token chunks), and the restart's steps
CROSS_BATCH, CROSS_SEQ, RESTART_STEPS = 2, 64, 6
#: an int8 moment's q may differ card and host only where the value it
#: rounds lies within this many of its ulps of a rounding boundary (the
#: value's own ulp, and its block scale's)
INT8_BOUNDARY_ULPS = 2
#: the LM mesh phases (21-26) run in a world of one rank of this backend,
#: on make_local_mesh()'s (1, 1) ("data", "model") mesh
MESH_BACKEND = "nccl"
#: mesh_train against train: bit for bit, or within this relative difference
#: where DTensor reroutes an op (the parted leaves are printed)
MESH_TRAIN_RTOL = 1e-6
#: mesh_moe: deepseek-moe-16b cut to its dense layer and one MoE layer at full
#: width; the expert-parallel loss against gather's (relative), and each
#: gradient leaf's largest difference as a share of the leaf's largest
#: magnitude: the combine adds the k choices one at a time where gather sums
#: them in one reduction, and the rest follows from that rounding
MOE_ARCH = "deepseek-moe-16b"
MESH_MOE_LOSS_RTOL, MESH_MOE_GRAD_RTOL = 1e-6, 1e-4
#: dryrun: production cells (arch, shape, multi-pod) through the dry run's
#: CLI, each in a process of its own (its fake world of 256 or 512 ranks
#: never meets this script's NCCL world), side by side; each must end within
#: the timeout
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", False), ("jamba-v0.1-52b", "prefill_32k", False),
                ("deepseek-v3-671b", "decode_32k", True))
DRYRUN_TIMEOUT_S = 480
#: dryrun (c): reduced deepseek-v3's train step on a fake (2, 2, 2) pod
#: mesh, microbatches of fewer rows than the batch ranks (its own process:
#: a fake world of 8 ranks); prints the MoE layer's layouts and the count
DRYRUN_POD_MOE_CHILD = (
    "import dataclasses, json, torch, torch.distributed as dist\n"
    "from torch.distributed.device_mesh import init_device_mesh\n"
    "from torch.distributed.tensor import Shard\n"
    "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
    "from repro_torch.configs import get_arch, reduced\n"
    "from repro_torch.launch import dryrun, sharding as tsh\n"
    "from repro_torch.models import moe as tmoe\n"
    "cfg = reduced(get_arch('deepseek-v3-671b'))\n"
    "cfg = dataclasses.replace(cfg, stacks=tuple((1, s) for _, s in cfg.stacks))\n"
    "seen, moe_forward = [], tmoe.moe_forward\n"
    "def spy(p, x, c, **kw):\n"
    "    grads = []\n"
    "    x.register_hook(lambda g: grads.append([str(q) for q in g.placements]))\n"
    "    y, aux = moe_forward(p, x, c, **kw)\n"
    "    local = list(y.shape)\n"
    "    for i, q in enumerate(y.placements):\n"
    "        if isinstance(q, Shard):\n"
    "            local[q.dim] //= y.device_mesh.size(i)\n"
    "    seen.append({'x': [str(q) for q in x.placements], 'y_shape': list(y.shape),\n"
    "                 'y_local': list(y.to_local().shape), 'y_local_of_placements': local,\n"
    "                 'x_grad': grads})\n"
    "    return y, aux\n"
    "tmoe.moe_forward = spy\n"
    "dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=8)\n"
    "try:\n"
    "    mesh = init_device_mesh('cuda', (2, 2, 2), mesh_dim_names=('pod', 'data', 'model'))\n"
    "    step, args, notes = dryrun.cell_step(cfg, 'train_4k', mesh, accum=2,\n"
    "                                         batch_tokens=(4, 16))\n"
    "    with tsh.use_mesh(mesh):\n"
    "        parts, _ = dryrun.count_step(step, args)\n"
    "finally:\n"
    "    dist.destroy_process_group()\n"
    "print(json.dumps({'arch': cfg.name, 'mesh': [2, 2, 2], 'batch_tokens': [4, 16],\n"
    "  'grad_accum': notes['grad_accum'], 'flops': parts['cost']['flops'],\n"
    "  'collectives': {k: v for k, v in parts['collectives'].items() if v}, 'moe': seen,\n"
    "  'allocations': torch.cuda.memory_stats().get('allocation.all.allocated', 0),\n"
    "  'max_memory_allocated': torch.cuda.max_memory_allocated()}))\n")
#: the child: the CLI's main, then what the card's allocator saw, as JSON
DRYRUN_CHILD = (
    "import json, sys, torch\n"
    "from repro_torch.launch import dryrun\n"
    "dryrun.main(sys.argv[1:])\n"
    "print(json.dumps({'cuda_initialized': torch.cuda.is_initialized(),\n"
    "  'allocations': torch.cuda.memory_stats().get('allocation.all.allocated', 0),\n"
    "  'memory_allocated': torch.cuda.memory_allocated(),\n"
    "  'max_memory_allocated': torch.cuda.max_memory_allocated()}))\n")
#: host calls that wait for the card (syncs, and copies out of it)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpyAsync", "cudaMemcpy")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def crossbar_blocks(cl, size: int = 128):
    """One dense (size, size) float32 crossbar block per cluster of a
    ``ClusteredSNN``, as ``examples/snn_on_tpu.py`` builds them: rows are
    the cluster's distinct presynaptic neurons in increasing id, columns its
    member neurons in increasing id, and each synapse adds its weight in
    synapse order.  Returns ``(blocks (n_clusters, size, size), inputs per
    cluster, members per cluster)``."""
    import numpy as np

    work, k = cl.snn, cl.n_clusters
    n = work.n_neurons
    members = np.bincount(cl.cluster_of, minlength=k)
    col = np.empty(n, dtype=np.int64)      # a neuron's rank within its cluster
    starts = np.cumsum(members) - members
    col[np.lexsort((np.arange(n), cl.cluster_of))] = np.arange(n) - np.repeat(starts, members)
    syn_cluster = cl.cluster_of[work.post].astype(np.int64)
    keys, row = np.unique(syn_cluster * n + work.pre, return_inverse=True)
    first = np.searchsorted(keys, np.arange(k, dtype=np.int64) * n)
    row = row.reshape(-1) - first[syn_cluster]
    inputs = np.diff(np.append(first, keys.size))
    if max(members.max(initial=0), inputs.max(initial=0)) > size:
        raise ValueError(f"a cluster needs more than {size} crossbar rows or columns")
    blocks = np.zeros((k, size, size), dtype=np.float32)
    np.add.at(blocks, (syn_cluster, row, col[work.post]), work.weight.astype(np.float32))
    return blocks, inputs, members


def recorded_spikes(csr, is_input, draws, params, step: int):
    """The fired flags (float32 0/1) of step ``step`` of a recording: the
    state after ``step`` steps of ``ops.lif_record``, then the step's rule."""
    import torch
    from repro_torch.kernels import ops

    _, v, refr = ops.lif_record(csr, is_input, draws[:step], params)
    fired = torch.where(is_input, draws[step] < params.input_rate,
                        (v >= params.v_threshold) & (refr <= 0))
    return fired.float()


def zipf_stream(names, n_events, seed=1):
    """The stress harness's churn: ``n_events`` tenant picks, Zipf-``ZIPF_S``
    over the tenants in order, from ``default_rng(seed)``."""
    import numpy as np

    r = np.arange(1, len(names) + 1, dtype=np.float64) ** -ZIPF_S
    probs = r / r.sum()
    rng = np.random.default_rng(seed)
    return [names[int(rng.choice(len(names), p=probs))] for _ in range(n_events)]


def tiles_request(n_clusters: int) -> int:
    """The stress harness's request: a small footprint a tenant."""
    return max(1, min(4, n_clusters))


def joint_controller(runtime, workloads, hw, n_tenants, device, backend="auto", mesh=None):
    """A joint, region-scoped controller with ``n_tenants`` tenants of the
    stress harness registered; returns it, the names and the requests."""
    tenants = workloads.workload_suite(n_tenants, seed=0, scale=JOINT_SCALE)
    ctl = runtime.AdmissionController(
        hw, placement="joint", joint_budget=JOINT_BUDGET, full_rebalance_every=0,
        backend=backend, device=device, mesh=mesh)
    requests = {}
    for snn in tenants:
        requests[snn.name] = tiles_request(ctl.register(snn).clustered.n_clusters)
    return ctl, [snn.name for snn in tenants], requests


def drain_churn(serving, ctl, names, requests, n_events):
    """Submit the churn to a ServingQueue, admitting a tenant when it is
    absent from the queued trajectory and evicting it when present (the
    serving harness's burst mode), and drain it."""
    q = serving.ServingQueue(ctl, coalesce_window=JOINT_WINDOW)
    resident = set()
    for name in zipf_stream(names, n_events):
        if name in resident:
            q.submit_evict(name)
            resident.discard(name)
        else:
            q.submit_admit(name, n_tiles_request=requests[name])
            resident.add(name)
    return q, q.drain()


def regressions(events) -> int:
    """Rebalances whose chip throughput fell below the chip's just before
    them (the serving harness's never-regress rule, 1 - 1e-6)."""
    bad, prev = 0, None
    for e in events:
        if e.chip_throughput and e.chip_throughput > 0:
            if e.kind == "rebalance" and prev and e.chip_throughput < prev * (1 - 1e-6):
                bad += 1
            prev = e.chip_throughput
        elif e.kind in ("admit", "evict", "finish"):
            prev = e.chip_throughput or None
    return bad


def drive_storm(ctl, storm):
    """Drive a failure storm through the fault runtime, each pick mapped
    onto the currently bound tiles and resident apps as
    ``benchmarks/faults.py`` maps it.  Checks after every event that no
    resident sits on a dead tile; returns (kind, wall s, displaced) per
    event driven."""
    side = ctl.hw.mesh_shape[1]
    n_tiles = ctl.hw.n_tiles

    def bound_tiles():
        return sorted({int(t) for ts in ctl.running().values() for t in ts})

    def target_link(a, horiz):
        bound = bound_tiles()
        base = bound[a % len(bound)] if bound else a
        if horiz:
            nb = base + 1 if base % side + 1 < side else base - 1
        else:
            nb = base + side if base + side < n_tiles else base - side
        return (min(base, nb), max(base, nb))

    out, heal_map, link_map = [], {}, {}
    for i, ev in enumerate(storm):
        t = time.perf_counter()
        if ev.kind == "fail":
            bound = [x for x in bound_tiles() if not ctl.chip.dead[x]]
            tiles = tuple(sorted({bound[x % len(bound)] for x in ev.tiles} if bound
                                 else {x for x in ev.tiles if not ctl.chip.dead[x]}))
            heal_map[ev.tiles] = tiles
            if not tiles:
                continue
            displaced = ctl.inject_fault(list(tiles))
        elif ev.kind == "heal" and ev.link is not None:
            link = link_map.pop(ev.link, None)
            if link is None or link not in ctl.chip.link_throttle:
                continue
            displaced = ctl.heal(links=[link])
        elif ev.kind == "heal":
            tiles = tuple(x for x in heal_map.pop(ev.tiles, ev.tiles) if ctl.chip.dead[x])
            if not tiles:
                continue
            displaced = ctl.heal(list(tiles))
        elif ev.kind == "throttle":
            a, b = ev.link
            link = target_link(a, horiz=(b - a == 1))
            link_map[ev.link] = link
            displaced = ctl.inject_fault(links=[link], throttle=ev.factor)
        else:
            app = ev.app
            if app not in ctl.state.allocated:
                res = sorted(ctl.state.allocated)
                if not res:
                    continue
                app = res[i % len(res)]
            displaced = ctl.inject_drift(app, ev.factor)
        out.append((ev.kind, time.perf_counter() - t, len(displaced)))
        dead = [n for n, ts in ctl.running().items() if any(ctl.chip.dead[int(x)] for x in ts)]
        check(not dead, f"storm event {i} ({ev.kind}) left {dead} on dead tiles")
    return out


def _leaves(tree):
    """The tensors of a nested dict of parameters."""
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _first(tree):
    """Repeat 0 of a stacked layer's parameters."""
    return {k: _first(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[0]


def _items(tree, prefix=""):
    """(path, tensor) of a nested dict of parameters, paths joined by "/"."""
    for k, v in tree.items():
        yield from _items(v, f"{prefix}{k}/") if isinstance(v, dict) else ((prefix + k, v),)


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}; run from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import (ARCH_NAMES, SHAPES, decode_cache_specs, get_arch,
                                     input_specs, reduced)
    from repro_torch.core import (apps, engine, explore, export, lif, maxplus, pipeline,
                                  runtime, serving, workloads)
    from repro_torch.core.hardware import DYNAP_SE, DYNAP_SE_1024, DYNAP_SE_16
    from repro_torch.core.partition import partition_greedy
    from repro_torch.core.schedule import build_static_orders
    from repro_torch.core.sdfg import hardware_aware_sdfg, sdfg_from_clusters
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import work as kwork
    from repro_torch.kernels import maxplus_bellman as kbell
    from repro_torch.launch import dryrun as tdry
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharding as tsh
    from repro_torch.launch.sharding import Mesh
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models import attention as tattn
    from repro_torch.models import mamba as tmamba
    from repro_torch.models import moe as tmoe
    from repro_torch.models import xlstm as txl
    from repro_torch.models.blocks import rms_norm
    from repro_torch.models import transformer as ttf
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim import adamw as tadamw
    from repro_torch.tree import tree_leaves, tree_map

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # -- 1. env -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0].strip() if smi else "nvidia-smi: no output"
    t0 = time.perf_counter()
    _build.build_all()
    emit({
        "phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(), "nvidia_smi": smi_line,
        "kernel_build_s": time.perf_counter() - t0,
    })

    def reset():
        ops.reset_launches()
        kbell.reset_counts()

    def device_us(prof):
        """Device µs per kernel or copy of a ``torch.profiler`` run.  Only
        the device's own events count: a host op's row repeats the time of
        the kernels it launched."""
        out = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                out[ev.key] = us
        return out

    def host_split(fn):
        """Run ``fn`` once under ``torch.profiler``: (its result, its wall
        split into the host time inside torch's calls, those of them that
        wait for the card (``SYNC_CALLS``), and the rest (numpy and Python),
        with the card's busy share, K1 launches and the λ-search's host
        reads).  ``profiler_s`` is the time the profiler itself took after
        ``fn`` returned (stopping the trace, reading its events)."""
        k1 = ops.LAUNCHES["relax_round"], ops.LAUNCHES["relax_round_witness"]
        syncs = kbell.COUNTS["syncs"]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
        ]) as prof:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        host_us = {}
        t_done = t + wall
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CPU and ev.self_cpu_time_total > 0:
                host_us[ev.key] = ev.self_cpu_time_total
        torch_s = sum(host_us.values()) / 1e6
        sync_s = sum(v for k, v in host_us.items() if k in SYNC_CALLS) / 1e6
        busy_s = sum(device_us(prof).values()) / 1e6
        return out, {
            "profiler_s": time.perf_counter() - t_done,
            "wall_s": wall, "torch_host_s": torch_s, "torch_dispatch_s": torch_s - sync_s,
            "host_sync_s": sync_s, "host_numpy_python_s": wall - torch_s,
            "device_busy_s": busy_s, "device_busy_share": busy_s / wall,
            "relax_round_launches": ops.LAUNCHES["relax_round"] - k1[0],
            "relax_round_witness_launches": ops.LAUNCHES["relax_round_witness"] - k1[1],
            "host_syncs": kbell.COUNTS["syncs"] - syncs,
            "top_host_us": sorted(host_us.items(), key=lambda kv: -kv[1])[:8],
            "source": "torch.profiler, self CPU time of torch's host events; "
                      "host syncs: " + ", ".join(SYNC_CALLS),
        }

    launches = {k: {} for k in ops.LAUNCHES}   # kernel -> {path: launches}

    def read_into(path):
        for k, v in ops.LAUNCHES.items():
            launches[k][path] = v

    # Every wrapper is spied on: per path, the shapes it was given, and the
    # inputs of its largest call, on which phase 27 times and checks it.
    where = {"path": None, "app": None}
    seen = {k: {} for k in ops.LAUNCHES}        # kernel -> {path: Counter(shape)}
    largest = {}                                # kernel -> dict(work, path, app, shape, args, kwargs)
    flash_largest = {}    # "float32" / "windowed" / "lm_prefill" (qwen2's 32k) -> the same
    path_largest = {k: {} for k in BY_PATH}     # kernel -> {path: the same}
    first_of_shape = {k: {} for k in BY_SHAPE}  # kernel -> {(path, shape): the same}

    def k1_shape(dist, lams, csr):
        return (dist.shape[0] // csr.n_actors, csr.n_actors, int(csr.src.numel()), dist.shape[1])

    shape_of = {      # kernel -> (shape names, shape of a call)
        "relax_round": ("BnEK", k1_shape),
        "relax_round_witness": ("BnEK", k1_shape),
        "maxplus_bmm": ("GMKN", lambda a, b: (*a.shape, b.shape[2])),
        "maxplus_bmv": ("GMK", lambda a, x: tuple(a.shape)),
        "maxplus_matmul": ("MKN", lambda a, b: (*a.shape, b.shape[1])),
        "flash_attention": (("B", "Hq", "Hkv", "Sq", "Skv", "D"),
                            lambda q, k, v, **kw: (*q.shape[:2], k.shape[1], q.shape[2],
                                                   k.shape[2], q.shape[3])),
        "lif_crossbar_step": (("G", "B", "n_in", "n_out"),
                              lambda s, w, v, **kw: ((s.shape[0] if s.dim() == 3 else 1),
                                                     *s.shape[-2:], w.shape[-1])),
        "mamba_chunk_scan": (("B", "L", "D", "N"),
                             lambda x, dt, a, b, c, h0, **kw: (*x.shape, a.shape[1])),
        "mamba_chunk_states": (("B", "L", "D", "N"),
                               lambda x, dt, a, b, **kw: (*x.shape, a.shape[1])),
        "mamba_chunk_combine": (("B", "L", "D", "N"),
                                lambda dt, a, s_local, **kw: (*dt.shape, a.shape[1])),
        "mamba_scan_route": (("B", "L", "D", "N"),
                             lambda x, dt, a, b, c, **kw: (*x.shape, a.shape[1])),
        "spike_input": (("n", "E"), lambda s, csr: (s.shape[0], int(csr.pre.numel()))),
        "lif_record": (("n", "E", "steps"),
                       lambda csr, is_input, draws, params: (draws.shape[1], int(csr.pre.numel()),
                                                             draws.shape[0])),
    }

    def work(name, shape):    # E*K terms for K1, the product of the dims otherwise
        return shape[2] * shape[3] if name.startswith("relax") else math.prod(shape)

    def keep_if_larger(table, key, name, shape, args, kwargs, kept=None):
        """Store this call under ``key`` if it is the larger (``kept``: the
        same call's entry from another table, shared instead of cloned)."""
        if key in table and work(name, shape) <= table[key]["work"]:
            return None
        table[key] = kept or {
            "work": work(name, shape), "path": where["path"], "app": where["app"],
            "shape": shape, "kwargs": dict(kwargs), "args": tuple(
                a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args),
        }
        return table[key]

    def spy(name):
        orig = getattr(ops, name)

        def call(*args, **kwargs):
            if where["path"] is not None and next(
                    a for a in args if isinstance(a, torch.Tensor)).is_cuda:
                shape = tuple(int(d) for d in shape_of[name][1](*args, **kwargs))
                seen[name].setdefault(where["path"], collections.Counter())[shape] += 1
                kept = keep_if_larger(largest, name, name, shape, args, kwargs)
                if name in BY_PATH:
                    keep_if_larger(path_largest[name], where["path"], name, shape, args, kwargs,
                                   kept)
                if name in BY_SHAPE:
                    keep_if_larger(first_of_shape[name], (where["path"], shape), name, shape,
                                   args, kwargs)
                if name == "flash_attention":
                    if args[0].dtype == torch.float32:
                        keep_if_larger(flash_largest, "float32", name, shape, args, kwargs)
                    if kwargs.get("window", 0) > 0:
                        keep_if_larger(flash_largest, "windowed", name, shape, args, kwargs)
                    if where["path"] in ("lm_prefill", "train"):
                        keep_if_larger(flash_largest, where["path"], name, shape, args, kwargs)
            return orig(*args, **kwargs)

        setattr(ops, name, call)

    for name in shape_of:
        spy(name)

    # -- 2. admission (main path) -----------------------------------------
    t_phase = time.perf_counter()
    ctl = runtime.AdmissionController(
        DYNAP_SE_1024, optimize_budget=OPTIMIZE_BUDGET, device=dev
    )
    register_s, snns = {}, {}
    for name in REQUESTS:
        t = time.perf_counter()
        snns[name] = apps.build_app(name)
        ctl.register(snns[name])
        register_s[name] = time.perf_counter() - t
    emit({"phase": "register", "apps": {
        name: {"clusters": ctl.artifacts[(name, DYNAP_SE_1024)].clustered.n_clusters,
               "wall_s": s} for name, s in register_s.items()}})

    # the largest stack the admission phase solves, for phase 4
    solved = {"size": -1}
    mcr_batch = engine.mcr_batch

    def mcr_spy(stack, **kw):
        if stack.n_graphs * stack.n_edges > solved["size"]:
            solved.update(size=stack.n_graphs * stack.n_edges, app=where["app"],
                          stack=stack, lo0=kw.get("lo0"))
        return mcr_batch(stack, **kw)

    engine.mcr_batch = mcr_spy
    where["path"] = "admission"
    reset()
    events = []

    def admit(name, k, profiled=None):
        where["app"] = name
        before = ops.LAUNCHES["relax_round"]
        shapes_before = dict(ctl.cache_stats.shapes)
        syncs_before = kbell.COUNTS["syncs"]
        t = time.perf_counter()
        if profiled is None:
            rep = ctl.admit(name, n_tiles_request=k)
        else:
            rep, split = host_split(lambda: ctl.admit(name, n_tiles_request=k))
            profiled.update(app=name, **split)
        torch.cuda.synchronize()
        # a profiled admission's wall leaves out the profiler's own teardown
        wall = time.perf_counter() - t - (profiled or {}).get("profiler_s", 0.0)
        ev = ctl.events[-1]
        shapes = [list(key[1:]) for key, c in ctl.cache_stats.shapes.items()
                  for _ in range(c - shapes_before.get(key, 0))]
        k1 = ops.LAUNCHES["relax_round"] - before
        check(ev.kind == "admit", f"{name} was not admitted: {ev.kind}")
        check(k1 > 0, f"K1 did not launch while admitting {name}")
        check(math.isfinite(rep.throughput) and rep.throughput > 0,
              f"{name}: throughput {rep.throughput}")
        events.append({
            "kind": ev.kind, "app": name, "tiles": ev.tiles, "wall_s": wall,
            "throughput_per_us": rep.throughput, "cache_hit": ev.cache_hit,
            "analysed_B_n_E": shapes, "relax_round_launches": k1,
            "host_syncs": kbell.COUNTS["syncs"] - syncs_before,
        })
        return rep

    for name, k in REQUESTS.items():
        admit(name, k)
    freed = ctl.finish("CNN-MNIST")
    check(len(freed) == REQUESTS["CNN-MNIST"], "finish freed the wrong tiles")
    events.append({"kind": "finish", "app": "CNN-MNIST", "tiles": freed})
    # the re-admission runs under torch.profiler: its host wall split
    profiled_admission = {}
    rep_again = admit("CNN-MNIST", REQUESTS["CNN-MNIST"], profiled=profiled_admission)
    check(events[-1]["cache_hit"], "re-admission of CNN-MNIST missed the artifact cache")
    running = ctl.running()
    tiles = [t for ts in running.values() for t in ts]
    check(len(tiles) == len(set(tiles)), "tenants share tiles under isolated placement")
    read_into("admission")
    where.update(path=None, app=None)
    engine.mcr_batch = mcr_batch
    emit({"phase": "admission", "events": events, "wall_s": time.perf_counter() - t_phase,
          "optimize_budget": list(OPTIMIZE_BUDGET), "launches": dict(ops.LAUNCHES),
          "host_syncs": kbell.COUNTS["syncs"], "profiled_admission": profiled_admission,
          "cache": ctl.cache_stats.as_dict()})

    # shared inputs of the later phases: the apps' own graphs and orders
    def candidate_stack(name, hw, n_rows, seed, shortcuts=True):
        art = ctl.artifacts[(name, DYNAP_SE_1024)]
        g = sdfg_from_clusters(art.clustered, hw=hw)
        rng = np.random.default_rng(seed)
        b = rng.integers(0, hw.n_tiles, size=(n_rows, g.n_actors))
        ob = engine.project_order_batch(art.single_order, b)
        stack = engine.stack_hardware_aware(g, b, hw, ob, relax_shortcuts=shortcuts)
        lo0 = engine.order_cycle_lower_bounds(g.exec_time, b, ob)
        return g, b, ob, stack, lo0

    # -- 3. dense Eq.-4 path --------------------------------------------
    t_phase = time.perf_counter()
    g_cnn, b_cnn, ob_cnn, st_cnn, lo_cnn = candidate_stack("CNN-MNIST", DYNAP_SE_16, BATCH, 1)
    # Eq.-4 matrices need the plain stack: shortcut edges are not dependencies
    st_plain = engine.stack_hardware_aware(g_cnn, b_cnn, DYNAP_SE_16, ob_cnn)
    where.update(path="dense", app="CNN-MNIST")
    reset()
    rep_s = engine.batch_execute(g_cnn, b_cnn, DYNAP_SE_16, ob_cnn, with_starts=True, device=dev)
    p_dense = maxplus.mcr_batch(st_cnn, backend="dense", lo0=lo_cnn, device=dev)
    t_mat = maxplus.maxplus_matrix_batch(st_plain, device=dev)
    mcm = maxplus.mcm_power_iteration(t_mat[0].cpu().numpy(), iters=64, device=dev)
    torch.cuda.synchronize()
    dense_launches = dict(ops.LAUNCHES)
    read_into("dense")
    where.update(path=None, app=None)
    p_csr = maxplus.mcr_batch(st_cnn, lo0=lo_cnn, device=dev)
    # the dense search on 8 rows, card against host: K2/K3 are bit-exact
    st8 = maxplus.EdgeStack(st_cnn.n_actors, st_cnn.src[:8], st_cnn.dst[:8],
                            st_cnn.tokens[:8], st_cnn.weights[:8])
    dense8_card = maxplus.mcr_batch(st8, backend="dense", lo0=lo_cnn[:8], device=dev)
    dense8_host = maxplus.mcr_batch(st8, backend="dense", lo0=lo_cnn[:8], device="cpu")
    starts_cpu = engine.batch_execute(
        g_cnn, b_cnn[:4], DYNAP_SE_16, engine.project_order_batch(
            ctl.artifacts[("CNN-MNIST", DYNAP_SE_1024)].single_order, b_cnn[:4]),
        with_starts=True, device="cpu").starts
    mcm_cpu = maxplus.mcm_power_iteration(t_mat[0].cpu().numpy(), iters=64, device="cpu")
    dense_rel = float(np.max(np.abs(p_dense - p_csr) / np.abs(p_csr)))
    starts_err = float(np.max(np.abs(rep_s.starts[:4] - starts_cpu)))
    check(np.isfinite(rep_s.starts).all() and rep_s.starts.shape == (BATCH, g_cnn.n_actors),
          "with_starts gave non-finite or misshapen starts")
    check(np.allclose(rep_s.periods, p_csr, rtol=1e-8), "with_starts periods differ from csr")
    # the dense backend's contract against the exact search is the
    # reference's 5e-4 (tests/test_maxplus_backends.py): float32 squaring
    # only calls a cycle positive once it grows past a 1e-4 threshold
    check(dense_rel <= 5e-4, f"dense vs csr relative error {dense_rel}")
    check(np.array_equal(dense8_card, dense8_host), "dense search differs card vs host")
    check(np.allclose(rep_s.starts[:4], starts_cpu, rtol=1e-4, atol=1e-4),
          f"starts on the card vs host differ by {starts_err}")
    check(abs(mcm - mcm_cpu) <= 1e-5 * max(1.0, abs(mcm_cpu)), f"power iteration {mcm} vs {mcm_cpu}")
    emit({"phase": "dense", "stack_B_n_E": [st_cnn.n_graphs, st_cnn.n_actors, st_cnn.n_edges],
          "dense_vs_csr_max_rel": dense_rel,
          "dense_card_equals_host_8_rows": bool(np.array_equal(dense8_card, dense8_host)), "starts_card_vs_host_max_abs": starts_err,
          "power_iteration_card": mcm, "power_iteration_host": mcm_cpu,
          "launches": dense_launches, "wall_s": time.perf_counter() - t_phase})

    # -- 4. cross-checks --------------------------------------------------
    t_phase = time.perf_counter()
    art = ctl.artifacts[("CNN-MNIST", DYNAP_SE_1024)]
    reps, walls = {}, {}

    def replay(d):
        c = runtime.AdmissionController(DYNAP_SE_1024, optimize_budget=OPTIMIZE_BUDGET, device=d)
        c.register(art.clustered)
        t = time.perf_counter()
        reps[d.type] = c.admit("CNN-MNIST", n_tiles_request=REQUESTS["CNN-MNIST"])
        torch.cuda.synchronize()
        walls[d.type] = time.perf_counter() - t

    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        replay(dev)
    replay(torch.device("cpu"))
    # device busy share of one profiled admission (kernels and copies)
    dev_us = device_us(prof)
    busy_s = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    same_binding = bool(np.array_equal(reps["cuda"].binding, reps["cpu"].binding))
    thr_rel = abs(reps["cuda"].throughput - reps["cpu"].throughput) / reps["cpu"].throughput
    check(same_binding, "CNN-MNIST binding differs between device='cuda' and device='cpu'")
    check(thr_rel <= 1e-8, f"CNN-MNIST throughput card vs host rel {thr_rel}")
    st_hc, lo_hc = solved["stack"], solved["lo0"]
    t = time.perf_counter()
    p_card = maxplus.mcr_batch(st_hc, lo0=lo_hc, device=dev)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    p_host = maxplus.mcr_batch(st_hc, backend="edges", lo0=lo_hc, device="cpu")
    host_s = time.perf_counter() - t
    live = np.isfinite(p_host)     # bucket padding adds all--inf rows
    check(np.array_equal(p_card[~live], p_host[~live]) and live.any(),
          "padding rows or live-row count differ between csr and edges")
    hc_rel = float(np.max(np.abs(p_card[live] - p_host[live]) / np.abs(p_host[live])))
    check(hc_rel <= 1e-8, f"{solved['app']} csr vs edges rel {hc_rel}")
    emit({"phase": "crosscheck", "cnn_binding_identical": same_binding,
          "cnn_throughput_rel": thr_rel,
          "cnn_admit_wall_s": walls, "cnn_admit_profiled_device_busy_s": busy_s,
          "cnn_admit_device_busy_share": busy_s / walls["cuda"],
          "cnn_admit_top_device_us": top,
          "largest_admission_stack": {"app": solved["app"], "B_n_E": [
              st_hc.n_graphs, st_hc.n_actors, st_hc.n_edges], "live_rows": int(live.sum())},
          "csr_vs_edges_max_rel": hc_rel,
          "csr_card_s": card_s, "edges_host_s": host_s,
          "wall_s": time.perf_counter() - t_phase})

    # -- 5. joint placement, the serving queue and the fault runtime ------
    t_phase = time.perf_counter()
    jctl, jnames, jrequests = joint_controller(runtime, workloads, DYNAP_SE_1024,
                                               JOINT_TENANTS, dev)
    register_s = time.perf_counter() - t_phase
    # the largest fused stack the phase solves, for phase 6
    fused_seen = {"size": -1}
    fuse_stacks = engine.fuse_stacks

    def fuse_spy(stacks):
        out = fuse_stacks(stacks)
        size = out[0].n_graphs * out[0].n_edges
        if len(stacks) > 1 and size > fused_seen["size"]:
            fused_seen.update(size=size, members=list(stacks), fused=out[0], slices=out[1])
        return out

    # one flush of the drain runs under torch.profiler
    profiled_flush, flush_no = {}, [0]
    flush_rebalances = jctl.flush_rebalances

    def flush():
        flush_no[0] += 1
        if flush_no[0] != PROFILED_FLUSH:
            return flush_rebalances()
        n, split = host_split(flush_rebalances)
        profiled_flush.update(flush=flush_no[0], coalesced_events=n, **split)
        return n

    def metrics_agree(a, b, rtol):
        if a is None or b is None:
            return a is b
        def close(x, y):
            return x == y or (math.isfinite(x) and abs(x - y) <= rtol * abs(y))
        return (a["n_resident"] == b["n_resident"]
                and set(a["app_throughputs"]) == set(b["app_throughputs"])
                and all(close(a[k], b[k]) for k in ("chip_period", "chip_throughput",
                                                     "chip_energy"))
                and all(close(v, b["app_throughputs"][n])
                        for n, v in a["app_throughputs"].items()))

    def pcts(xs):
        return ([float(np.percentile(xs, 50)), float(np.percentile(xs, 99))]
                if xs else [0.0, 0.0])

    jctl.flush_rebalances = flush
    engine.fuse_stacks = fuse_spy
    where.update(path="joint_serving", app="tenants")
    reset()
    t = time.perf_counter()
    q, qstats = drain_churn(serving, jctl, jnames, jrequests, JOINT_EVENTS)
    torch.cuda.synchronize()
    # the drain's wall leaves out the profiler's own teardown
    drain_s = time.perf_counter() - t - profiled_flush.get("profiler_s", 0.0)
    drain_events = list(jctl.events)
    drain_launches = dict(ops.LAUNCHES)
    drain_syncs = kbell.COUNTS["syncs"]
    residents_drain = len(jctl.state.allocated)
    drain_agree = metrics_agree(jctl.chip_metrics(), jctl.chip_metrics(exact=True), 1e-6)
    storm = workloads.failure_storm(JOINT_FAULTS, DYNAP_SE_1024.n_tiles, drift_apps=jnames,
                                    **JOINT_STORM)
    t = time.perf_counter()
    driven = drive_storm(jctl, storm)
    torch.cuda.synchronize()
    storm_s = time.perf_counter() - t
    storm_events = jctl.events[len(drain_events):]
    storm_agree = metrics_agree(jctl.chip_metrics(), jctl.chip_metrics(exact=True), 1e-6)
    joint_launches = dict(ops.LAUNCHES)
    joint_syncs = kbell.COUNTS["syncs"]
    read_into("joint_serving")
    where.update(path=None, app=None)
    engine.fuse_stacks = fuse_stacks
    del jctl.flush_rebalances
    rebalance_walls = [e.wall_s for e in drain_events if e.kind == "rebalance"]
    remap_bad = sum(1 for e in storm_events if e.kind == "remap" and e.seed_throughput > 0
                    and e.chip_throughput < e.seed_throughput * (1 - 1e-6))
    check(q.pending == 0 and qstats["processed"] == JOINT_EVENTS
          and all(tk.status != "pending" for tk in q.tickets),
          f"the drain processed {qstats['processed']} of {JOINT_EVENTS} tickets")
    check(regressions(drain_events) == 0, "a rebalance of the drain regressed chip throughput")
    check(remap_bad == 0, f"{remap_bad} remaps fell below their repaired seed")
    check(drain_agree, "chip_metrics() differs from chip_metrics(exact=True) after the drain")
    check(storm_agree, "chip_metrics() differs from chip_metrics(exact=True) after the storm")
    check(drain_launches["relax_round"] > 0 and joint_launches["relax_round"] > 0,
          "K1 did not launch in joint_serving")
    check(PROFILED_FLUSH <= flush_no[0] and profiled_flush, "no flush was profiled")
    check(fused_seen["size"] > 0, "joint_serving solved no fused stack")
    emit({"phase": "joint_serving", "hw": "DYNAP_SE_1024 (32x32)",
          "tenants": JOINT_TENANTS, "scale": JOINT_SCALE, "joint_budget": list(JOINT_BUDGET),
          "churn_events": JOINT_EVENTS, "coalesce_window": JOINT_WINDOW, "zipf_s": ZIPF_S,
          "storm": {"n_faults": JOINT_FAULTS, **JOINT_STORM,
                    "events": len(storm), "driven": len(driven),
                    "kinds": dict(collections.Counter(k for k, _, _ in driven)),
                    "displaced": sum(d for _, _, d in driven),
                    "dead_tiles_at_end": int(jctl.chip.dead.sum())},
          "reduced": [],
          "register_s": register_s, "drain_s": drain_s, "storm_s": storm_s,
          "admissions_per_s": qstats["admitted"] / drain_s,
          "rebalances": len(rebalance_walls),
          "rebalance_scopes": dict(collections.Counter(
              e.scope for e in drain_events if e.kind == "rebalance")),
          "rebalance_wall_p50_p99_s": pcts(rebalance_walls),
          "recovery_wall_p50_p99_s": pcts([w for _, w, _ in driven]),
          "fail_recovery_wall_p50_p99_s": pcts([w for k, w, _ in driven if k == "fail"]),
          "residents_after_drain": residents_drain,
          "residents_after_storm": len(jctl.state.allocated),
          "remaps": sum(e.kind == "remap" for e in storm_events), "remap_regressions": 0,
          "cached_vs_exact_rtol_1e-6": True,
          "largest_fused_stack_B_n_E": [fused_seen["fused"].n_graphs,
                                        fused_seen["fused"].n_actors,
                                        fused_seen["fused"].n_edges],
          "largest_fused_stack_members": len(fused_seen["members"]),
          "drain": qstats,
          "drain_launches": drain_launches, "drain_host_syncs": drain_syncs,
          "launches": joint_launches, "host_syncs": joint_syncs,
          "profiled_flush": profiled_flush,
          "wall_s": time.perf_counter() - t_phase})

    # -- 6. joint path cross-checks: card against host --------------------
    t_phase = time.perf_counter()
    hw_smoke = dataclasses.replace(DYNAP_SE, n_tiles=SMOKE_TILES)
    smoke = {}
    for key, d, backend in (("card_csr", dev, "csr"), ("host_csr", torch.device("cpu"), "csr"),
                            ("host_edges", torch.device("cpu"), "edges")):
        t = time.perf_counter()
        c, names, requests = joint_controller(runtime, workloads, hw_smoke, SMOKE_TENANTS,
                                              d, backend)
        _, st = drain_churn(serving, c, names, requests, SMOKE_EVENTS)
        driven_smoke = drive_storm(c, workloads.failure_storm(
            SMOKE_FAULTS, SMOKE_TILES, drift_apps=names, **SMOKE_STORM))
        torch.cuda.synchronize()
        smoke[key] = {"ctl": c, "stats": st, "wall_s": time.perf_counter() - t,
                      "storm_driven": len(driven_smoke)}
        check(regressions(c.events) == 0, f"{key}: a rebalance regressed chip throughput")

    def strip(ctl_):
        return [{k: v for k, v in e.items() if k != "wall_s"} for e in ctl_.trajectory()]

    def placement(ctl_):
        return {n: (r.binding.tolist(), r.orders) for n, r in ctl_.reports.items()}

    card, host, edges = (smoke[k]["ctl"] for k in ("card_csr", "host_csr", "host_edges"))
    card_traj = strip(card)
    check(card_traj == strip(host), "the card's csr trajectory differs from the host's")
    check(placement(card) == placement(host), "the card's csr bindings differ from the host's")
    check(card.chip_metrics() == host.chip_metrics()
          and card.chip_metrics(exact=True) == host.chip_metrics(exact=True),
          "chip_metrics differ between the card's and the host's csr runs")
    # every ChipMetrics field of the final placement, card against host
    check(len(card.state.allocated) > 0, "no tenant is resident after the smoke storm")
    _, _, union, order, binding, _ = card._resident_union()
    ob = engine.project_order_batch(order, binding[None, :])
    rate_scale = card._union_rate_scale(
        [card.artifacts[(n, hw_smoke)] for n in sorted(card.state.allocated)])
    (lc, pc, mc), (lh, ph, mh) = (engine.union_component_periods(
        union, binding, hw_smoke, ob, with_metrics=True, chip_state=card.chip,
        rate_scale=rate_scale, backend="csr", device=d) for d in (dev, torch.device("cpu")))
    check(np.array_equal(lc, lh) and np.array_equal(pc, ph)
          and all(np.array_equal(getattr(mc, f.name), getattr(mh, f.name))
                  for f in dataclasses.fields(mc)),
          "the final placement's component periods or ChipMetrics differ card vs host")
    # what the sharded phase's meshed replay must equal
    card_ref = {"traj": card_traj, "placement": placement(card), "metrics": card.chip_metrics(),
                "metrics_exact": card.chip_metrics(exact=True), "components": (lc, pc, mc),
                "wall_s": smoke["card_csr"]["wall_s"]}
    # the edges run: "csr" keeps another candidate where scores tie within
    # its tolerance, and the runs part there; so the card's final placement
    # is scored again by the exact host oracle
    edges_traj = strip(edges)
    same_prefix = next((i for i, (a, b) in enumerate(zip(card_traj, edges_traj))
                        if (a["kind"], a["app"], a["tiles"]) != (b["kind"], b["app"], b["tiles"])),
                       min(len(card_traj), len(edges_traj)))
    first_split = None
    if same_prefix < min(len(card_traj), len(edges_traj)):
        a, b = card_traj[same_prefix], edges_traj[same_prefix]
        first_split = {"event": same_prefix, "kind": a["kind"], "app": a["app"],
                       "csr_tiles": a["tiles"], "edges_tiles": b["tiles"]}
    m_card = card.chip_metrics(exact=True)
    card.backend, card.device = "edges", torch.device("cpu")
    m_oracle = card.chip_metrics(exact=True)
    card.backend, card.device = "csr", dev
    check(metrics_agree(m_card, m_oracle, 1e-8),
          "the card's final placement scores differently under edges (rtol 1e-8)")
    same_bindings = sum(1 for n, r in card.reports.items() if n in edges.reports
                        and np.array_equal(r.binding, edges.reports[n].binding))
    # the largest fused stack of joint_serving: each member's rows, card
    t = time.perf_counter()
    fused, members, slices = fused_seen["fused"], fused_seen["members"], fused_seen["slices"]
    p_fused = maxplus.mcr_batch(fused, device=dev)
    fused_s = time.perf_counter() - t
    fused_rel = 0.0
    for m, sl in zip(members, slices):
        own = maxplus.mcr_batch(m, device=dev)
        check(np.array_equal(p_fused[sl], own),
              "a fused member's rows differ from its own card solve")
        ref_p = maxplus.mcr_batch(m, backend="edges", device="cpu")
        fin = np.isfinite(ref_p)
        check(np.array_equal(fin, np.isfinite(own)) and np.array_equal(own[~fin], ref_p[~fin]),
              "a fused member's non-finite rows differ from edges")
        if fin.any():
            fused_rel = max(fused_rel, float(np.max(np.abs(own[fin] - ref_p[fin])
                                                     / np.abs(ref_p[fin]))))
    check(fused_rel <= 1e-8, f"fused members against edges: rel {fused_rel}")
    emit({"phase": "joint_crosscheck", "hw": f"DYNAP_SE with {SMOKE_TILES} tiles",
          "tenants": SMOKE_TENANTS, "churn_events": SMOKE_EVENTS,
          "storm": {"n_faults": SMOKE_FAULTS, **SMOKE_STORM},
          "runs": {k: {"wall_s": v["wall_s"], "events": len(v["ctl"].events),
                       "storm_driven": v["storm_driven"],
                       "admitted": v["stats"]["admitted"],
                       "residents": len(v["ctl"].state.allocated)} for k, v in smoke.items()},
          "card_equals_host_csr": {"trajectory": True, "bindings": True, "chip_metrics": True,
                                   "component_periods_and_chip_metrics_fields": True},
          "edges": {"events_equal_before_first_split": same_prefix,
                    "events": [len(card_traj), len(edges_traj)], "first_split": first_split,
                    "bindings_equal": same_bindings, "residents": len(card.reports),
                    "card_final_placement_vs_edges_oracle_rtol_1e-8": True},
          "fused": {"B_n_E": [fused.n_graphs, fused.n_actors, fused.n_edges],
                    "members": len(members), "rows_equal_own_card_solve": True,
                    "members_vs_edges_max_rel": fused_rel, "card_s": fused_s},
          "wall_s": time.perf_counter() - t_phase})
    del jctl, smoke, card, host, edges, fused, members

    # -- 7. the design-space sweep at the sweep benchmark's full size -----
    t_phase = time.perf_counter()
    swept, solves = {}, []
    build_candidates, mcr_batch = explore.build_candidates, maxplus.mcr_batch

    def build_spy(*a, **kw):
        out = build_candidates(*a, **kw)
        swept.update(graphs=out[1], aux=out[3])
        return out

    def solve_spy(stack, **kw):      # throughput_batch's grouped solves
        solves.append([stack.n_graphs, stack.n_actors, stack.n_edges])
        return mcr_batch(stack, **kw)

    explore.build_candidates, maxplus.mcr_batch = build_spy, solve_spy
    sweep_apps = apps.APP_NAMES
    where.update(path="sweep", app="sweep")
    reset()
    rep_sweep = explore.sweep(sweep_apps, tile_counts=SWEEP_TILES, binders=SWEEP_BINDERS,
                              device=dev)
    torch.cuda.synchronize()
    explore.build_candidates, maxplus.mcr_batch = build_candidates, mcr_batch
    sweep_k1 = ops.LAUNCHES["relax_round"]
    sweep_syncs = kbell.COUNTS["syncs"]
    graphs, aux = swept["graphs"], swept["aux"]
    thr = np.array([p.throughput for p in rep_sweep.points])
    # the benchmark's bar: per-graph Howard on the host within 1e-6
    t = time.perf_counter()
    rhos = np.array([maxplus.mcr_howard(g) for g in graphs])
    howard_s = time.perf_counter() - t
    thr_howard = np.where(rhos > 0, 1.0 / np.maximum(rhos, 1e-300), 0.0)
    t = time.perf_counter()
    thr_edges = explore.analyze_candidates(graphs, backend="edges", device="cpu")
    edges_s = time.perf_counter() - t
    t = time.perf_counter()
    thr_dense = explore.analyze_candidates(graphs, backend="dense", device=dev)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    check(rep_sweep.n_candidates == len(sweep_apps) * len(SWEEP_TILES) * len(SWEEP_BINDERS)
          and np.isfinite(thr).all() and (thr > 0).all(),
          f"the sweep gave {rep_sweep.n_candidates} points or a dead one")
    check(rel(thr, thr_howard) <= 1e-6, f"sweep vs Howard rel {rel(thr, thr_howard)}")
    check(rel(thr, thr_edges) <= 1e-8, f"sweep csr vs host edges rel {rel(thr, thr_edges)}")
    check(rel(thr_dense, thr_edges) <= 5e-4, f"sweep dense vs edges rel {rel(thr_dense, thr_edges)}")
    check(sweep_k1 > 0, "K1 did not launch in the sweep")
    # Pareto fronts: "csr" may order two points that tie within 1e-9 apart
    # from "edges", so each point of the card's front, scored again by the
    # host's "edges", must stay undominated (within 1e-8) by "edges"' front
    periods_e = np.where(thr_edges > 0, 1.0 / np.maximum(thr_edges, 1e-300), np.inf)
    rep_edges = explore.SweepReport(
        points=[dataclasses.replace(p, throughput=float(te), energy=float(e))
                for p, te, e in zip(rep_sweep.points, thr_edges,
                                    aux["dyn_energy"] + aux["idle_per_us"] * periods_e)],
        build_time_s=rep_sweep.build_time_s, analysis_time_s=edges_s, method="batched")
    key = {id(p): i for i, p in enumerate(rep_sweep.points)}
    fronts = {}
    for app_name in sweep_apps:
        front, front_e = rep_sweep.pareto_front(app_name), rep_edges.pareto_front(app_name)
        for p in front:
            q = rep_edges.points[key[id(p)]]
            check(not any(f.throughput > q.throughput * (1 + 1e-8)
                          and f.energy < q.energy * (1 - 1e-8) for f in front_e),
                  f"{app_name}: a card front point is dominated under edges")
        fronts[app_name] = {"card": len(front), "edges": len(front_e),
                            "same_points": [(p.n_tiles, p.binder) for p in front]
                            == [(p.n_tiles, p.binder) for p in front_e]}
    # the benchmark's speedup section: one app's candidates, one batched
    # solve on the card against the host's per-graph loops
    hw_sp = dataclasses.replace(DYNAP_SE, n_tiles=SPEEDUP_TILES)
    cl_sp = partition_greedy(apps.build_app(SPEEDUP_APP), hw_sp)
    app_sp = sdfg_from_clusters(cl_sp, hw=hw_sp)
    bindings_sp = [explore.BINDERS[b](cl_sp, hw_sp).binding for b in SWEEP_BINDERS]
    rng = np.random.default_rng(0)
    while len(bindings_sp) < SPEEDUP_CANDIDATES:
        bindings_sp.append(rng.integers(0, SPEEDUP_TILES, size=cl_sp.n_clusters))
    graphs_sp = []
    for b_sp in bindings_sp:
        orders_sp, _ = build_static_orders(app_sp, b_sp, hw_sp, iterations=8)
        graphs_sp.append(hardware_aware_sdfg(app_sp, b_sp, hw_sp, orders_sp))
    stack_sp = maxplus.stack_graphs(graphs_sp)
    t = time.perf_counter()
    rho_card = maxplus.mcr_batch(stack_sp, device=dev)
    torch.cuda.synchronize()
    speed = {"batched_card_s": time.perf_counter() - t}
    t = time.perf_counter()
    rho_bin = np.array([maxplus.mcr_binary_search(g, tol=1e-6) for g in graphs_sp])
    speed["binary_search_loop_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rho_how = np.array([maxplus.mcr_howard(g) for g in graphs_sp])
    speed["howard_loop_s"] = time.perf_counter() - t
    check(rel(rho_card, rho_how) <= 1e-6, f"speedup section: card vs Howard {rel(rho_card, rho_how)}")
    read_into("sweep")
    where.update(path=None, app=None)
    emit({"phase": "sweep", "apps": len(sweep_apps), "tile_counts": list(SWEEP_TILES),
          "binders": list(SWEEP_BINDERS), "crossbar": 128, "hw_base": "DYNAP_SE",
          "candidates": rep_sweep.n_candidates, "build_time_s": rep_sweep.build_time_s,
          "analysis_time_s": rep_sweep.analysis_time_s, "solves_B_n_E": solves,
          "vs_howard_max_rel": rel(thr, thr_howard), "vs_edges_max_rel": rel(thr, thr_edges),
          "dense_vs_edges_max_rel": rel(thr_dense, thr_edges),
          "howard_loop_s": howard_s, "edges_host_s": edges_s, "dense_card_s": dense_s,
          "pareto_fronts": fronts, "relax_round_launches": sweep_k1,
          "host_syncs": sweep_syncs,
          "speedup": {"app": SPEEDUP_APP, "candidates": len(graphs_sp),
                      "tiles": SPEEDUP_TILES, "stack_B_n_E": [
                          stack_sp.n_graphs, stack_sp.n_actors, stack_sp.n_edges],
                      **speed, "card_vs_howard_max_rel": rel(rho_card, rho_how),
                      "binary_search_vs_howard_max_rel": rel(rho_bin, rho_how),
                      "note": "walls of one call each, first call; not a claim"},
          "launches": dict(ops.LAUNCHES), "wall_s": time.perf_counter() - t_phase})
    del graphs_sp, stack_sp

    # -- 8. the sharded λ-search on streams of one card -------------------
    t_phase = time.perf_counter()
    shard_stacks = {f"{solved['app']} admission": (solved["stack"], solved["lo0"]),
                    f"sweep, {len(graphs)} rows": (maxplus.stack_graphs(graphs), None)}
    unsharded = {}
    for name, (st, lo0) in shard_stacks.items():
        kbell.reset_counts()
        t = time.perf_counter()
        p_one = maxplus.mcr_batch(st, lo0=lo0, device=dev)
        torch.cuda.synchronize()
        unsharded[name] = {"periods": p_one, "wall_s": time.perf_counter() - t,
                           "host_syncs": kbell.COUNTS["syncs"],
                           "B_n_E": [st.n_graphs, st.n_actors, st.n_edges]}
    where.update(path="sharded", app="stacks")
    reset()
    shard_runs = {name: {"unsharded": {k: v for k, v in u.items() if k != "periods"}}
                  for name, u in unsharded.items()}
    for name, (st, lo0) in shard_stacks.items():
        for k in SHARD_COUNTS:
            for run in range(SHARD_RUNS):
                syncs = kbell.COUNTS["syncs"]
                t = time.perf_counter()
                p_k = maxplus.mcr_batch(st, lo0=lo0, devices=[dev] * k)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                check(np.array_equal(p_k, unsharded[name]["periods"]),
                      f"{name}: {k} chunks on streams, run {run}, differ from the unsharded solve")
                shard_runs[name].setdefault(f"{k}_chunks", []).append(
                    {"wall_s": wall, "host_syncs": kbell.COUNTS["syncs"] - syncs})
    # joint_crosscheck's configuration again, every rebalance scored on a
    # mesh of two streams of the card: equal to that phase's card run
    where["app"] = "joint_crosscheck"
    t = time.perf_counter()
    mesh2 = Mesh((dev, dev))
    c_mesh, names, requests = joint_controller(runtime, workloads, hw_smoke, SMOKE_TENANTS,
                                               dev, "csr", mesh=mesh2)
    _, st_mesh = drain_churn(serving, c_mesh, names, requests, SMOKE_EVENTS)
    drive_storm(c_mesh, workloads.failure_storm(SMOKE_FAULTS, SMOKE_TILES, drift_apps=names,
                                                **SMOKE_STORM))
    torch.cuda.synchronize()
    mesh_wall = time.perf_counter() - t
    check(strip(c_mesh) == card_ref["traj"], "the meshed replay's trajectory differs")
    check(placement(c_mesh) == card_ref["placement"], "the meshed replay's bindings differ")
    check(c_mesh.chip_metrics() == card_ref["metrics"]
          and c_mesh.chip_metrics(exact=True) == card_ref["metrics_exact"],
          "the meshed replay's chip metrics differ")
    _, _, union, order, binding, _ = c_mesh._resident_union()
    ob = engine.project_order_batch(order, binding[None, :])
    rate_scale = c_mesh._union_rate_scale(
        [c_mesh.artifacts[(n, hw_smoke)] for n in sorted(c_mesh.state.allocated)])
    lm, pm, mm = engine.union_component_periods(
        union, binding, hw_smoke, ob, with_metrics=True, chip_state=c_mesh.chip,
        rate_scale=rate_scale, backend="csr", device=dev)
    lc, pc, mc = card_ref["components"]
    check(np.array_equal(lm, lc) and np.array_equal(pm, pc)
          and all(np.array_equal(getattr(mm, f.name), getattr(mc, f.name))
                  for f in dataclasses.fields(mc)),
          "the meshed replay's component periods or ChipMetrics fields differ")
    sharded_launches = dict(ops.LAUNCHES)
    read_into("sharded")
    where.update(path=None, app=None)
    check(sharded_launches["relax_round"] > 0, "K1 did not launch in the sharded phase")
    emit({"phase": "sharded", "chunk_counts": list(SHARD_COUNTS), "runs_each": SHARD_RUNS,
          "stacks": shard_runs, "rows_bit_identical_to_unsharded": True,
          "meshed_joint_crosscheck": {
              "mesh": [str(d) for d in mesh2.devices], "wall_s": mesh_wall,
              "unsharded_card_wall_s": card_ref["wall_s"], "events": len(c_mesh.events),
              "admitted": st_mesh["admitted"], "trajectory_bindings_metrics_equal": True,
              "component_periods_and_chip_metrics_fields_equal": True},
          "launches": sharded_launches, "host_syncs": kbell.COUNTS["syncs"],
          "wall_s": time.perf_counter() - t_phase})
    del c_mesh, shard_stacks, unsharded, card_ref

    # -- 9. export and the pipeline analysis (host) ----------------------
    t_phase = time.perf_counter()
    i_exp = next(i for i, p in enumerate(rep_sweep.points)
                 if (p.app, p.n_tiles, p.binder) == EXPORT_POINT)
    text = export.to_json(graphs[i_exp])
    g_back = export.from_json(text)
    thr_back = float(maxplus.throughput_batch([g_back], device=dev)[0])
    check(export.to_json(g_back) == text, "to_json(from_json(text)) differs from text")
    check(thr_back == rep_sweep.points[i_exp].throughput,
          f"the round-tripped graph's throughput {thr_back} differs from the sweep's "
          f"{rep_sweep.points[i_exp].throughput}")
    pipes = {}
    for arch in ARCH_NAMES:
        for n_st in PIPE_STAGES:
            r = pipeline.analyze_pipeline(get_arch(arch), n_stages=n_st,
                                          n_microbatches=PIPE_MICROBATCHES,
                                          micro_tokens=PIPE_TOKENS)
            check(math.isfinite(r.period_s) and r.period_s > 0 and r.tokens_per_s > 0,
                  f"pipeline analysis of {arch} at {n_st} stages: {r}")
            pipes.setdefault(arch, {})[n_st] = {
                "period_s": r.period_s, "bubble_frac": r.bubble_frac,
                "tokens_per_s": r.tokens_per_s, "hbm_fit": r.hbm_fit}
    emit({"phase": "export_pipeline", "graph": {
              "point": list(EXPORT_POINT), "actors": g_back.n_actors,
              "channels": g_back.n_channels, "json_chars": len(text),
              "dot_lines": export.to_dot(graphs[i_exp]).count("\n") + 1,
              "throughput_after_round_trip": thr_back, "bit_equal": True},
          "pipeline": {"constants": {"peak_flops": pipeline.PEAK_FLOPS,
                                     "link_bytes_per_s": pipeline.LINK_BW,
                                     "hbm_bytes": pipeline.HBM_BYTES,
                                     "source": "NVIDIA H100 SXM5 datasheet; model constants"},
                       "n_microbatches": PIPE_MICROBATCHES, "micro_tokens": PIPE_TOKENS,
                       "by_arch": pipes},
          "wall_s": time.perf_counter() - t_phase})
    del graphs, aux, rep_sweep, rep_edges, g_back

    # -- 10. LM serving path (main path of the LM substrate) --------------
    t_phase = time.perf_counter()
    args = tserve.parse_args([])        # the reference's defaults
    where.update(path="lm_serve", app=args.arch)
    torch.cuda.reset_peak_memory_stats()
    reset()
    cfg, params, prompts = tserve.setup(args, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    res = tserve.serve(cfg, params, prompts, args.gen_tokens, args.max_len, dev,
                       keep_prompt_logits=True)
    t = time.perf_counter()
    prefill_logits = tsteps.make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(prompts, device=dev)})
    torch.cuda.synchronize()
    prefill_step_s = time.perf_counter() - t
    # device time of a few decode steps, profiled after the run: against the
    # unprofiled step wall it says how long the card waits on the host
    step = tsteps.make_serve_step(cfg)
    cache = ttf.init_cache(cfg, args.requests, args.max_len, dtype=torch.float32, device=dev)
    tok = torch.as_tensor(prompts[:, :1], device=dev)
    step(params, cache, tok, 0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for i in range(1, 1 + PROFILED_DECODE_STEPS):
            step(params, cache, tok, i)
        torch.cuda.synchronize()
    decode_us = device_us(prof)
    decode_busy_ms = sum(decode_us.values()) / 1e3 / PROFILED_DECODE_STEPS
    del cache, prof
    serve_launches = dict(ops.LAUNCHES)
    read_into("lm_serve")
    where.update(path=None, app=None)
    check(res.tokens.shape == (args.requests, args.gen_tokens)
          and ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all(), "bad generated tokens")
    check(prefill_logits.shape == (args.requests, args.prompt_len, cfg.vocab)
          and bool(torch.isfinite(prefill_logits).all()), "prefill logits not finite")
    check(serve_launches["flash_attention"] == cfg.n_layers,
          f"the prefill step launched flash attention {serve_launches['flash_attention']} "
          f"times, not once per layer ({cfg.n_layers})")
    fwd, dec = prefill_logits.float(), res.prompt_logits.float()
    serve_err = float((fwd - dec).abs().max())
    check(bool(torch.allclose(fwd, dec, rtol=SERVE_RTOL, atol=SERVE_ATOL)),
          f"prefill vs teacher-forced decode logits differ by {serve_err}")
    first = prefill_logits[:, -1].argmax(dim=-1).cpu().numpy()
    check(np.array_equal(first, res.tokens[:, 0]),
          f"first generated tokens {res.tokens[:, 0]} are not the prefill argmax {first}")
    emit({"phase": "lm_serve", "arch": cfg.name, "params_dtype": "float32",
          "activation_dtype": str(cfg.activation_dtype), "requests": args.requests,
          "prompt_len": args.prompt_len, "gen_tokens": args.gen_tokens, "max_len": args.max_len,
          "setup_s": setup_s, "prefill_teacher_forced_s": res.prefill_s,
          "decode_s": res.decode_s, "decode_tokens_per_s": res.tokens_per_s,
          "prefill_step_s": prefill_step_s,
          "prefill_step_tokens_per_s": prompts.size / prefill_step_s,
          "prefill_vs_decode_logits_max_abs": serve_err,
          "decode_step_ms": 1e3 * res.decode_s / args.gen_tokens,
          "decode_step_device_busy_ms": decode_busy_ms,
          "decode_device_busy_share": decode_busy_ms / (1e3 * res.decode_s / args.gen_tokens),
          "decode_top_device_us": sorted(decode_us.items(), key=lambda kv: -kv[1])[:6],
          "first_token_equals_prefill_argmax": True, "sample": res.tokens[0][:16].tolist(),
          "launches": serve_launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "wall_s": time.perf_counter() - t_phase})
    del params, res, prefill_logits, fwd, dec
    torch.cuda.empty_cache()

    # -- 11. bf16 prefill at full length ------------------------------------
    t_phase = time.perf_counter()
    where["path"] = "lm_prefill"
    reset()
    prefill_runs = []
    # qwen2-1.5b at prefill_32k's length with its batch cut from 32 to 1
    for arch, seq in (("qwen2-1.5b", SHAPES["prefill_32k"]["seq_len"]),
                      ("starcoder2-3b", STARCODER2_TOKENS)):
        cfg = get_arch(arch)
        where["app"] = cfg.name
        params = ttf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                 dtype=cfg.activation_dtype)
        tokens = torch.as_tensor(
            np.random.default_rng(1).integers(0, cfg.vocab, (1, seq)), device=dev)
        before = ops.LAUNCHES["flash_attention"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        logits = tsteps.make_prefill_step(cfg)(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_flash = ops.LAUNCHES["flash_attention"] - before
        check(n_flash == cfg.n_layers, f"{arch}: {n_flash} flash launches for {cfg.n_layers} layers")
        check(logits.shape == (1, seq, cfg.vocab) and logits.dtype == cfg.activation_dtype,
              f"{arch}: logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()), f"{arch}: prefill logits not finite")
        prefill_runs.append({
            "arch": cfg.name, "tokens": [1, seq], "params_dtype": str(cfg.activation_dtype),
            "window": cfg.window, "layers": cfg.n_layers, "wall_s": wall,
            "tokens_per_s": seq / wall, "flash_launches": n_flash,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        })
        del params, tokens, logits
        torch.cuda.empty_cache()
    read_into("lm_prefill")
    where.update(path=None, app=None)
    emit({"phase": "lm_prefill", "runs": prefill_runs,
          "reduced": "batch 1 of prefill_32k's 32 (qwen2-1.5b); starcoder2-3b at 8192 tokens",
          "launches": dict(ops.LAUNCHES), "wall_s": time.perf_counter() - t_phase})

    # -- 12. SNN execution path: spike recording and the crossbar steps ---
    t_phase = time.perf_counter()
    where.update(path="snn_crossbar", app=SNN_APP)
    reset()
    snn = snns[SNN_APP]
    sim_card_s = []
    runs_card = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        runs_card.append(lif.simulate_spikes(snn, n_steps=SNN_STEPS, device=dev))
        sim_card_s.append(time.perf_counter() - t)
    sim_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(sim_launches == {"lif_record": 2},
          f"two recordings launched {sim_launches}, not lif_record once each and nothing else")
    counts_card = runs_card[0]
    draws = lif.input_draws(snn.n_neurons, SNN_STEPS, 0, dev).cpu()
    # the host's recording is the plain version, as simulate_spikes runs it
    # with device="cpu"; its last v and refr are phase 27's reference too
    t = time.perf_counter()
    host_record = ops.lif_record(*lif.snn_tensors(snn, "cpu"), draws, lif.LIFParams())
    sim_host_s = time.perf_counter() - t
    counts_host = host_record[0].numpy().astype(np.float64)
    is_in = snn.layer_of == 0
    check(np.array_equal(runs_card[1], counts_card),
          "simulate_spikes: two card runs give different counts")
    differ = int((counts_card != counts_host).sum())
    check(differ == 0, f"simulate_spikes: {differ} neurons' counts differ between card and host")
    check(counts_host[~is_in].sum() > 0, "simulate_spikes: no non-input neuron spiked")

    # the example's path over every cluster: one block each, spikes fed back
    cl = ctl.artifacts[(SNN_APP, DYNAP_SE_1024)].clustered
    t = time.perf_counter()
    blocks_np, n_inputs, n_members = crossbar_blocks(cl)
    build_s = time.perf_counter() - t
    blocks = torch.as_tensor(blocks_np, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    s0 = (torch.rand((cl.n_clusters, CROSSBAR_SAMPLES, blocks.shape[1]), generator=gen,
                     device=dev) < CROSSBAR_RATE).float()
    v0 = torch.zeros((cl.n_clusters, CROSSBAR_SAMPLES, blocks.shape[2]), device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s_k, v_k = s0, v0
    for _ in range(CROSSBAR_STEPS):       # one stacked launch a step over every block
        s_k, v_k = ops.lif_crossbar_step(s_k, blocks, v_k)
    torch.cuda.synchronize()
    crossbar_s = time.perf_counter() - t
    # examples/snn_on_tpu.py's own loop, block by block: G = 1 calls
    t = time.perf_counter()
    example = []
    for c in range(CROSSBAR_EXAMPLE_CLUSTERS):
        s_c, v_c = s0[c], v0[c]
        for _ in range(CROSSBAR_STEPS):
            s_c, v_c = ops.lif_crossbar_step(s_c, blocks[c], v_c)
        example.append((s_c, v_c))
    torch.cuda.synchronize()
    example_s = time.perf_counter() - t
    snn_launches = dict(ops.LAUNCHES)
    read_into("snn_crossbar")
    where.update(path=None, app=None)
    # simulate_spikes' card wall split, off the path: the synapses sorted and
    # copied to the card, the draws, the launch, the counts copied back
    split = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    syn_card, in_card = lif.snn_tensors(snn, dev)
    torch.cuda.synchronize()
    split["snn_tensors_s"] = time.perf_counter() - t
    t = time.perf_counter()
    draws_card = lif.input_draws(snn.n_neurons, SNN_STEPS, 0, dev)
    torch.cuda.synchronize()
    split["input_draws_s"] = time.perf_counter() - t
    t = time.perf_counter()
    counts_split = ops.lif_record(syn_card, in_card, draws_card, lif.LIFParams())[0]
    torch.cuda.synchronize()
    split["lif_record_s"] = time.perf_counter() - t
    t = time.perf_counter()
    check(np.array_equal(counts_split.cpu().numpy().astype(np.float64), counts_host),
          "the split recording's counts differ from the host's")
    split["counts_to_host_s"] = time.perf_counter() - t
    # the recording's route before lif_record, off the path: the per-step
    # eager loop around spike_input, on the same draws; a second run sees
    # each step's spikes for the share of synapses whose source fired
    torch.cuda.synchronize()
    t = time.perf_counter()
    stepwise = ref.lif_record_ref(syn_card, in_card, draws_card, lif.LIFParams(),
                                  spike_input=ops.spike_input)
    torch.cuda.synchronize()
    stepwise_s = time.perf_counter() - t
    check(all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
              for a, b in zip(stepwise, host_record)),
          "the per-step loop around spike_input differs from the host's recording")
    out_degree = torch.bincount(syn_card.pre.long(), minlength=snn.n_neurons).double()
    active_synapses = []

    def seen_spike_input(s, csr):
        active_synapses.append(float(s.double() @ out_degree))
        return ops.spike_input(s, csr)

    ref.lif_record_ref(syn_card, in_card, draws_card, lif.LIFParams(),
                       spike_input=seen_spike_input)
    active_share = [a / snn.n_synapses for a in active_synapses]
    del syn_card, in_card, draws_card, stepwise, counts_split
    k5 = snn_launches["lif_crossbar_step"]
    check(k5 == CROSSBAR_STEPS * (1 + CROSSBAR_EXAMPLE_CLUSTERS),
          f"K5 launched {k5} times, not {CROSSBAR_STEPS} stacked steps and "
          f"{CROSSBAR_EXAMPLE_CLUSTERS} clusters x {CROSSBAR_STEPS} steps of the example's loop")
    check(all(torch.equal(s_c, s_k[c]) and torch.equal(v_c, v_k[c])
              for c, (s_c, v_c) in enumerate(example)),
          "the example's G = 1 trajectories differ from the stacked step's rows")
    # the whole trajectory, all blocks at once through the plain version
    s_p, v_p = s0, v0
    for _ in range(CROSSBAR_STEPS):
        s_p, v_p = ref.lif_crossbar_step_ref(s_p, blocks, v_p)
    check(torch.equal(s_k, s_p) and torch.equal(v_k, v_p),
          "the crossbar trajectory differs from its plain version")
    emit({"phase": "snn_crossbar", "app": SNN_APP, "neurons": snn.n_neurons,
          "synapses": snn.n_synapses,
          "simulate": {"steps": SNN_STEPS, "card_s": sim_card_s, "host_s": sim_host_s,
                       "launches": sim_launches, "counts_identical_card_card_host": True,
                       "card_split": split,
                       "stepwise_loop_card_s": stepwise_s,
                       "stepwise_loop": "per-step eager ops around ops.spike_input, the "
                                        "route before lif_record; equal to the host",
                       "active_share_mean": statistics.mean(active_share),
                       "active_share_min": min(active_share),
                       "active_share_max": max(active_share),
                       "non_input_spikes": float(counts_host[~is_in].sum()),
                       "input_spikes": float(counts_host[is_in].sum())},
          "crossbar": {"n_clusters": cl.n_clusters, "samples": CROSSBAR_SAMPLES,
                       "input_rate": CROSSBAR_RATE, "steps": CROSSBAR_STEPS,
                       "build_s": build_s, "wall_s": crossbar_s,
                       "example_clusters": CROSSBAR_EXAMPLE_CLUSTERS,
                       "example_wall_s": example_s,
                       "weight_bytes": int(blocks.numel() * blocks.element_size()),
                       "max_inputs": int(n_inputs.max()), "max_members": int(n_members.max()),
                       "spikes_out": int(s_k.sum()), "plain_trajectory_identical": True,
                       "example_equals_stack_rows": True},
          "launches": snn_launches, "wall_s": time.perf_counter() - t_phase})
    del blocks, s0, v0, example, s_k, v_k, s_p, v_p

    # -- 13. jamba's hybrid serving path -----------------------------------
    # one of jamba's four 8-layer blocks: 1 GQA and 7 Mamba mixers, 4 MoE
    # and 4 SwiGLU FFNs, every layer at full width
    t_phase = time.perf_counter()
    args = tserve.parse_args(["--arch", JAMBA])
    full_cfg = get_arch(JAMBA)
    cfg = dataclasses.replace(full_cfg, stacks=((1, full_cfg.stacks[0][1]),))
    reduced_note = (f"depth: 1 of {JAMBA}'s {full_cfg.stacks[0][0]} blocks "
                    f"({cfg.n_layers} of {full_cfg.n_layers} layers), widths in full")
    n_mamba = sum(spec.mixer == "mamba" for _, specs in cfg.stacks for spec in specs)
    n_gqa = cfg.n_layers - n_mamba
    where.update(path="jamba_serve", app=cfg.name)
    torch.cuda.reset_peak_memory_stats()
    reset()
    cfg, params, prompts = tserve.setup(args, dev, cfg=cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    res = tserve.serve(cfg, params, prompts, args.gen_tokens, args.max_len, dev)
    tokens = torch.as_tensor(prompts, device=dev)
    before = dict(ops.LAUNCHES)
    t = time.perf_counter()
    prefill_logits = tsteps.make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_step_s = time.perf_counter() - t
    k7 = ops.LAUNCHES["mamba_chunk_scan"] - before["mamba_chunk_scan"]
    k6 = ops.LAUNCHES["flash_attention"] - before["flash_attention"]
    step = tsteps.make_serve_step(cfg)
    cache = ttf.init_cache(cfg, args.requests, args.max_len, dtype=torch.float32, device=dev)
    tok = tokens[:, :1]
    step(params, cache, tok, 0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for i in range(1, 1 + PROFILED_DECODE_STEPS):
            step(params, cache, tok, i)
        torch.cuda.synchronize()
    decode_us = device_us(prof)
    decode_busy_ms = sum(decode_us.values()) / 1e3 / PROFILED_DECODE_STEPS
    del cache, prof
    jamba_launches = dict(ops.LAUNCHES)
    read_into("jamba_serve")
    where.update(path=None, app=None)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(res.tokens.shape == (args.requests, args.gen_tokens)
          and ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all(), "jamba: bad generated tokens")
    check(prefill_logits.shape == (args.requests, args.prompt_len, cfg.vocab)
          and bool(torch.isfinite(prefill_logits).all()), "jamba: prefill logits not finite")
    k7_first = {k: ops.LAUNCHES[k] - before[k] for k in ("mamba_chunk_states",
                                                          "mamba_chunk_combine",
                                                          "mamba_scan_route")}
    check(k7 == n_mamba and k6 == n_gqa and not any(k7_first.values()),
          f"jamba's one-chunk prefill step launched K7 {k7}, K6 {k6} times and {k7_first}, "
          f"not {n_mamba}, {n_gqa} and none")
    # K7 in context: the first Mamba layer's prefill against its decode
    check(cfg.stacks[0][1][0].mixer == "mamba", "jamba's layer 0 is not a Mamba layer")

    lp = _first(params["stack0"]["l0"])
    with torch.no_grad():
        # the layer's input in float32: the decode casts its scan output to
        # the input's type, which in bf16 would round what the prefill keeps
        h_in = rms_norm(lp["norm1"], params["embed"][tokens].to(cfg.activation_dtype)).float()
        out_prefill = tmamba.mamba_forward(lp["mixer"], h_in, cfg)
        state = tmamba.mamba_init_state(cfg, args.requests, device=dev)
        out_decode = torch.cat([tmamba.mamba_decode(lp["mixer"], h_in[:, i:i + 1], state, cfg)[0]
                                for i in range(args.prompt_len)], dim=1)
    context_err = float((out_prefill.float() - out_decode.float()).abs().max())
    context_rms = float(out_decode.float().square().mean().sqrt())
    context_ratio = context_err / (MAMBA_CONTEXT_TOL * context_rms)
    check(context_ratio <= 1.0,
          f"the first Mamba layer's prefill differs from its decode by {context_err} "
          f"(rms {context_rms}, limit {MAMBA_CONTEXT_TOL} of it)")
    emit({"phase": "jamba_serve", "arch": cfg.name, "reduced": reduced_note,
          "layers": cfg.n_layers, "mamba_layers": n_mamba, "gqa_layers": n_gqa,
          "params": sum(t.numel() for t in _leaves(params)), "params_dtype": "float32",
          "activation_dtype": str(cfg.activation_dtype), "requests": args.requests,
          "prompt_len": args.prompt_len, "gen_tokens": args.gen_tokens, "max_len": args.max_len,
          "setup_s": setup_s, "prefill_teacher_forced_s": res.prefill_s,
          "decode_s": res.decode_s, "decode_tokens_per_s": res.tokens_per_s,
          "decode_step_ms": 1e3 * res.decode_s / args.gen_tokens,
          "decode_step_device_busy_ms": decode_busy_ms,
          "decode_device_busy_share": decode_busy_ms / (1e3 * res.decode_s / args.gen_tokens),
          "decode_top_device_us": sorted(decode_us.items(), key=lambda kv: -kv[1])[:6],
          "prefill_step_s": prefill_step_s, "prefill_step_k7_launches": k7,
          "prefill_step_k6_launches": k6,
          "mamba_context": {"max_abs_err": context_err, "decode_rms": context_rms,
                            "tol": MAMBA_CONTEXT_TOL, "tol_ratio": context_ratio},
          "sample": res.tokens[0][:16].tolist(), "launches": jamba_launches,
          "peak_gib": peak_gib,
          "wall_s": time.perf_counter() - t_phase})
    del params, res, prefill_logits, lp, h_in, out_prefill, out_decode, state
    torch.cuda.empty_cache()

    # -- 14. jamba's bf16 prefill at full length -----------------------------
    t_phase = time.perf_counter()
    where.update(path="jamba_prefill", app=cfg.name)
    seq = SHAPES["prefill_32k"]["seq_len"]
    reset()
    params = ttf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=cfg.activation_dtype)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (1, seq)), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    logits = tsteps.make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(logits.shape == (1, seq, cfg.vocab) and logits.dtype == cfg.activation_dtype,
          f"jamba: logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "jamba: bf16 prefill logits not finite")
    prefill_launches = dict(ops.LAUNCHES)
    read_into("jamba_prefill")
    where.update(path=None, app=None)
    # the Mamba layers' scan: the route kernel's device time in a second,
    # profiled run (the first one's wall stays unprofiled; this run's
    # launches are not counted)
    del logits
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        tsteps.make_prefill_step(cfg)(params, {"tokens": tokens})
        torch.cuda.synchronize()
    scan_ms = {"route": 0.0, "other_scan_kernels": 0.0}
    for key, us in device_us(prof).items():
        if "mamba_scan_route_kernel" in key:
            scan_ms["route"] += us / 1e3
        elif "mamba_chunk_" in key:
            scan_ms["other_scan_kernels"] += us / 1e3
    del prof
    scan_launches = {k: prefill_launches[k] for k in (
        "mamba_scan_route", "mamba_chunk_states", "mamba_chunk_combine", "mamba_chunk_scan")}
    check(prefill_launches["flash_attention"] == n_gqa
          and scan_launches == {"mamba_scan_route": n_mamba, "mamba_chunk_states": 0,
                                "mamba_chunk_combine": 0, "mamba_chunk_scan": 0},
          f"jamba's bf16 prefill launched K6 {prefill_launches['flash_attention']} times and "
          f"{scan_launches}, not {n_gqa} and {n_mamba} routes alone")
    emit({"phase": "jamba_prefill", "arch": cfg.name, "tokens": [1, seq],
          "reduced": reduced_note + "; batch 1 of prefill_32k's 32",
          "params_dtype": str(cfg.activation_dtype), "wall_s_prefill": wall,
          "tokens_per_s": seq / wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "launches": prefill_launches,
          "mamba_scan_device_ms": {**scan_ms, "layers": n_mamba,
                                   "source": "torch.profiler, a second run"},
          "wall_s": time.perf_counter() - t_phase})
    del params, tokens
    torch.cuda.empty_cache()

    def float32_prefill_and_decode(cfg, params, prompts, max_len):
        """The prefill step's logits and the serve loop's teacher-forced
        decode logits for ``prompts`` with float32 activations, float32.
        With bf16 activations the first layer's decode rounds its mixer's
        output to bf16 where the prefill does not (as the reference's), and
        MoE routing or the mLSTM's normaliser amplifies that rounding."""
        f32 = dataclasses.replace(cfg, dtype="float32")
        dec = tserve.serve(f32, params, prompts, 1, max_len, dev, keep_prompt_logits=True)
        fwd = tsteps.make_prefill_step(f32)(params, {"tokens": torch.as_tensor(prompts, device=dev)})
        return fwd.float(), dec.prompt_logits.float()

    # -- 15. deepseek-v3's MLA and MoE serving path --------------------------
    # one dense-prefix layer and one MoE layer of deepseek-v3 at full width,
    # float32 params from seed 0, served at the reference's defaults; no
    # kernel of ops launches (the reference's MLA and MoE reach no Pallas
    # kernel)
    t_phase = time.perf_counter()
    args = tserve.parse_args(["--arch", DEEPSEEK])
    full_cfg = get_arch(DEEPSEEK)
    cfg = dataclasses.replace(full_cfg, stacks=tuple((1, specs) for _, specs in full_cfg.stacks),
                              moe_capacity=full_cfg.moe_experts / full_cfg.moe_top_k)
    deepseek_note = (f"depth: 1 of the {full_cfg.stacks[0][0]} dense-prefix layers and 1 of the "
                     f"{full_cfg.stacks[1][0]} MoE layers ({cfg.n_layers} of {full_cfg.n_layers}), "
                     "widths in full")
    serve_note = (deepseek_note + f"; moe_capacity {cfg.moe_capacity:g} (experts / top_k: no "
                  f"token dropped, as DeepSeek-V3 serves) for the config's {full_cfg.moe_capacity}, "
                  "whose drops depend on the batch and would part prefill from decode")
    where.update(path="deepseek_serve", app=cfg.name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    cfg, params, prompts = tserve.setup(args, dev, cfg=cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    groups = collections.Counter()
    for path, t in _items(params):
        key = ("experts" if "/experts/" in path else "embed_lm_head" if path in ("embed", "lm_head")
               else "mla" if "/mixer/" in path else "dense_ffn" if path.startswith("stack0/l0/ffn")
               else "shared_router_norms")
        groups[key] += t.numel() * t.element_size()
    res = tserve.serve(cfg, params, prompts, args.gen_tokens, args.max_len, dev,
                       keep_prompt_logits=True)
    tokens = torch.as_tensor(prompts, device=dev)
    t = time.perf_counter()
    prefill_logits = tsteps.make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_step_s = time.perf_counter() - t
    step = tsteps.make_serve_step(cfg)
    cache = ttf.init_cache(cfg, args.requests, args.max_len, dtype=torch.float32, device=dev)
    step(params, cache, tokens[:, :1], 0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for i in range(1, 1 + PROFILED_DECODE_STEPS):
            step(params, cache, tokens[:, :1], i)
        torch.cuda.synchronize()
    decode_us = device_us(prof)
    decode_busy_ms = sum(decode_us.values()) / 1e3 / PROFILED_DECODE_STEPS
    del cache, prof
    # MLA in context: the first layer's decompressed prefill against its
    # absorbed decode, token by token, on a float32 input and cache
    lp = _first(params["stack0"]["l0"])
    with torch.no_grad():
        h_in = rms_norm(lp["norm1"], params["embed"][tokens].to(cfg.activation_dtype)).float()
        out_prefill = tattn.mla_forward(lp["mixer"], h_in, cfg)
        mla_cache = tattn.mla_init_cache(cfg, args.requests, args.prompt_len, torch.float32, dev)
        out_decode = torch.cat([tattn.mla_decode(lp["mixer"], h_in[:, i:i + 1], mla_cache, i, cfg)[0]
                                for i in range(args.prompt_len)], dim=1)
    fwd, dec = float32_prefill_and_decode(cfg, params, prompts, args.max_len)
    deepseek_launches = dict(ops.LAUNCHES)
    where.update(path=None, app=None)
    peak = torch.cuda.max_memory_allocated()
    check(not any(deepseek_launches.values()),
          f"deepseek-v3's serving path launched {deepseek_launches}: its MLA and MoE have no kernel")
    check(res.tokens.shape == (args.requests, args.gen_tokens)
          and ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all(), "deepseek: bad generated tokens")
    check(prefill_logits.shape == (args.requests, args.prompt_len, cfg.vocab)
          and bool(torch.isfinite(prefill_logits).all()), "deepseek: prefill logits not finite")
    serve_err = float((fwd - dec).abs().max())
    check(bool(torch.allclose(fwd, dec, rtol=SERVE_RTOL, atol=SERVE_ATOL)),
          f"deepseek: float32 prefill vs teacher-forced decode logits differ by {serve_err}")
    bf16_err = float((prefill_logits.float() - res.prompt_logits.float()).abs().max())
    mla_err = float((out_prefill - out_decode).abs().max())
    mla_rms = float(out_decode.square().mean().sqrt())
    mla_ratio = mla_err / (MLA_CONTEXT_TOL * mla_rms)
    check(mla_ratio <= 1.0, f"the first MLA layer's prefill differs from its decode by {mla_err} "
                            f"(rms {mla_rms}, limit {MLA_CONTEXT_TOL} of it)")
    step_ms = 1e3 * res.decode_s / args.gen_tokens
    # a decode step reads every weight but the embedding (8 rows of it)
    read_bytes = sum(groups.values()) - params["embed"].numel() * 4
    emit({"phase": "deepseek_serve", "arch": cfg.name, "reduced": serve_note,
          "layers": cfg.n_layers, "params": n_params, "params_dtype": "float32",
          "activation_dtype": str(cfg.activation_dtype), "requests": args.requests,
          "prompt_len": args.prompt_len, "gen_tokens": args.gen_tokens, "max_len": args.max_len,
          "setup_s": setup_s, "prefill_teacher_forced_s": res.prefill_s,
          "decode_s": res.decode_s, "decode_tokens_per_s": res.tokens_per_s,
          "decode_step_ms": step_ms, "decode_step_device_busy_ms": decode_busy_ms,
          "decode_device_busy_share": decode_busy_ms / step_ms,
          "decode_step_bound_ms": 1e3 * read_bytes / HBM_BYTES_PER_S,
          "decode_step_bound_from": "the weights but the embedding, float32, read once "
                                    "at 3.35 TB/s",
          "decode_top_device_us": sorted(decode_us.items(), key=lambda kv: -kv[1])[:8],
          "prefill_step_s": prefill_step_s,
          "prefill_vs_decode_logits_max_abs_float32": serve_err,
          "prefill_vs_decode_logits_max_abs_bf16_unchecked": bf16_err,
          "mla_context": {"max_abs_err": mla_err, "decode_rms": mla_rms, "tol": MLA_CONTEXT_TOL,
                          "tol_ratio": mla_ratio},
          "sample": res.tokens[0][:16].tolist(), "launches": deepseek_launches,
          "param_gb": {k: v / 1e9 for k, v in sorted(groups.items())},
          "init_peak_gb": init_peak / 1e9, "peak_gb": peak / 1e9,
          "wall_s": time.perf_counter() - t_phase})
    # what mesh_serve must reproduce under the LM mesh
    deepseek_ref = {"cfg": cfg, "tokens": res.tokens, "step_ms": step_ms,
                    "busy_ms": decode_busy_ms, "peak_gb": peak / 1e9}
    del params, res, prefill_logits, fwd, dec, lp, h_in, out_prefill, out_decode, mla_cache
    torch.cuda.empty_cache()

    # -- 16. deepseek-v3's bf16 prefill ---------------------------------------
    # the same two layers in bf16 params at the config's capacity, one prefill
    # step at (1, DEEPSEEK_PREFILL_TOKENS); a second run times the
    # attention's float32 einsums (_sdpa) and the MoE between CUDA events
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, moe_capacity=full_cfg.moe_capacity)
    seq = DEEPSEEK_PREFILL_TOKENS
    where.update(path="deepseek_prefill", app=cfg.name)
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = ttf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=cfg.activation_dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (1, seq)), device=dev)
    prefill = tsteps.make_prefill_step(cfg)
    t = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(logits.shape == (1, seq, cfg.vocab) and logits.dtype == cfg.activation_dtype,
          f"deepseek: logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "deepseek: bf16 prefill logits not finite")
    del logits
    prefill_launches = dict(ops.LAUNCHES)
    check(not any(prefill_launches.values()),
          f"deepseek-v3's prefill launched {prefill_launches}: its MLA and MoE have no kernel")
    peak = torch.cuda.max_memory_allocated()
    spans = {"attention_sdpa": [], "moe": []}
    sdpa, moe_forward = tattn._sdpa, tmoe.moe_forward

    def timed_span(key, fn):
        def call(*a, **kw):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            spans[key].append(ev)
            return out
        return call

    tattn._sdpa = timed_span("attention_sdpa", sdpa)
    tmoe.moe_forward = timed_span("moe", moe_forward)
    try:
        _, split = host_split(lambda: prefill(params, {"tokens": tokens}))
    finally:
        tattn._sdpa, tmoe.moe_forward = sdpa, moe_forward
    split_ms = {k: sum(a.elapsed_time(b) for a, b in evs) for k, evs in spans.items()}
    split_ms["rest"] = 1e3 * split["device_busy_s"] - sum(split_ms.values())
    where.update(path=None, app=None)
    emit({"phase": "deepseek_prefill", "arch": cfg.name, "tokens": [1, seq],
          "reduced": deepseek_note + f"; prefill_32k's batch 32 and 32768 tokens cut to 1 and {seq}",
          "params_dtype": str(cfg.activation_dtype), "moe_capacity": cfg.moe_capacity,
          "init_s": init_s, "wall_s_prefill": wall, "tokens_per_s": seq / wall,
          "peak_gb": peak / 1e9, "launches": prefill_launches,
          "device_ms": {**split_ms, "source": "CUDA events around each _sdpa and moe_forward "
                                              "call in a second, profiled run; rest: the "
                                              "profile's device busy time less both"},
          "profiled_run": split, "wall_s": time.perf_counter() - t_phase})
    del params, tokens
    torch.cuda.empty_cache()

    # -- 17. xlstm-350m's serving path -------------------------------------------
    # the whole model at full width, float32 params from seed 0, served at the
    # reference's defaults; the first sLSTM and mLSTM layers' prefill forms
    # against their decode recurrences
    t_phase = time.perf_counter()
    args = tserve.parse_args(["--arch", XLSTM])
    where.update(path="xlstm_serve", app=XLSTM)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    cfg, params, prompts = tserve.setup(args, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    res = tserve.serve(cfg, params, prompts, args.gen_tokens, args.max_len, dev,
                       keep_prompt_logits=True)
    tokens = torch.as_tensor(prompts, device=dev)
    t = time.perf_counter()
    prefill_logits = tsteps.make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_step_s = time.perf_counter() - t
    step = tsteps.make_serve_step(cfg)
    cache = ttf.init_cache(cfg, args.requests, args.max_len, dtype=torch.float32, device=dev)
    step(params, cache, tokens[:, :1], 0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        for i in range(1, 1 + PROFILED_DECODE_STEPS):
            step(params, cache, tokens[:, :1], i)
        torch.cuda.synchronize()
    decode_us = device_us(prof)
    decode_busy_ms = sum(decode_us.values()) / 1e3 / PROFILED_DECODE_STEPS
    del cache, prof
    # each layer kind's prefill form against its decode, float32
    layer_checks = {}
    for li, kind, forward_fn, decode_fn, init_fn in (
            (0, "slstm", txl.slstm_forward, txl.slstm_decode, txl.slstm_init_state),
            (1, "mlstm", txl.mlstm_forward, txl.mlstm_decode, txl.mlstm_init_state)):
        spec = cfg.stacks[0][1][li]
        check(spec.mixer == kind, f"xlstm's layer {li} is {spec.mixer}, not {kind}")
        lp = _first(params["stack0"][f"l{li}"])
        with torch.no_grad():
            h_in = rms_norm(lp["norm1"], params["embed"][tokens].float())
            out_prefill = forward_fn(lp["mixer"], h_in, cfg)
            state = init_fn(cfg, args.requests, device=dev)
            out_decode = torch.cat([decode_fn(lp["mixer"], h_in[:, i:i + 1], state, cfg)[0]
                                    for i in range(args.prompt_len)], dim=1)
        excess = (out_prefill - out_decode).abs() / (XLSTM_LAYER_ATOL
                                                     + XLSTM_LAYER_RTOL * out_decode.abs())
        layer_checks[kind] = {"layer": li, "max_abs_err": float((out_prefill - out_decode).abs().max()),
                              "atol": XLSTM_LAYER_ATOL, "rtol": XLSTM_LAYER_RTOL,
                              "tol_ratio": float(excess.max())}
    # the whole model's prefill against its teacher-forced decode, printed and
    # not checked: at random init the mLSTM's normaliser amplifies a float32
    # rounding from layer to layer and from token to token, so the reference
    # too parts its own prefill from its decode at this shape beyond its
    # recurrent-family contract (PERF.md)
    f32_fwd, f32_dec = float32_prefill_and_decode(cfg, params, prompts, args.max_len)
    xlstm_launches = dict(ops.LAUNCHES)
    where.update(path=None, app=None)
    peak = torch.cuda.max_memory_allocated()

    def recurrent_contract(fwd, dec):
        """The reference's decode-vs-forward contract for recurrent families
        (tests/test_models_smoke.py): the share of logits beyond 5e-2 +
        5e-2 |forward|, and the argmax of the first positions."""
        bad = (dec - fwd).abs() > (RECURRENT_ATOL + RECURRENT_RTOL * fwd.abs())
        lead = RECURRENT_ARGMAX_POSITIONS
        return {"diverged_share": float(bad.float().mean()),
                "first_argmax_equal": bool(torch.equal(dec[:, :lead].argmax(-1),
                                                       fwd[:, :lead].argmax(-1))),
                "max_abs": float((dec - fwd).abs().max()),
                "share_beyond_2e-2": float(((dec - fwd).abs() > SERVE_ATOL + SERVE_RTOL
                                            * fwd.abs()).float().mean())}

    whole_f32 = recurrent_contract(f32_fwd, f32_dec)
    whole_bf16 = recurrent_contract(prefill_logits.float(), res.prompt_logits.float())
    check(not any(xlstm_launches.values()),
          f"xlstm's serving path launched {xlstm_launches}: its blocks have no kernel")
    check(res.tokens.shape == (args.requests, args.gen_tokens)
          and ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all(), "xlstm: bad generated tokens")
    check(prefill_logits.shape == (args.requests, args.prompt_len, cfg.vocab)
          and bool(torch.isfinite(prefill_logits).all()), "xlstm: prefill logits not finite")
    for kind, row in layer_checks.items():
        check(row["tol_ratio"] <= 1.0, f"xlstm's {kind} prefill differs from its decode: {row}")
    step_ms = 1e3 * res.decode_s / args.gen_tokens
    emit({"phase": "xlstm_serve", "arch": cfg.name, "reduced": "nothing",
          "layers": cfg.n_layers, "params": sum(t.numel() for t in _leaves(params)),
          "params_dtype": "float32", "activation_dtype": str(cfg.activation_dtype),
          "requests": args.requests, "prompt_len": args.prompt_len,
          "gen_tokens": args.gen_tokens, "max_len": args.max_len, "setup_s": setup_s,
          "prefill_teacher_forced_s": res.prefill_s, "decode_s": res.decode_s,
          "decode_tokens_per_s": res.tokens_per_s, "decode_step_ms": step_ms,
          "decode_step_device_busy_ms": decode_busy_ms,
          "decode_device_busy_share": decode_busy_ms / step_ms,
          "decode_top_device_us": sorted(decode_us.items(), key=lambda kv: -kv[1])[:8],
          "prefill_step_s": prefill_step_s, "layer_checks": layer_checks,
          "prefill_vs_decode_unchecked": {
              "float32": whole_f32, "bf16": whole_bf16,
              "recurrent_contract": {"atol": RECURRENT_ATOL, "rtol": RECURRENT_RTOL,
                                     "share_below": RECURRENT_SHARE,
                                     "argmax_positions": RECURRENT_ARGMAX_POSITIONS}},
          "sample": res.tokens[0][:16].tolist(), "launches": xlstm_launches,
          "peak_gb": peak / 1e9, "wall_s": time.perf_counter() - t_phase})
    del params, res, prefill_logits, f32_fwd, f32_dec, lp, h_in, out_prefill
    del out_decode, state
    torch.cuda.empty_cache()

    # -- 18. xlstm-350m's bf16 prefill ---------------------------------------
    # one prefill step at (1, XLSTM_PREFILL_TOKENS) in bf16 params: 64 mLSTM
    # chunks a layer and the sLSTM's tokens one at a time; a profiled run on
    # the first XLSTM_PROFILED_TOKENS splits its wall into torch's dispatch
    # and the card's busy share
    t_phase = time.perf_counter()
    seq = XLSTM_PREFILL_TOKENS
    where.update(path="xlstm_prefill", app=cfg.name)
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = ttf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=cfg.activation_dtype)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (1, seq)), device=dev)
    prefill = tsteps.make_prefill_step(cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(logits.shape == (1, seq, cfg.vocab) and logits.dtype == cfg.activation_dtype,
          f"xlstm: logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "xlstm: bf16 prefill logits not finite")
    del logits
    prefill_launches = dict(ops.LAUNCHES)
    check(not any(prefill_launches.values()),
          f"xlstm's prefill launched {prefill_launches}: its blocks have no kernel")
    peak = torch.cuda.max_memory_allocated()
    _, split = host_split(lambda: prefill(params, {"tokens": tokens[:, :XLSTM_PROFILED_TOKENS]}))
    where.update(path=None, app=None)
    n_chunks = -(-seq // cfg.xlstm_chunk)
    n_slstm = sum(r for r, specs in cfg.stacks for spec in specs if spec.mixer == "slstm")
    emit({"phase": "xlstm_prefill", "arch": cfg.name, "tokens": [1, seq],
          "reduced": f"prefill_32k's batch 32 and 32768 tokens cut to 1 and {seq}",
          "params_dtype": str(cfg.activation_dtype), "wall_s_prefill": wall,
          "tokens_per_s": seq / wall, "mlstm_chunks_per_layer": n_chunks,
          "slstm_layers": n_slstm, "slstm_steps": n_slstm * seq, "peak_gb": peak / 1e9,
          "launches": prefill_launches, "profiled_tokens": [1, XLSTM_PROFILED_TOKENS],
          "profiled_run": split, "wall_s": time.perf_counter() - t_phase})
    del params, tokens
    torch.cuda.empty_cache()

    # -- 19. training on one device (the trainer's main path) --------------
    # launch.train.main's own loop at its defaults: a wrapper around the step
    # that make_train_step returns times each step (data excluded), counts
    # its K6 launches and profiles the last (host_split: its wall split into
    # torch's host time and the rest, and the card's busy share; the data
    # thread runs beside it); a wrapper around loss_and_grads
    # checks every layer of every gradient leaf on the card; a wrapper around
    # FlashAttentionFn's backward times the plain recompute with CUDA events
    t_phase = time.perf_counter()
    train_cfg = get_arch(TRAIN_ARCH)
    train_argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--log-every", "1"]
    train_args = ttrain.parse_args(train_argv)
    check(train_cfg.remat == "full" and train_args.opt_dtype == "float32"
          and (train_args.batch, train_args.seq_len) == (8, 256),
          "train.main's defaults are not batch 8 x seq 256, float32 moments, remat full")
    where.update(path="train", app=train_cfg.name)
    step_rows, grad_ok, bwd_events, profiled, train_final = [], [], [], {}, {}
    leaf_names, n_params = [], []
    make_train_step, loss_and_grads = tsteps.make_train_step, tsteps.loss_and_grads
    flash_backward = ops.FlashAttentionFn.backward

    def leaf_rows(tree, prefix=""):
        """(name, rows) of every leaf in tree order: one row a layer of a
        stacked leaf, one row for any other."""
        for k in sorted(tree):
            name, v = f"{prefix}/{k}", tree[k]
            if isinstance(v, dict):
                yield from leaf_rows(v, name)
            else:
                yield name, (v.flatten(1) if name.startswith("/stack") else v.reshape(1, -1))

    def checked_grads(params, batch, cfg):
        loss, grads = loss_and_grads(params, batch, cfg)
        rows = list(leaf_rows(grads))
        if not leaf_names:
            leaf_names.extend((name, i) for name, r in rows for i in range(r.shape[0]))
            n_params.append(sum(g.numel() for g in tree_leaves(grads)))
        # finite and not all zero, one flag a layer of a leaf; read after the run
        grad_ok.append(torch.cat([torch.isfinite(r).all(1) & (r != 0).any(1) for _, r in rows]))
        return loss, grads

    def timed_backward(ctx, d_o):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = flash_backward(ctx, d_o)
        b.record()
        bwd_events.append((a, b))
        return out

    def timed_steps(rows, profiled, keep, row_extra=dict):
        """A make_train_step whose steps are timed (data excluded), their K6
        launches counted and step PROFILED_TRAIN_STEP profiled by host_split,
        one row each in ``rows`` with what ``row_extra()`` adds after the
        step; ``keep(out)`` sees each step's result."""
        def make(*a, **kw):
            step_fn = make_train_step(*a, **kw)

            def step(params, opt_state, batch):
                i, k6 = len(rows), ops.LAUNCHES["flash_attention"]
                torch.cuda.synchronize()
                t = time.perf_counter()
                if i != PROFILED_TRAIN_STEP:
                    out = step_fn(params, opt_state, batch)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t
                else:
                    out, split = host_split(lambda: step_fn(params, opt_state, batch))
                    wall = split["wall_s"]
                    profiled.update(step=i, **split)
                rows.append({"step": i, "wall_s": wall, "profiled": i == PROFILED_TRAIN_STEP,
                             "k6_launches": ops.LAUNCHES["flash_attention"] - k6, **row_extra()})
                keep(out)
                return out

            return step

        return make

    def recompute_row():
        row = {"k6_backward_recompute_calls": len(bwd_events),
               "k6_backward_recompute_ms": sum(x.elapsed_time(y) for x, y in bwd_events)}
        bwd_events.clear()
        return row

    # the last step's params: what mesh_train must reproduce
    timed_make = timed_steps(step_rows, profiled, lambda out: train_final.update(params=out[0]),
                             recompute_row)
    tsteps.make_train_step, tsteps.loss_and_grads = timed_make, checked_grads
    ops.FlashAttentionFn.backward = staticmethod(timed_backward)
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_out = io.StringIO()
    try:
        with contextlib.redirect_stdout(train_out):
            losses = ttrain.main(train_argv, device=dev)
    finally:
        tsteps.make_train_step, tsteps.loss_and_grads = make_train_step, loss_and_grads
        ops.FlashAttentionFn.backward = staticmethod(flash_backward)
    train_peak = torch.cuda.max_memory_allocated()
    train_launches = dict(ops.LAUNCHES)
    read_into("train")
    where.update(path=None, app=None)
    ok = torch.stack(grad_ok).cpu()
    bad = sorted({leaf_names[j] for j in (~ok).nonzero()[:, 1].tolist()})
    check(not bad, f"gradients that are not finite or all zero (leaf, layer): {bad[:10]}")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"train losses {losses}")
    ln_vocab = math.log(train_cfg.vocab)
    check(abs(losses[0] - ln_vocab) <= TRAIN_LOSS0_TOL,
          f"step 1's loss {losses[0]} is not within {TRAIN_LOSS0_TOL} of ln(vocab) {ln_vocab}")
    # K6 per step: each GQA layer's forward, and again in remat's recompute of
    # the layer in the backward; the backward itself is the plain recompute
    k6_expected = 2 * train_cfg.n_layers
    check(all(r["k6_launches"] == k6_expected and r["k6_backward_recompute_calls"]
              == train_cfg.n_layers for r in step_rows),
          f"K6 launches a step {[r['k6_launches'] for r in step_rows]}, not {k6_expected}")
    timed_walls = [r["wall_s"] for r in step_rows[1:] if not r["profiled"]]
    step_s = statistics.mean(timed_walls)
    tokens = train_args.batch * train_args.seq_len
    n = n_params[0]
    waited = [float(m) for m in re.findall(r"waited ([0-9.]+)s for data", train_out.getvalue())]
    emit({"phase": "train", "arch": train_cfg.name, "layers": train_cfg.n_layers,
          "params": n, "params_dtype": "float32", "opt_dtype": train_args.opt_dtype,
          "activation_dtype": str(train_cfg.activation_dtype), "remat": train_cfg.remat,
          "batch": train_args.batch, "seq_len": train_args.seq_len, "steps": TRAIN_STEPS,
          "losses": losses, "ln_vocab": ln_vocab,
          "step_wall_s": step_s, "step_walls_s": [r["wall_s"] for r in step_rows],
          "step_wall_from": "mean of the unprofiled steps after the first; data excluded",
          "tokens_per_s": tokens / step_s, "data_wait_s": waited,
          "k6_launches_per_step": [r["k6_launches"] for r in step_rows],
          "k6_launches_expected": k6_expected,
          "k6_backward_recompute_ms_per_step": [r["k6_backward_recompute_ms"] for r in step_rows],
          "grad_rows_checked": len(leaf_names), "profiled_step": profiled,
          "peak_gb": train_peak / 1e9,
          "memory_reckoning_gb": {
              "params": 4 * n / 1e9, "grads": 4 * n / 1e9, "moments_m_v": 8 * n / 1e9,
              "update_outputs": 12 * n / 1e9,
              "logits": tokens * train_cfg.vocab * 4 / 1e9,
              "note": "params, grads and two float32 moments, and the functional "
                      "update's new params and moments while the old ones live; the "
                      "logits and their gradient come on top"},
          "train_log": train_out.getvalue().splitlines(),
          "launches": train_launches, "wall_s": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()

    # -- 20. training: card against host at reduced size -----------------------
    t_phase = time.perf_counter()
    where["path"] = "train_crosscheck"
    reset()
    cross = {}
    for arch in (TRAIN_ARCH, JAMBA):
        rcfg = reduced(get_arch(arch))
        where["app"] = rcfg.name
        host_p = ttf.init_params(rcfg, torch.Generator().manual_seed(0))
        card_p = tree_map(lambda t: t.to(dev), host_p)
        tb = TokenStream(DataConfig(vocab=rcfg.vocab, seq_len=CROSS_SEQ,
                                    global_batch=CROSS_BATCH)).batch(0)
        host_b = {k: torch.as_tensor(v) for k, v in tb.items()}
        before = dict(ops.LAUNCHES)
        card_loss, card_g = tsteps.loss_and_grads(card_p, {k: v.to(dev) for k, v in host_b.items()},
                                                  rcfg)
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES if ops.LAUNCHES[k] > before[k]}
        host_loss, host_g = tsteps.loss_and_grads(host_p, host_b, rcfg)
        ratios = {name: ref.grad_excess(c.cpu(), h, ref.TRAIN_GRAD_SCALE) for (name, _), c, h in zip(
            leaf_rows(host_g), tree_leaves(card_g), tree_leaves(host_g))}
        bad = [name for name, r in leaf_rows(card_g)
               if not bool(torch.isfinite(r).all() and (r != 0).any(1).all())]
        loss_rel = abs(float(card_loss) - float(host_loss)) / abs(float(host_loss))
        n_mamba = sum(r * sum(s.mixer == "mamba" for s in specs) for r, specs in rcfg.stacks)
        expected = {"flash_attention": rcfg.n_layers - n_mamba}
        if n_mamba:       # CROSS_SEQ spans two chunks: the route's one launch a layer
            expected["mamba_scan_route"] = n_mamba
        worst = max(ratios, key=ratios.get)
        cross[rcfg.name] = {"loss_card": float(card_loss), "loss_host": float(host_loss),
                            "loss_rel_err": loss_rel, "grad_tol_ratio_max": ratios[worst],
                            "grad_tol_ratio_worst_leaf": worst, "grad_leaves": len(ratios),
                            "launches": launched}
        check(launched == expected, f"{rcfg.name}: launched {launched}, not {expected}")
        check(not bad, f"{rcfg.name}: card gradients not finite or a layer all zero in {bad}")
        check(loss_rel <= 1e-5, f"{rcfg.name}: card loss {float(card_loss)} against host "
                                f"{float(host_loss)}")
        check(ratios[worst] <= 1.0, f"{rcfg.name}: gradient {worst} is {ratios[worst]} times "
                                    f"its tolerance")
        if arch == TRAIN_ARCH:
            dense = (host_p, card_p, host_g, rcfg, host_b)
        del card_p, card_g, host_g
    # one int8-moment update from the same state and gradients on both
    host_p, card_p, host_g, rcfg, host_b = dense
    opt8 = AdamWConfig(lr=1e-3, state_dtype="int8")
    state = adamw_update(host_p, host_g, adamw_init(host_p, opt8), opt8)[1]
    new_host = adamw_update(host_p, host_g, state, opt8)
    new_card = adamw_update(card_p, tree_map(lambda t: t.to(dev), host_g),
                            tree_map(lambda t: t.to(dev), state), opt8)
    # the float32 values the int8 update rounds, on the host: the same
    # update of the decoded moments with float32 state
    is_q = tadamw._is_moment_leaf
    decoded = {"step": state["step"], **{kind: tree_map(
        lambda m, p, kind=kind: tadamw._moment_read(m, p.shape, opt8, kind=kind),
        state[kind], host_p, is_leaf=is_q) for kind in ("m", "v")}}
    f32 = adamw_update(host_p, host_g, decoded, dataclasses.replace(opt8, state_dtype="float32"))[1]
    q_rows = {"q_values": 0, "q_differ": 0, "q_differ_beyond_boundary": 0,
              "max_boundary_ulps_of_a_differing_q": 0.0}
    for kind in ("m", "v"):
        for hq, cq, x in zip(tree_leaves(new_host[1][kind], is_q), tree_leaves(new_card[1][kind], is_q),
                             tree_leaves(f32[kind])):
            x = (torch.log(torch.clamp_min(x, tadamw._V_FLOOR)) if kind == "v" else x).numpy()
            pad = hq["q"].shape[-1] - x.shape[-1]
            x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
            scale = np.repeat(hq["scale"].numpy(), opt8.block, axis=-1)
            pre = x / scale                                    # the value round() takes
            # in ulps of the rounded value (of 0.5 at least: below it the
            # nearest boundary is 0.5 itself)
            ulps = np.abs(pre - np.floor(pre) - 0.5) / np.spacing(np.maximum(np.abs(pre), 0.5))
            differ = hq["q"].numpy() != cq["q"].cpu().numpy()
            q_rows["q_values"] += differ.size
            q_rows["q_differ"] += int(differ.sum())
            q_rows["q_differ_beyond_boundary"] += int((differ & (ulps > INT8_BOUNDARY_ULPS)).sum())
            if differ.any():
                q_rows["max_boundary_ulps_of_a_differing_q"] = max(
                    q_rows["max_boundary_ulps_of_a_differing_q"], float(ulps[differ].max()))
    params_err = max(float((c.cpu() - h).abs().max()) for c, h in zip(
        tree_leaves(new_card[0]), tree_leaves(new_host[0])))
    check(q_rows["q_differ_beyond_boundary"] == 0,
          f"int8 moments differ card and host away from a rounding boundary: {q_rows}")
    del new_card, new_host, decoded, f32, state
    # the same gradient twice on the card: which leaves part
    card_b = {k: v.to(dev) for k, v in host_b.items()}
    g1, g2 = (tsteps.loss_and_grads(card_p, card_b, rcfg)[1] for _ in range(2))
    parted = [name for (name, _), a, b in zip(leaf_rows(g1), tree_leaves(g1), tree_leaves(g2))
              if not torch.equal(a, b)]
    del g1, g2, dense, host_p, card_p, host_g
    # the restart at reduced size on the card: six straight steps twice, and
    # three steps, a checkpoint and three resumed steps
    smoke = ["--smoke", "--steps", str(RESTART_STEPS), "--batch", str(CROSS_BATCH),
             "--seq-len", str(CROSS_SEQ), "--log-every", str(RESTART_STEPS)]
    with contextlib.redirect_stdout(io.StringIO()), tempfile.TemporaryDirectory() as ckpt_dir:
        straight = ttrain.main(smoke, device=dev)
        again = ttrain.main(smoke, device=dev)
        ckpt = ["--ckpt-dir", ckpt_dir, "--ckpt-every", str(RESTART_STEPS // 2)]
        first = ttrain.main(smoke[:2] + [str(RESTART_STEPS // 2)] + smoke[3:] + ckpt, device=dev)
        resumed = ttrain.main(smoke + ckpt, device=dev)
    twice_equal = straight == again
    restart_equal = first + resumed == straight
    restart_rel = max(abs(a - b) / abs(b) for a, b in zip(first + resumed, straight))
    check(len(first + resumed) == RESTART_STEPS and (restart_equal or not twice_equal),
          f"the restart's losses {first + resumed} are not the straight run's {straight}, "
          "though two straight runs are equal")
    check(restart_rel <= 1e-5, f"the restart's losses lie {restart_rel} from the straight run's")
    crosscheck_launches = dict(ops.LAUNCHES)
    read_into("train_crosscheck")
    where.update(path=None, app=None)
    emit({"phase": "train_crosscheck", "models": cross,
          "grad_tolerance": {"scale": ref.TRAIN_GRAD_SCALE,
                             "rtol_row_tol_float32": ref.ATTN_TOL[torch.float32],
                             "measure": "kernels/ref.py grad_excess, the whole leaf as the row"},
          "batch": [CROSS_BATCH, CROSS_SEQ],
          "int8_update": {**q_rows, "boundary_ulps_allowed": INT8_BOUNDARY_ULPS,
                          "params_max_abs_diff": params_err},
          "same_gradient_twice_parted_leaves": parted,
          "restart": {"straight": straight, "again": again, "first": first,
                      "resumed": resumed, "straight_runs_bit_equal": twice_equal,
                      "restart_bit_equal": restart_equal, "restart_max_rel_diff": restart_rel},
          "nondeterministic_op": None if not parted else (
              "the embedding's gradient: the backward of params['embed'][tokens] "
              "accumulates rows with index_put_(accumulate=True)"
              if parted == ["/embed"] else "not identified"),
          "launches": crosscheck_launches, "wall_s": time.perf_counter() - t_phase})

    # -- 21-26. the LM mesh: one rank's world, the local (1, 1) mesh -------------
    # The phases run on DTensors over a world of one NCCL rank that the script
    # makes here and destroys after phase 26.  remesh_restore comes second:
    # it saves and restores mesh_train's state before the MoE and serve cuts
    # take the card's memory.  The wrappers' spies record no call here
    # (``where["path"]`` stays None), so phase 27 times the calls of phases
    # 2-20 as before; ops.LAUNCHES counts every launch.
    dist.init_process_group(MESH_BACKEND, store=dist.HashStore(), rank=0, world_size=1)
    mesh = tmesh.make_local_mesh()

    # -- 21. mesh_train: the train phase again under the LM mesh ------------
    # launch.train.main(mesh=) at the train phase's arguments: params and
    # moments DTensors by params_shardings / opt_state_shardings, each batch
    # by batch_shardings, the step under use_mesh; K6 runs on each rank's
    # shard through local_map
    t_phase = time.perf_counter()
    mesh_rows, mesh_profiled, mesh_final = [], {}, {}
    tsteps.make_train_step = timed_steps(
        mesh_rows, mesh_profiled, lambda out: mesh_final.update(params=out[0], opt_state=out[1]))
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mesh_losses = ttrain.main(train_argv, device=dev, mesh=mesh)
    finally:
        tsteps.make_train_step = make_train_step
    mesh_peak = torch.cuda.max_memory_allocated()
    mesh_train_launches = dict(ops.LAUNCHES)
    read_into("mesh_train")
    check(isinstance(tree_leaves(mesh_final["params"])[0], DTensor)
          and isinstance(tree_leaves(mesh_final["opt_state"]["m"])[0], DTensor),
          "mesh_train's params and moments are not DTensors")
    check(mesh_train_launches["flash_attention"] > 0, "K6 did not launch under the LM mesh")
    parted, worst_rel = [], 0.0
    for (name, _), got, want in zip(leaf_rows(train_final["params"]),
                                    tree_leaves(mesh_final["params"]),
                                    tree_leaves(train_final["params"])):
        got = tsh.full(got)
        if not torch.equal(got, want):
            rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            parted.append([name, rel])
            worst_rel = max(worst_rel, rel)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_losses, losses))
    check(len(mesh_losses) == len(losses) and loss_rel <= MESH_TRAIN_RTOL,
          f"mesh_train's losses {mesh_losses} against the train phase's {losses}")
    check(worst_rel <= MESH_TRAIN_RTOL,
          f"mesh_train's params part from the train phase's: {parted[:8]}")
    mesh_walls = [r["wall_s"] for r in mesh_rows[1:] if not r["profiled"]]
    mesh_step_s = statistics.mean(mesh_walls)
    emit({"phase": "mesh_train", "arch": train_cfg.name, "mesh": tsh.axis_sizes(mesh),
          "backend": MESH_BACKEND, "steps": len(mesh_rows), "losses": mesh_losses,
          "losses_bit_equal_to_train": mesh_losses == losses, "loss_max_rel_diff": loss_rel,
          "params_bit_equal_to_train": not parted, "rerouted_leaves": parted,
          "params_max_rel_diff": worst_rel, "tolerance_rel": MESH_TRAIN_RTOL,
          "step_wall_s": mesh_step_s, "step_walls_s": [r["wall_s"] for r in mesh_rows],
          "train_step_wall_s": step_s, "dispatch_cost_s": mesh_step_s - step_s,
          "step_wall_from": "mean of the unprofiled steps after the first; data excluded",
          "tokens_per_s": tokens / mesh_step_s,
          "k6_launches_per_step": [r["k6_launches"] for r in mesh_rows],
          "profiled_step": mesh_profiled, "peak_gb": mesh_peak / 1e9,
          "launches": mesh_train_launches, "wall_s": time.perf_counter() - t_phase})
    del train_final
    torch.cuda.empty_cache()

    # -- 22. remesh_restore: mesh_train's state onto a ("data",) mesh of one ---
    t_phase = time.perf_counter()
    state = (mesh_final["params"], mesh_final["opt_state"])
    data_mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
    restore_sh = tree_map(lambda t: tsh.NamedSharding(data_mesh, tsh._fit(
        data_mesh, t.shape, ("data",) + (None,) * (t.dim() - 1))), state)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t = time.perf_counter()
        save_checkpoint(ckpt_dir, TRAIN_STEPS, state)
        save_s = time.perf_counter() - t
        ckpt_bytes = sum(f.stat().st_size for f in pathlib.Path(ckpt_dir).rglob("*") if f.is_file())
        t = time.perf_counter()
        restored, _ = load_checkpoint(ckpt_dir, TRAIN_STEPS, state, shardings=restore_sh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    leaves_r, leaves_s = tree_leaves(restored), tree_leaves(state)
    check(all(isinstance(r, DTensor) and r.device_mesh == data_mesh for r in leaves_r),
          "the restored leaves do not lie on the data mesh")
    unequal = [i for i, (r, s0) in enumerate(zip(leaves_r, leaves_s))
               if not torch.equal(tsh.full(r), tsh.full(s0))]
    check(not unequal, f"the restore differs from mesh_train's state at leaves {unequal[:8]}")
    emit({"phase": "remesh_restore", "saved_from": tsh.axis_sizes(mesh),
          "restored_onto": tsh.axis_sizes(data_mesh), "leaves": len(leaves_r),
          "bytes": ckpt_bytes, "save_s": save_s, "load_s": load_s, "bit_equal": True,
          "wall_s": time.perf_counter() - t_phase})
    del state, restored, leaves_r, leaves_s, mesh_final
    torch.cuda.empty_cache()

    # -- 23. mesh_moe: expert parallelism against gather -----------------------
    # deepseek-moe-16b cut to its dense layer and one MoE layer at full width
    # (64 experts, top-6, 2 shared, moe_d_ff 1408), float32 params from seed
    # 0, one batch of the train phase's shape: loss and gradients through
    # _dispatch_shard_map on the (1, 1) mesh against the gather path without
    # a mesh, then one whole train step under the mesh
    t_phase = time.perf_counter()
    full_moe = get_arch(MOE_ARCH)
    # float32 activations: with the config's bf16 ones the backward rounds
    # the first layer's gradients to bf16, and the combine's last-bit
    # difference flips some of those roundings (as deepseek_serve holds its
    # two forms in float32)
    moe_cfg = dataclasses.replace(full_moe, stacks=tuple((1, sp) for _, sp in full_moe.stacks),
                                  dtype="float32")
    moe_note = (f"depth: the dense layer and 1 of the {full_moe.stacks[1][0]} MoE layers "
                f"({moe_cfg.n_layers} of {full_moe.n_layers}), widths in full; float32 "
                f"activations for the config's {full_moe.dtype}")
    torch.cuda.reset_peak_memory_stats()
    moe_params = ttf.init_params(moe_cfg, torch.Generator(device=dev).manual_seed(0))
    moe_batch = {k: torch.as_tensor(v, device=dev) for k, v in TokenStream(DataConfig(
        vocab=moe_cfg.vocab, seq_len=train_args.seq_len,
        global_batch=train_args.batch)).batch(0).items()}
    dispatched = collections.Counter()
    ep, gather = tmoe._dispatch_shard_map, tmoe._dispatch_gather

    def count(name, fn):
        def call(*a, **kw):
            dispatched[name] += 1
            return fn(*a, **kw)
        return call

    tmoe._dispatch_shard_map = count("shard_map", ep)
    tmoe._dispatch_gather = count("gather", gather)
    try:
        g_loss, g_grads = tsteps.loss_and_grads(moe_params, moe_batch, moe_cfg)
        plain_dispatch = dict(dispatched)
        d_params = tsh.distribute(moe_params, tsh.params_shardings(moe_params, mesh))
        d_batch = tsh.distribute(moe_batch, tsh.batch_shardings(moe_batch, mesh))
        dispatched.clear()
        reset()             # the gather pass above is the comparison: its launches do not count
        torch.cuda.synchronize()
        t = time.perf_counter()
        with tsh.use_mesh(mesh):
            e_loss, e_grads = tsteps.loss_and_grads(d_params, d_batch, moe_cfg)
            torch.cuda.synchronize()
            ep_grad_s = time.perf_counter() - t
            mesh_dispatch = dict(dispatched)
            grad_rel = {}
            for (name, _), a, b in zip(leaf_rows(g_grads), tree_leaves(e_grads),
                                       tree_leaves(g_grads)):
                grad_rel[name] = float((tsh.full(a) - b).abs().max()) / max(
                    float(b.abs().max()), 1e-30)
            del e_grads
            opt_m = AdamWConfig(lr=1e-3)
            st = adamw_init(moe_params, opt_m)
            d_state = tsh.distribute(st, tsh.opt_state_shardings(st, moe_params, mesh))
            new_p, new_state, m = make_train_step(moe_cfg, opt_m)(d_params, d_state, d_batch)
            step_finite = all(bool(torch.isfinite(tsh.full(x)).all()) for x in tree_leaves(new_p))
            step_loss = float(tsh.full(m["loss"]))
    finally:
        tmoe._dispatch_shard_map, tmoe._dispatch_gather = ep, gather
    moe_peak = torch.cuda.max_memory_allocated()
    moe_launches = dict(ops.LAUNCHES)
    read_into("mesh_moe")
    loss_rel = abs(float(tsh.full(e_loss)) - float(g_loss)) / abs(float(g_loss))
    worst = max(grad_rel, key=grad_rel.get)
    # (remat "full" dispatches again in the backward's recompute)
    check(set(plain_dispatch) == {"gather"} and set(mesh_dispatch) == {"shard_map"},
          f"dispatches: {plain_dispatch} without the mesh, {mesh_dispatch} under it")
    check(loss_rel <= MESH_MOE_LOSS_RTOL,
          f"mesh_moe's expert-parallel loss {float(tsh.full(e_loss))} against gather's "
          f"{float(g_loss)}")
    check(grad_rel[worst] <= MESH_MOE_GRAD_RTOL,
          f"mesh_moe: gradient {worst} differs by {grad_rel[worst]} of its largest magnitude")
    check(step_finite and abs(step_loss - float(tsh.full(e_loss))) <= MESH_MOE_LOSS_RTOL * abs(
        step_loss),
          f"mesh_moe's train step: loss {step_loss}, params finite {step_finite}")
    # the FSDP gather's backward (a reduce-scatter) through the NCCL backend:
    # on the (1, 1) mesh the experts are whole and EP gathers nothing
    w_fsdp = torch.randn(4, 6, device=dev, requires_grad=True)
    g_fsdp = torch.randn(4, 6, device=dev)
    (tmoe._AllGather.apply(w_fsdp, dist.group.WORLD, 1) * g_fsdp).sum().backward()
    check(torch.equal(w_fsdp.grad, g_fsdp), "the FSDP gather's backward on NCCL is not the "
          "identity on a world of one")
    emit({"phase": "mesh_moe", "arch": moe_cfg.name, "reduced": moe_note,
          "experts": moe_cfg.moe_experts, "top_k": moe_cfg.moe_top_k,
          "shared": moe_cfg.moe_shared, "moe_d_ff": moe_cfg.moe_d_ff, "d_model": moe_cfg.d_model,
          "params": sum(t.numel() for t in tree_leaves(moe_params)), "params_dtype": "float32",
          "batch": [train_args.batch, train_args.seq_len], "mesh": tsh.axis_sizes(mesh),
          "dispatch": {"without_mesh": plain_dispatch, "under_mesh": mesh_dispatch},
          "loss_gather": float(g_loss), "loss_expert_parallel": float(tsh.full(e_loss)),
          "loss_rel_diff": loss_rel, "loss_rtol": MESH_MOE_LOSS_RTOL,
          "grad_rel_diff_max": grad_rel[worst], "grad_rel_diff_worst_leaf": worst,
          "grad_rtol_of_leaf_max": MESH_MOE_GRAD_RTOL,
          "expert_parallel_grad_s": ep_grad_s, "train_step_loss": step_loss,
          "fsdp_gather_backward_checked": MESH_BACKEND,
          "peak_gb": moe_peak / 1e9, "launches": moe_launches,
          "wall_s": time.perf_counter() - t_phase})
    del moe_params, moe_batch, g_grads, d_params, d_batch, st, d_state, new_p, new_state, m
    torch.cuda.empty_cache()

    # -- 24. mesh_serve: deepseek-v3's serve loop under the LM mesh -----------
    # deepseek_serve's cut, params and prompts (seed 0), served with
    # serve(mesh=): weight-stationary params_shardings(inference=True),
    # inference_ep (whole experts per rank), the caches by cache_shardings
    t_phase = time.perf_counter()
    cfg = deepseek_ref["cfg"]
    args = tserve.parse_args(["--arch", DEEPSEEK])
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, prompts = tserve.setup(args, dev, cfg=cfg)
    dispatched.clear()
    ie = tmoe._dispatch_inference_ep
    tmoe._dispatch_inference_ep = count("inference_ep", ie)
    try:
        res = tserve.serve(cfg, params, prompts, args.gen_tokens, args.max_len, dev, mesh=mesh)
        serve_dispatch = dict(dispatched)
        ie_cfg = dataclasses.replace(cfg, inference_ep=True)
        d_params = tsh.distribute(params, tsh.params_shardings(params, mesh, inference=True))
        cache = ttf.init_cache(cfg, args.requests, args.max_len, dtype=torch.float32, device=dev)
        cache = tsh.distribute(cache, tsh.cache_shardings(cache, mesh))
        step = tsteps.make_serve_step(ie_cfg)
        prompt_toks = torch.as_tensor(prompts, device=dev)
        with tsh.use_mesh(mesh):
            step(d_params, cache, prompt_toks[:, :1], 0)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
            ]) as prof:
                t = time.perf_counter()
                for i in range(1, 1 + PROFILED_DECODE_STEPS):
                    step(d_params, cache, prompt_toks[:, :1], i)
                torch.cuda.synchronize()
                profiled_ms = 1e3 * (time.perf_counter() - t) / PROFILED_DECODE_STEPS
    finally:
        tmoe._dispatch_inference_ep = ie
    busy_ms = sum(device_us(prof).values()) / 1e3 / PROFILED_DECODE_STEPS
    serve_peak = torch.cuda.max_memory_allocated()
    mesh_serve_launches = dict(ops.LAUNCHES)
    read_into("mesh_serve")
    same = np.array_equal(res.tokens, deepseek_ref["tokens"])
    differ = np.argwhere(res.tokens != deepseek_ref["tokens"]).tolist()
    check(serve_dispatch.get("inference_ep", 0) > 0, f"mesh_serve dispatched {serve_dispatch}")
    check(not any(mesh_serve_launches.values()),
          f"deepseek-v3's serving path launched {mesh_serve_launches}: its MLA and MoE have no "
          "kernel")
    check(same, f"mesh_serve's tokens part from deepseek_serve's at (request, step) {differ[:8]}")
    step_ms = 1e3 * res.decode_s / args.gen_tokens
    emit({"phase": "mesh_serve", "arch": cfg.name, "reduced": deepseek_note,
          "mesh": tsh.axis_sizes(mesh), "dispatch": serve_dispatch,
          "tokens_equal_deepseek_serve": same, "sample": res.tokens[0][:16].tolist(),
          "decode_step_ms": step_ms, "deepseek_serve_decode_step_ms": deepseek_ref["step_ms"],
          "profiled_decode_step_ms": profiled_ms, "decode_step_device_busy_ms": busy_ms,
          "decode_device_busy_share": busy_ms / profiled_ms,
          "deepseek_serve_device_busy_ms": deepseek_ref["busy_ms"],
          "decode_top_device_us": sorted(device_us(prof).items(), key=lambda kv: -kv[1])[:8],
          "peak_gb": serve_peak / 1e9, "deepseek_serve_peak_gb": deepseek_ref["peak_gb"],
          "launches": mesh_serve_launches, "wall_s": time.perf_counter() - t_phase})
    del params, d_params, cache, res, prof, prompt_toks
    torch.cuda.empty_cache()

    # -- 25. abstract: shape-only init of every architecture at full size -----
    t_phase = time.perf_counter()
    # no allocation at all: the allocator's count of allocations, beside
    # memory_allocated() and its peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    allocs_before = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    counts, cells = {}, 0
    for name in ARCH_NAMES:
        acfg = get_arch(name)
        leaves = tree_leaves(ttf.init_abstract(acfg))
        check(all(t.device.type == "meta" for t in leaves), f"{name}: a leaf is not on meta")
        counts[name] = {"params": acfg.param_count(), "active_params": acfg.active_param_count(),
                        "leaves": len(leaves), "dtype": str(leaves[0].dtype)}
        for shape, info in SHAPES.items():
            specs, _ = input_specs(acfg, shape)
            check(all(t.device.type == "meta" for t in specs.values()), f"{name} {shape}")
            if info["kind"] == "decode":
                cache_leaves = tree_leaves(decode_cache_specs(acfg, shape))
                check(all(t.device.type == "meta" for t in cache_leaves), f"{name} {shape} cache")
                counts[name][f"{shape}_cache_bytes"] = sum(
                    t.numel() * t.element_size() for t in cache_leaves)
            cells += 1
    torch.cuda.synchronize()
    after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0) - allocs_before
    check(allocs == 0 and after == before == peak,
          f"the shape-only init allocated on the card: {allocs} allocations, {before} bytes "
          f"before, {after} after, {peak} at most")
    emit({"phase": "abstract", "archs": len(counts), "shape_cells": cells,
          "allocations": allocs, "memory_allocated_before": before,
          "memory_allocated_after": after, "max_memory_allocated": peak, "counts": counts,
          "wall_s": time.perf_counter() - t_phase})

    # -- 26. dryrun: the dry run's production cells, and its count of a step --
    # (a) and (c) run in child processes while (b) runs here
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])]))
    children = {}
    try:
        for arch, shape, multi_pod in DRYRUN_CELLS:
            argv = ["--arch", arch, "--shape", shape] + (["--multi-pod"] if multi_pod else [])
            children[(arch, shape, multi_pod)] = (subprocess.Popen(
                [sys.executable, "-c", DRYRUN_CHILD, *argv], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), time.perf_counter())
        children["pod_moe"] = (subprocess.Popen(
            [sys.executable, "-c", DRYRUN_POD_MOE_CHILD], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), time.perf_counter())

        # (b) the train phase's step: lower_cell's count on meta on the (1, 1)
        # mesh, and the same counting around one extra step on the card
        train_kw = dict(opt_dtype=train_args.opt_dtype, param_dtype=torch.float32,
                        batch_tokens=(train_args.batch, train_args.seq_len))
        t = time.perf_counter()
        meta_rec = tdry.lower_cell(train_cfg, "train_4k", multi_pod=False, mesh=mesh, **train_kw)
        meta_s = time.perf_counter() - t
        step_fn, step_args, _ = tdry.cell_step(
            train_cfg, "train_4k", mesh, gen=torch.Generator(device=dev).manual_seed(0), **train_kw)
        card_bytes = sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
                         for t in tree_leaves(step_args) if isinstance(t, torch.Tensor))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with tsh.use_mesh(mesh):
            card, card_out = tdry.count_step(step_fn, step_args)
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t
        card_peak = torch.cuda.max_memory_allocated()
        del step_fn, step_args, card_out
        torch.cuda.empty_cache()
        check(card["cost"]["flops"] == meta_rec["cost"]["flops"],
              f"the dry run counts {meta_rec['cost']['flops']} flops for the train step, "
              f"the card's step {card['cost']['flops']}")
        check(meta_rec["collectives"]["bytes_total"] == card["collectives"]["bytes_total"] == 0
              and not any(v for k, v in {**meta_rec["collectives"], **card["collectives"]}.items()
                          if k.startswith("count_")),
              f"a collective on a world of one: {meta_rec['collectives']}, {card['collectives']}")
        check(meta_rec["memory"]["argument_bytes"] == card["memory"]["argument_bytes"] == card_bytes,
              f"argument bytes: dry run {meta_rec['memory']['argument_bytes']}, card "
              f"{card['memory']['argument_bytes']}, the card's tensors {card_bytes}")
        device_s = mesh_profiled["device_busy_s"]

        # (c) the pod mesh's MoE cell
        proc, t_start = children["pod_moe"]
        try:
            out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"the pod-mesh MoE cell did not end in {DRYRUN_TIMEOUT_S} s")
        del children["pod_moe"]
        check(proc.returncode == 0,
              f"the pod-mesh MoE cell exited {proc.returncode}: {err[-2000:]}")
        pod_moe = json.loads(out.strip().splitlines()[-1])
        pod_moe["wall_s"] = time.perf_counter() - t_start
        check(len(pod_moe["moe"]) == pod_moe["grad_accum"] == 2 and all(
            m["y_local"] == m["y_local_of_placements"] and m["x_grad"] == [m["x"]]
            for m in pod_moe["moe"]), f"the pod-mesh MoE cell's layouts: {pod_moe['moe']}")
        check(pod_moe["allocations"] == pod_moe["max_memory_allocated"] == 0,
              f"the pod-mesh MoE cell allocated on the card: {pod_moe}")

        # (a) the production cells' records
        dry_cells = []
        for (arch, shape, multi_pod), (proc, t_start) in children.items():
            try:
                out, err = proc.communicate(timeout=max(
                    1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t_start)))
            except subprocess.TimeoutExpired:
                fail(f"the dry run of {arch} {shape} did not end in {DRYRUN_TIMEOUT_S} s")
            wall = time.perf_counter() - t_start
            check(proc.returncode == 0, f"the dry run of {arch} {shape} exited "
                  f"{proc.returncode}: {err[-2000:]}")
            alloc = json.loads(out.strip().splitlines()[-1])
            name = f"{arch}__{shape}__{'512' if multi_pod else '256'}"
            rec = json.loads((tdry.ART / f"{name}.json").read_text())
            check("error" not in rec and "skipped" not in rec,
                  f"the dry run of {name}: {rec.get('error', rec.get('skipped'))}")
            check(alloc["allocations"] == alloc["memory_allocated"]
                  == alloc["max_memory_allocated"] == 0,
                  f"the dry run of {name} allocated on the card: {alloc}")
            mem = rec["memory"]
            dry_cells.append({
                "cell": name, "mesh": rec["mesh"], "wall_s": wall, "run_s": rec["run_s"],
                "flops": rec["cost"]["flops"], "bytes_accessed": rec["cost"]["bytes_accessed"],
                "collectives": {k: v for k, v in rec["collectives"].items() if v},
                "charges": rec["charges"], "argument_bytes": mem["argument_bytes"],
                "peak_bytes": mem["peak_bytes"],
                "peak_share_of_hbm": mem["peak_bytes"] / tmesh.HW["hbm_bytes"],
                "roofline_s": rec["roofline"], "model_flops": rec["model_flops"],
                "grad_accum": rec.get("grad_accum"), "cache_len": rec.get("cache_len"),
                "child_allocator": alloc})
    finally:
        for proc, _ in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit({"phase": "dryrun", "hw_constants": tmesh.HW,
          "roofline_from": "data-sheet arithmetic: counted work over the H100 SXM's peaks",
          "cells": dry_cells, "pod_moe_cell": pod_moe,
          "train_step": {
              "arch": train_cfg.name, "batch": [train_args.batch, train_args.seq_len],
              "params_dtype": "float32", "remat": train_cfg.remat,
              "flops_counted_meta": meta_rec["cost"]["flops"],
              "flops_counted_card": card["cost"]["flops"], "flops_equal": True,
              "charges_meta": meta_rec["charges"], "charges_card": card["charges"],
              "bytes_accessed_meta": meta_rec["cost"]["bytes_accessed"],
              "bytes_accessed_card": card["cost"]["bytes_accessed"],
              "argument_bytes": meta_rec["memory"]["argument_bytes"],
              "card_tensor_bytes": card_bytes,
              "peak_bytes_estimate": meta_rec["memory"]["peak_bytes"],
              "card_max_memory_allocated": card_peak,
              "peak_estimate_over_allocator": meta_rec["memory"]["peak_bytes"] / card_peak,
              "train_phase_peak_bytes": train_peak, "mesh_train_peak_bytes": mesh_peak,
              "roofline_s": meta_rec["roofline"],
              "mesh_train_step_wall_s": mesh_step_s, "mesh_train_device_busy_s": device_s,
              "counted_flops_per_device_s": card["cost"]["flops"] / device_s,
              "rate_dtype": "float32 params, moments and activations: the bf16 peak of "
                            "t_compute_s is not this step's rate",
              "meta_count_s": meta_s, "counted_card_step_s": counted_s},
          "wall_s": time.perf_counter() - t_phase})
    dist.destroy_process_group()

    # -- 27. kernels against their plain versions --------------------------
    def timed(fn, trials=11, reps=10, warm=3):
        """Device ms per call: median over trials of CUDA-event time of
        ``reps`` back-to-back calls.  A sleep kernel first keeps the card
        busy while the host enqueues them, so the events time the device
        work and not the Python launch overhead.  A call over 10 ms is
        timed alone, 3 times."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if a.elapsed_time(b) > 10.0:
            trials, reps, warm = 3, 1, 0
        for _ in range(warm):
            fn()
        times = []
        for _ in range(trials):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    def max_abs_err(x, y):
        check(torch.equal(torch.isfinite(x), torch.isfinite(y)), "finite masks differ")
        fin = torch.isfinite(x)
        check(torch.equal(x[~fin], y[~fin]), "non-finite entries differ")
        return float((x[fin].double() - y[fin].double()).abs().max()) if fin.any() else 0.0

    def bound(nbytes, n_terms, terms_per_s):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_terms / terms_per_s
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    kernels = []

    def record(name, source, replaces, fn, plain, err, nbytes, n_terms, terms_per_s,
               library=None, tol_ratio=None, at=None, **extra):
        """One kernels-line entry: the kernel must be bit-identical to its
        plain version, or with ``tol_ratio`` (attention) at most 1.  ``at``:
        the spied call whose inputs it ran on, if not its own largest."""
        torch.cuda.synchronize()
        b_ms, b_by = bound(nbytes, n_terms, terms_per_s)
        big = at or largest[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": dict(zip(shape_of[name][0], big["shape"])),
            "inputs_from": {"path": big["path"], "app": big["app"]},
            "path_shapes": {path: {"x".join(map(str, sh)): c for sh, c in cnt.items()}
                            for path, cnt in seen[name].items()},
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            # one figure under the two names its readers look for
            "max_abs_err": err, "max_abs_diff": err, "tolerance": "bit-identical",
            "ms": timed(fn), "plain_ms": timed(plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed(library) if library is not None else None, **extra,
        })
        if tol_ratio is None:
            check(err == 0.0, f"{name} differs from its plain version by {err}")
        else:
            kernels[-1]["tol_ratio"] = tol_ratio
            check(tol_ratio <= 1.0, f"{name} is {tol_ratio} times its tolerance")

    for name in shape_of:
        check(name in largest or name in OFF_PATH,
              f"{name} was never called on the card by phases 2-20")

    def by_path(name, work_of, terms_per_s):
        """Time, bound and launches of ``name`` at each path's largest call."""
        out = {}
        for path, call in path_largest[name].items():
            args, kw = call["args"], call["kwargs"]
            nbytes, n_terms = work_of(*args, **kw)
            b_ms, b_by = bound(nbytes, n_terms, terms_per_s)
            out[path] = {
                "shape": dict(zip(shape_of[name][0], call["shape"])), "app": call["app"],
                "launches": launches[name].get(path, 0),
                "ms": timed(lambda: getattr(ops, name)(*args, **kw)),
                "bound_ms": b_ms, "bound_by": b_by,
            }
        return out

    def by_shape(name, work_of, terms_per_s, compare, extra=None, plain=None):
        """Check and time ``name`` at the first call of every distinct shape
        of each path (on a path of ``BY_SHAPE_TOP``, of its most launched
        shapes): (one row per shape, sum over the shapes of launches x (ms -
        bound ms), the launches of the shapes left out, by path, with the
        same sum estimated at the median of its timed rows' ms - bound ms).
        ``compare(args, kw)`` gives the kernel's max abs error against its
        plain version, which must be 0; ``plain(args, kw)``, where given, is
        timed too."""
        rows, total = [], 0.0
        fn = getattr(ops, name)
        top = {path: {sh for sh, _ in seen[name][path].most_common(n)}
               for path, n in BY_SHAPE_TOP.items() if path in seen[name]}
        for (path, shape), call in first_of_shape[name].items():
            if path in top and shape not in top[path]:
                continue
            args, kw = call["args"], call["kwargs"]
            err = compare(args, kw)
            check(err == 0.0, f"{name} differs from its plain version by {err} at {shape}")
            b_ms, b_by = bound(*work_of(*args), terms_per_s)
            launches = seen[name][path][shape]
            ms = timed(lambda: fn(*args, **kw))
            rows.append({
                "path": path, "app": call["app"], "shape": dict(zip(shape_of[name][0], shape)),
                "launches": launches, "max_abs_err": err, "ms": ms, "bound_ms": b_ms,
                "bound_by": b_by, **(extra(*args) if extra else {}),
                **({"plain_ms": timed(lambda: plain(args, kw))} if plain else {}),
            })
            total += launches * (ms - b_ms)
        left_out = {}
        for path, shapes in top.items():
            excess = [r["ms"] - r["bound_ms"] for r in rows if r["path"] == path]
            n = sum(c for sh, c in seen[name][path].items() if sh not in shapes)
            left_out[path] = {"shapes": len(seen[name][path]) - len(shapes), "launches": n,
                              "est_ms": n * statistics.median(excess)}
        return rows, total, left_out

    def k1_compare(name, plain_fn):
        def compare(args, kw):
            out, plain = getattr(ops, name)(*args), plain_fn(*args)
            if name == "relax_round":
                return max_abs_err(out, plain)
            check(torch.equal(out[1], plain[1]), f"{name} psrc differs from its plain version")
            return max_abs_err(out[0], plain[0])
        return compare

    def in_degree(dist, lams, csr):
        deg = torch.diff(csr.indptr.long())
        return {"in_degree_mean": float(deg.double().mean()), "in_degree_max": int(deg.max())}

    def k1_work(witness):
        def work_of(dist, lams, csr):
            nk, k = dist.shape
            e = int(csr.src.numel())
            # row pointers, per edge src/w/t, each node's dist row, lams; best
            # (and psrc) out
            nbytes = (nk + 1) * 4 + e * (4 + 8 + 8) + nk * k * 8 + lams.numel() * 8 \
                + nk * k * 8 * (2 if witness else 1)
            return nbytes, e * k
        return work_of

    # K1 on the inputs of its largest admission call (HeartClass's stack)
    for name, plain_fn in (("relax_round", ref.segment_relax_ref),
                           ("relax_round_witness", ref.segment_relax_witness_ref)):
        dist, lams, csr = largest[name]["args"]
        kern_fn = getattr(ops, name)
        k = dist.shape[1]
        e = int(csr.src.numel())
        nbytes = k1_work(name == "relax_round_witness")(dist, lams, csr)[0]
        library = None
        if name == "relax_round":
            cand = dist[csr.src.long()] + (csr.w[:, None] - lams[csr.dst_row] * csr.t[:, None])
            idx = csr.dst[:, None].expand_as(cand)
            out = torch.full_like(dist, float("-inf"))
            err = max_abs_err(kern_fn(dist, lams, csr), plain_fn(dist, lams, csr))
            library = lambda: out.scatter_reduce(0, idx, cand, "amax", include_self=True)  # noqa: E731
        else:
            bw, pw = kern_fn(dist, lams, csr)
            br, pr = plain_fn(dist, lams, csr)
            check(torch.equal(pw, pr), "relax_round_witness psrc differs from its plain version")
            err = max_abs_err(bw, br)
        record(name, "src/repro_torch/csrc/relax_round.cu",
               "src/repro/kernels/maxplus_bellman.py:116",
               lambda: kern_fn(dist, lams, csr), lambda: plain_fn(dist, lams, csr),
               err, nbytes, e * k, RELAX_TERMS_PER_S, library=library)
        kernels[-1]["by_path"] = by_path(name, k1_work(name == "relax_round_witness"),
                                         RELAX_TERMS_PER_S)
        rows, timed_ms, left_out = by_shape(
            name, k1_work(name == "relax_round_witness"), RELAX_TERMS_PER_S,
            k1_compare(name, plain_fn), extra=in_degree)
        kernels[-1].update(by_shape=rows, rule2_timed_ms=timed_ms, by_shape_left_out=left_out,
                           rule2_ms=timed_ms + sum(v["est_ms"] for v in left_out.values()))

    # K2, K3 and the G = 1 matmul on the inputs of their largest dense-path call
    for name, replaces, plain_fn in (
        ("maxplus_bmm", "src/repro/kernels/maxplus_matmul.py:217", ref.maxplus_bmm_ref),
        ("maxplus_bmv", "src/repro/kernels/maxplus_matmul.py:173", ref.maxplus_bmv_ref),
        ("maxplus_matmul", "src/repro/kernels/maxplus_matmul.py:83", ref.maxplus_matmul_ref),
    ):
        a, b = largest[name]["args"]
        kern_fn = getattr(ops, name)
        out_numel = kern_fn(a, b).numel()
        record(name, "src/repro_torch/csrc/maxplus_matmul.cu", replaces,
               lambda: kern_fn(a, b), lambda: plain_fn(a, b),
               max_abs_err(kern_fn(a, b), plain_fn(a, b)),
               (a.numel() + b.numel() + out_numel) * 4, largest[name]["work"],
               MAXPLUS_TERMS_PER_S)
        if name == "maxplus_bmm":       # launched at many shapes by the sweep's groups
            kernels[-1]["by_shape"], kernels[-1]["rule2_ms"], _ = by_shape(
                name, lambda x, y: ((x.numel() + y.numel() + x.shape[0] * x.shape[1]
                                     * y.shape[2]) * 4, math.prod(x.shape) * y.shape[2]),
                MAXPLUS_TERMS_PER_S,
                lambda args, kw: max_abs_err(ops.maxplus_bmm(*args), plain_fn(*args)))

    # K6 on the inputs of its largest call (jamba's 32k GQA layer), and
    # checked at its largest float32, windowed and lm_prefill calls
    def flash_work(q, k, causal, window):
        """(bytes of q, k, v and o; operations; their peak rate) of the
        body q's type takes.  The flops are ``kernels/work.py``'s (the dry
        run's charge): bf16 at the tensor cores' bf16 rate; float32 as the
        3xTF32 body issues them, three TF32 products per float32 product at
        TF32's rate."""
        nbytes, flops = kwork.flash_work(q, k, causal=causal, window=window)
        if q.dtype == torch.bfloat16:
            return nbytes, flops, BF16_FLOPS_PER_S
        return nbytes, 3 * flops, TF32_FLOPS_PER_S

    def sdpa_for(q, k, v, kw):
        """The library yardstick, timed here only: one
        ``F.scaled_dot_product_attention`` call for the same masks, as (call,
        its description, None), or (None, None, why) where no backend takes
        it.  A causal unwindowed call goes to the flash backend (the math
        backend would materialise the (Sq, Skv) scores), else to the
        memory-efficient one; a window goes to the memory-efficient backend
        with a boolean (Sq, Skv) mask.  k and v are expanded to Hq heads
        before the timed call where a backend refuses ``enable_gqa``."""
        mask = None
        plans = [(SDPBackend.EFFICIENT_ATTENTION, "memory-efficient")]
        if kw["causal"] and not kw["window"]:
            plans.insert(0, (SDPBackend.FLASH_ATTENTION, "flash"))
        else:
            i = torch.arange(q.shape[2], device=q.device)[:, None]
            j = torch.arange(k.shape[2], device=q.device)[None, :]
            mask = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool, device=q.device)
            if kw["causal"]:
                mask &= i >= j
            if kw["window"] > 0:
                mask &= (i - j) < kw["window"]
        group = q.shape[1] // k.shape[1]
        refused = []
        for backend, backend_name in plans:
            for gqa in (True, False):
                kk, vv = (k, v) if gqa else (k.repeat_interleave(group, 1),
                                             v.repeat_interleave(group, 1))

                def sdpa(kk=kk, vv=vv, gqa=gqa, backend=backend):
                    with sdpa_kernel([backend]):
                        return F.scaled_dot_product_attention(
                            q, kk, vv, attn_mask=mask, is_causal=mask is None, enable_gqa=gqa)
                try:
                    sdpa()
                    torch.cuda.synchronize()
                except RuntimeError as e:     # this backend takes no such call
                    refused.append(f"{backend_name}, enable_gqa={gqa}: "
                                   + str(e).splitlines()[0][:200])
                    continue
                return sdpa, (
                    "F.scaled_dot_product_attention("
                    + ("is_causal=True" if mask is None else "attn_mask=bool (Sq, Skv)")
                    + (", enable_gqa=True" if gqa else "; k, v expanded to Hq heads")
                    + f"), {backend_name} backend"), None
        return None, None, "; ".join(refused)

    def flash_case(key, call):
        """(the comparison's row, the call's inputs, yardstick and work).
        ``library_tol_ratio`` reads the yardstick against the plain version
        by the same measure: a printed reading, not a check."""
        q, k, v = call["args"]
        kw = {"causal": call["kwargs"].get("causal", True), "window": call["kwargs"].get("window", 0)}
        out, plain = ops.flash_attention(q, k, v, **kw), ref.attention_ref(q, k, v, **kw)
        err, excess = max_abs_err(out, plain), ref.attention_excess(out, plain)
        del out
        sdpa, library_call, library_error = sdpa_for(q, k, v, kw)
        library_ratio = ref.attention_excess(sdpa(), plain) if sdpa is not None else None
        del plain
        rtol, row_tol = ref.ATTN_TOL[q.dtype]
        return {
            "call": key, "path": call["path"], "app": call["app"],
            "dtype": str(q.dtype).split(".")[-1], **kw,
            "shape": dict(zip(shape_of["flash_attention"][0], call["shape"])),
            "max_abs_err": err, "tol_ratio": excess,
            "tolerance": {"rtol": rtol, "row_tol": row_tol},
            "library_call": library_call, "library_tol_ratio": library_ratio,
            "library_error": library_error,
        }, (q, k, v, kw, sdpa, *flash_work(q, k, **kw))

    for key in ("float32", "windowed", "lm_prefill", "train"):
        check(key in flash_largest, f"flash attention had no {key} call in phases 10-20")
    cases = {key: flash_case(key, call) for key, call in
             (("largest", largest["flash_attention"]), *flash_largest.items())}
    emit({"phase": "flash_checks", "checks": [row for row, _ in cases.values()]})
    for key, (row, _) in cases.items():
        check(row["tol_ratio"] <= 1.0,
              f"flash attention ({key} call) is {row['tol_ratio']} times its tolerance "
              f"(max abs err {row['max_abs_err']})")
    # the plain version and SDPA run with TF32 off (set in phase 1:
    # allow_tf32 False, float32 matmul precision "highest")
    for key in ("float32", "windowed", "lm_prefill", "train"):
        row, (q, k, v, kw, sdpa, nbytes, flops, peak) = cases[key]
        row.update(ms=timed(lambda: ops.flash_attention(q, k, v, **kw)),
                   plain_ms=timed(lambda: ref.attention_ref(q, k, v, **kw)),
                   bound_ms=bound(nbytes, flops, peak)[0],
                   library_ms=timed(sdpa) if sdpa is not None else None,
                   plain_tf32=torch.backends.cuda.matmul.allow_tf32)
        if q.dtype == torch.float32:   # the bound of a body of CUDA-core FMAs
            row["bound_ms_cuda_cores"] = bound(
                *kwork.flash_work(q, k, causal=kw["causal"], window=kw["window"]),
                FP32_FLOPS_PER_S)[0]
    # the train step's backward of K6: the plain attention recomputed and
    # differentiated (FlashAttentionFn.backward), at the train call's inputs
    row, (q, k, v, kw, *_) = cases["train"]
    q_g, k_g, v_g = (t.detach().requires_grad_() for t in (q, k, v))
    d_o = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)

    def recompute_backward():
        return torch.autograd.grad(ref.attention_ref(q_g, k_g, v_g, **kw), (q_g, k_g, v_g), d_o)

    row["backward_recompute_ms"] = timed(recompute_backward)
    del q_g, k_g, v_g, d_o
    row, (q, k, v, kw, sdpa, nbytes, flops, peak) = cases["largest"]
    record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:130",
           lambda: ops.flash_attention(q, k, v, **kw), lambda: ref.attention_ref(q, k, v, **kw),
           row["max_abs_err"], nbytes, flops, peak, library=sdpa, tol_ratio=row["tol_ratio"],
           tolerance=row["tolerance"], checks=[r for r, _ in cases.values()],
           library_call=row["library_call"], library_tol_ratio=row["library_tol_ratio"],
           library_error=row["library_error"])
    del q, k, v, sdpa, cases

    # K5 on the inputs of its largest call (the stacked step over every
    # HeartClass block), and at each shape's first call (the stack and the
    # example's G = 1 call)
    def k5_work(s, w, v, **kw):
        # s, W and v in; spikes and v out; a multiply-add per term
        return (s.numel() + w.numel() + 3 * v.numel()) * 4, 2 * v.numel() * s.shape[-1]

    def k5_compare(args, kw):
        (ks, kv), (ps, pv) = ops.lif_crossbar_step(*args, **kw), \
            ref.lif_crossbar_step_ref(*args, **kw)
        return max(max_abs_err(ks, ps), max_abs_err(kv, pv))

    s_in, w_in, v_in = largest["lif_crossbar_step"]["args"]
    kw5 = largest["lif_crossbar_step"]["kwargs"]
    record("lif_crossbar_step", "src/repro_torch/csrc/lif_crossbar.cu",
           "src/repro/kernels/lif_crossbar.py:87",
           lambda: ops.lif_crossbar_step(s_in, w_in, v_in, **kw5),
           lambda: ref.lif_crossbar_step_ref(s_in, w_in, v_in, **kw5),
           k5_compare((s_in, w_in, v_in), kw5), *k5_work(s_in, w_in, v_in),
           FP32_FLOPS_PER_S,
           library_note="none: no single PyTorch call computes a product fused "
                        "with the threshold and reset")
    kernels[-1]["by_shape"], kernels[-1]["rule2_ms"], _ = by_shape(
        "lif_crossbar_step", k5_work, FP32_FLOPS_PER_S, k5_compare,
        plain=lambda args, kw: ref.lif_crossbar_step_ref(*args, **kw))
    del s_in, w_in, v_in, first_of_shape

    # The scan's route on the inputs of its largest call: jamba's first Mamba
    # layer of the bf16 32k prefill.  Its yardstick is the three launches it
    # replaced (the states pass, the combine, K7 from the combined states),
    # which it must equal bit for bit; each of the three is checked and
    # timed on the same inputs, off the path.
    at7 = largest["mamba_scan_route"]
    x7, dt7, a7, b7, c7 = at7["args"]
    chunk7 = at7["kwargs"].get("chunk", 128)
    rtol7, row_tol7 = ref.SCAN_TOL[torch.float32]
    terms7 = x7.shape[0] * x7.shape[1] * x7.shape[2] * a7.shape[1]
    zeros7 = torch.zeros((x7.shape[0], -(-x7.shape[1] // chunk7), x7.shape[2], a7.shape[1]),
                         device=dev)

    def three_launches():
        s = ops.mamba_chunk_states(x7, dt7, a7, b7, chunk=chunk7)
        y, h = ops.mamba_chunk_scan(x7, dt7, a7, b7, c7,
                                    ops.mamba_chunk_combine(dt7, a7, s, chunk=chunk7),
                                    chunk=chunk7)
        return y, h[:, -1]

    ry, rh = ops.mamba_scan_route(x7, dt7, a7, b7, c7, chunk=chunk7)
    ty, th = three_launches()
    equals_three = bool(torch.equal(ry, ty) and torch.equal(rh, th))
    del ty, th
    py, ph = ref.mamba_route_ref(x7, dt7, a7, b7, c7, chunk=chunk7)
    route = {"route_y_tol_ratio": ref.scan_excess(ry, py, chunk7),
             "route_state_tol_ratio": ref.state_excess(rh, ph),
             "route_bit_identical": bool(torch.equal(ry, py) and torch.equal(rh, ph))}
    r_err = max(max_abs_err(ry, py), max_abs_err(rh, ph))
    del ry, rh, py, ph
    check(equals_three, "the route differs from the three launches on the card")
    record("mamba_scan_route", "src/repro_torch/csrc/mamba_scan.cu",
           "src/repro/kernels/mamba_scan.py:96",
           lambda: ops.mamba_scan_route(x7, dt7, a7, b7, c7, chunk=chunk7),
           lambda: ref.mamba_route_ref(x7, dt7, a7, b7, c7, chunk=chunk7),
           r_err, *kwork.route_work(x7, a7, b7, chunk=chunk7), FP32_FLOPS_PER_S,
           tol_ratio=max(route["route_y_tol_ratio"], route["route_state_tol_ratio"]),
           tolerance={"rtol": ref.SCAN_TOL[x7.dtype][0], "row_tol": ref.SCAN_TOL[x7.dtype][1],
                      "state_rtol": rtol7, "state_row_tol": row_tol7},
           equals_three_launch_route=equals_three, three_launch_ms=timed(three_launches),
           **route, dtype=str(x7.dtype).split(".")[-1], chunk=chunk7, expf=terms7,
           expf_bound_ms=1e3 * terms7 / EX2_PER_S,
           replaces_note="the reference's ops.mamba_scan: its two Pallas launches of "
                         "mamba_chunk_scan and the lax.scan combine between them",
           library_note="none: no single PyTorch call computes a selective scan")
    kernels[-1]["by_path"] = by_path(
        "mamba_scan_route",
        lambda x, dt, a, b, c, chunk=128: kwork.route_work(x, a, b, chunk=chunk),
        FP32_FLOPS_PER_S)

    # K7's states-only pass from zero states: equal to the plain version's
    # states and to the full launch's
    ks = ops.mamba_chunk_states(x7, dt7, a7, b7, chunk=chunk7)
    ps = ref.mamba_chunk_scan_ref(x7, dt7, a7, b7, b7, zeros7, chunk=chunk7)[1]
    s_ratio, s_err = ref.state_excess(ks, ps), max_abs_err(ks, ps)
    states_equal_full = bool(torch.equal(ks, ops.mamba_chunk_scan(
        x7, dt7, a7, b7, b7, zeros7, chunk=chunk7)[1]))
    check(states_equal_full, "the states-only pass differs from the full launch's states")
    check(s_ratio == 0.0, f"the states-only pass is {s_ratio} times the state's limit, not 0")
    record("mamba_chunk_states", "src/repro_torch/csrc/mamba_scan.cu",
           "src/repro/kernels/mamba_scan.py:96",
           lambda: ops.mamba_chunk_states(x7, dt7, a7, b7, chunk=chunk7),
           lambda: ref.mamba_chunk_scan_ref(x7, dt7, a7, b7, b7, zeros7, chunk=chunk7),
           s_err, *kwork.states_work(x7, a7, b7, chunk=chunk7), FP32_FLOPS_PER_S,
           tol_ratio=s_ratio, at=at7, on_main_path=False,
           tolerance={"state_rtol": rtol7, "state_row_tol": row_tol7, "limit": 0.0},
           equals_full_launch_states=states_equal_full,
           dtype=str(x7.dtype).split(".")[-1], chunk=chunk7,
           expf_bound_ms=1e3 * terms7 / EX2_PER_S,
           library_note="none: no single PyTorch call computes a selective scan")

    # the combine on those states
    kc, pc = (ops.mamba_chunk_combine(dt7, a7, ks, chunk=chunk7),
              ref.mamba_combine_ref(dt7, a7, ks, chunk=chunk7))
    c_ratio, c_err = ref.state_excess(kc, pc), max_abs_err(kc, pc)
    del pc, ps
    record("mamba_chunk_combine", "src/repro_torch/csrc/mamba_scan.cu",
           "src/repro/kernels/ops.py:219",
           lambda: ops.mamba_chunk_combine(dt7, a7, ks, chunk=chunk7),
           lambda: ref.mamba_combine_ref(dt7, a7, ks, chunk=chunk7),
           c_err, *kwork.combine_work(dt7, a7, ks), FP32_FLOPS_PER_S, tol_ratio=c_ratio,
           at=at7, on_main_path=False,
           tolerance={"state_rtol": rtol7, "state_row_tol": row_tol7}, chunk=chunk7,
           replaces_note="not a Pallas kernel: the lax.scan combine of the reference's "
                         "ops.mamba_scan, between its two Pallas launches",
           library_note="none: no single PyTorch call computes the chunk recurrence")

    # K7 at three calls, each bit for bit against its plain version: the
    # direct 32k call from the combined states (the kernels line's row),
    # jamba_serve's one-chunk prefill call from zero states (no h0 read) and
    # the same layer's first 4096 tokens as 32 prompts of one chunk, bf16,
    # from zero.  Beside the bound: the SFU floor of the exact expf, and
    # the issue floor, the SASS instructions a term of the kernel's hot loop
    # (cuobjdump) over the card's 132 x 4 schedulers at 1.98 GHz.
    h07 = kc
    scan_lib = _build.library("mamba_scan")

    def same_bits(u, v):
        as_int = torch.int32 if u.dtype == torch.float32 else torch.int16
        return u.dtype == v.dtype and torch.equal(u.view(as_int), v.view(as_int))

    def k7_call(call, path, args, start, launches):
        x, dt, a, b, c, h0 = args
        chunk = call.get("chunk", 128)
        h_start = torch.zeros((x.shape[0], -(-x.shape[1] // chunk), x.shape[2], a.shape[1]),
                              device=dev) if h0 is None else h0
        (ky, kh), (py, ph) = (ops.mamba_chunk_scan(*args, chunk=chunk),
                              ref.mamba_chunk_scan_ref(x, dt, a, b, c, h_start, chunk=chunk))
        err = max(max_abs_err(ky, py), max_abs_err(kh, ph))
        bits = same_bits(ky, py) and same_bits(kh, ph)
        check(bits and err == 0.0, f"K7 differs from its plain version at {path}'s call "
                                   f"{tuple(x.shape)} (max abs err {err})")
        del ky, kh, py, ph
        terms = x.numel() * a.shape[1]
        dtype = str(x.dtype).split(".")[-1]
        # the instantiation this call runs: its lanes a channel and type
        lanes = scan_lib.mamba_chunk_scan_lanes(*x.shape, a.shape[1], chunk)
        check(lanes in (1, 2), f"K7 took {lanes} lanes a channel")
        sass = _build.sass_per_term(_build._lib_path("mamba_scan"), (("k7", (
            f"mamba_chunk_scan_kernelILi{a.shape[1]}ELi{lanes}E"
            + ("f" if x.dtype == torch.float32 else "13__nv_bfloat16") + "Lb1E",)),))["k7"]
        per_term = sass["instructions_a_term"]
        b_ms, b_by = bound(*kwork.scan_work(x, a, b, h0, chunk=chunk), FP32_FLOPS_PER_S)
        return {"path": path, "shape": dict(zip(shape_of["mamba_chunk_scan"][0],
                                                (*x.shape, a.shape[1]))),
                "dtype": dtype, "start": start, "lanes": lanes, "launches": launches,
                "max_abs_err": err,
                "bit_identical": bits,
                "ms": timed(lambda: ops.mamba_chunk_scan(*args, chunk=chunk)),
                "plain_ms": timed(lambda: ref.mamba_chunk_scan_ref(x, dt, a, b, c, h_start,
                                                                   chunk=chunk)),
                "bound_ms": b_ms, "bound_by": b_by,
                "expf_bound_ms": 1e3 * terms / EX2_PER_S,
                "issue_floor_ms": 1e3 * per_term * terms / THREAD_INSTR_PER_S,
                "sass_instructions_a_term": per_term, "sass": sass}

    serve7 = path_largest["mamba_chunk_scan"]["jamba_serve"]
    check(serve7["args"][5] is None, "jamba_serve's one-chunk scan read an h0")
    k7_rows = [
        k7_call(serve7["kwargs"], "jamba_serve", serve7["args"], "zero",
                seen["mamba_chunk_scan"]["jamba_serve"][serve7["shape"]]),
        k7_call({"chunk": chunk7}, "off the path: jamba_prefill's first Mamba layer, its first "
                "4096 tokens as 32 prompts",
                (*(t[:, :32 * chunk7].reshape(32, chunk7, t.shape[2])
                   for t in (x7, dt7)), a7,
                 *(t[:, :32 * chunk7].reshape(32, chunk7, t.shape[2]) for t in (b7, c7)), None),
                "zero", 0),
        k7_call({"chunk": chunk7}, "off the path: jamba_prefill's first Mamba layer, direct",
                (x7, dt7, a7, b7, c7, h07), "the combined states", 0),
    ]
    row7 = k7_rows[-1]
    record("mamba_chunk_scan", "src/repro_torch/csrc/mamba_scan.cu",
           "src/repro/kernels/mamba_scan.py:96",
           lambda: ops.mamba_chunk_scan(x7, dt7, a7, b7, c7, h07, chunk=chunk7),
           lambda: ref.mamba_chunk_scan_ref(x7, dt7, a7, b7, c7, h07, chunk=chunk7),
           row7["max_abs_err"], *kwork.scan_work(x7, a7, b7, h07, chunk=chunk7),
           FP32_FLOPS_PER_S, at=at7, dtype=row7["dtype"], chunk=chunk7, expf=terms7,
           expf_bound_ms=row7["expf_bound_ms"], issue_floor_ms=row7["issue_floor_ms"],
           sass_instructions_a_term=row7["sass_instructions_a_term"], by_shape=k7_rows,
           library_note="none: no single PyTorch call computes a selective scan")
    kernels[-1]["by_path"] = by_path(
        "mamba_chunk_scan",
        lambda x, dt, a, b, c, h0, chunk=128: kwork.scan_work(x, a, b, h0, chunk=chunk),
        FP32_FLOPS_PER_S)
    del ks, k7_rows, serve7
    del x7, dt7, a7, b7, c7, h07, zeros7, kc, path_largest

    # lif_record on the inputs of its largest call (HeartClass's recording),
    # against the plain version on the host from phase 12 (the card's
    # index_add_ adds in no fixed order): counts, last v and refr bit for
    # bit.  Bound: the bytes once (the synapses stay in the L2) against the
    # synapse-steps whose source fired, 2 flops each (phase 12's count).
    csr_r, in_r, draws_r, params_r = largest["lif_record"]["args"]
    rec = ops.lif_record(csr_r, in_r, draws_r, params_r)
    check(all(torch.equal(a, b) for a, b in zip(ops.lif_record(csr_r, in_r, draws_r, params_r),
                                                rec)),
          "lif_record differs between two launches")
    check(all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
              for a, b in zip(rec, host_record)),
          "lif_record differs from its plain version on the host bit for bit")
    err_r = max(max_abs_err(a.cpu().double(), b.double()) for a, b in zip(rec, host_record))
    n_r, e_r, steps_r = largest["lif_record"]["shape"]
    n_inputs_r = int(in_r.sum())
    active_r = round(sum(active_synapses))
    rec_lib = _build.library("lif_record")
    grid_r = (ctypes.c_int * 5)()
    check(rec_lib.lif_record_grid(n_r, e_r, grid_r) == 0, "lif_record_grid failed")

    def barrier_floor():
        check(rec_lib.lif_barrier_floor(n_r, e_r, steps_r, ops._stream(draws_r)) == 0,
              "the barrier floor's launch failed")

    def launch_floor():
        check(rec_lib.empty_launch(ops._stream(draws_r)) == 0, "the empty launch failed")

    barrier_ms, launch_ms = timed(barrier_floor), timed(launch_floor)
    record("lif_record", "src/repro_torch/csrc/lif_record.cu", "src/repro/core/lif.py:34",
           lambda: ops.lif_record(csr_r, in_r, draws_r, params_r),
           lambda: ref.lif_record_ref(csr_r, in_r, draws_r, params_r),
           err_r, *kwork.lif_record_work(n_r, e_r, steps_r, n_inputs_r, active=active_r),
           FP32_FLOPS_PER_S,
           library_note="none: no single PyTorch call runs a recorded LIF simulation",
           replaces_note="not a Pallas kernel: the reference's jitted lax.scan of _simulate "
                         "(src/repro/core/lif.py:34-68)",
           plain_device="cuda (index_add_, no fixed order); timed alone, 3 calls after one",
           bound_note="bytes read once: the synapses stay in the L2 from step to step; "
                      "operations: 2 a synapse-step whose source fired",
           bound_ms_every_synapse=bound(*kwork.lif_record_work(n_r, e_r, steps_r, n_inputs_r),
                                        FP32_FLOPS_PER_S)[0],
           active_synapse_steps=active_r, active_share_mean=active_r / (e_r * steps_r),
           barrier_floor_ms=barrier_ms, launch_floor_ms=launch_ms,
           stepwise_ms=timed(lambda: ref.lif_record_ref(csr_r, in_r, draws_r, params_r,
                                                        spike_input=ops.spike_input)),
           stepwise_note="the route before lif_record: the per-step eager loop around "
                         "spike_input, CUDA events around one loop (host-bound)",
           grid=dict(zip(("blocks", "threads", "chunk", "cached_synapses", "smem_bytes"),
                         grid_r)),
           equal_in_two_launches=True, bit_identical_counts_v_refr=True)

    # spike_input, off the path: on HeartClass's synapses and the fired flags
    # of recorded step SI_STEP, against the plain version on the host; the
    # yardstick is one CSR sparse matrix-vector product
    s9 = recorded_spikes(csr_r, in_r, draws_r, params_r, SI_STEP)
    csr9 = csr_r
    csr9_host = ref.SynapseCSR(**{f: getattr(csr9, f).cpu()
                                  for f in ("indptr", "pre", "weight", "post")})
    k9 = ops.spike_input(s9, csr9)
    check(torch.equal(ops.spike_input(s9, csr9), k9), "spike_input differs between two launches")
    want9 = ref.spike_input_ref(s9.cpu(), csr9_host)
    check(torch.equal(k9.cpu().view(torch.int32), want9.view(torch.int32)),
          "spike_input differs from its plain version on the host bit for bit")
    err9 = max_abs_err(k9.cpu(), want9)
    n9, e9 = csr9.n_neurons, int(csr9.pre.numel())
    active9 = int(out_degree[s9.bool()].sum())
    deg9 = torch.diff(csr9.indptr.long())
    with warnings.catch_warnings():       # sparse CSR support is in beta
        warnings.simplefilter("ignore")
        sparse9 = torch.sparse_csr_tensor(csr9.indptr, csr9.pre, csr9.weight, (n9, n9))
    try:
        (sparse9 @ s9).sum().item()
        library9, library9_error = (lambda: sparse9 @ s9), None
    except RuntimeError as e:      # no sparse product for these index types
        library9, library9_error = None, str(e).splitlines()[0][:200]
    # the row's bound as in PR 16-24: indptr, pre and w in, s in, i out, a
    # multiply and an add a synapse; beside it w only where the source fired
    record("spike_input", "src/repro_torch/csrc/spike_input.cu",
           "src/repro/core/lif.py:58",
           lambda: ops.spike_input(s9, csr9), lambda: ref.spike_input_ref(s9, csr9),
           err9, *kwork.spike_input_work(n9, e9), FP32_FLOPS_PER_S,
           at={"shape": (n9, e9), "path": None, "app": SNN_APP},
           library=library9, library_call="torch.sparse_csr_tensor(indptr, pre, w) @ s",
           library_error=library9_error, plain_device="cuda (index_add_, no fixed order)",
           replaces_note="not a Pallas kernel: the reference's jax.ops.segment_sum; on no "
                         "path since the recording is one launch (lif_record)",
           on_main_path=False, step=SI_STEP, active_synapses=active9,
           active_share=active9 / e9,
           bound_ms_active=bound(*kwork.spike_input_work(n9, e9, active=active9),
                                 FP32_FLOPS_PER_S)[0],
           in_degree_mean=float(deg9.double().mean()), in_degree_max=int(deg9.max()),
           equal_in_two_launches=True)
    del s9, csr9, csr9_host, k9, sparse9, rec, csr_r, in_r, draws_r, host_record

    for kern in kernels:
        check(kern["launches"] > 0 or kern["name"] in OFF_PATH,
              f"{kern['name']} never launched on the main path")
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
