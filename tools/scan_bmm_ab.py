"""Side-by-side timing of K7 (the Mamba chunk scan), the scan's route,
K2/K4 (the (max,+) products) and spike_input on one GPU: bodies before
their redesign, kept in ``tools/pr25_kernels/`` (K7) and
``tools/pr15_kernels/`` (K2), against the package's ``csrc/`` sources and
their named variants (edits of the source), in turns.

K7 (``--k7``) at the calls of ``K7_SHAPES`` (``--k7-shape``), each on the
inputs of jamba's first Mamba layer (init_mamba's weights from seed 0 at
full width, a standard normal input): jamba_serve's one-chunk prefill step
(float32, (8, 32, 8192), from zero states), a bf16 one-chunk call of 32
prompts (32, 128, 8192) from zero, and the direct 32k call (bf16, (1,
32768, 8192), chunk 128) from the combined states.  The body before the
redesign (``old``: ``tools/pr25_kernels/mamba_scan.cu``) must equal the
plain version bit for bit, and every variant of ``K7_VARIANTS`` (``diag_``
ones aside: wrong results, timed only) the old body: y and the states of
the full launch, and the states-only launch's states.  At a call of one chunk the route
(``mamba_scan_route`` from zero) is timed beside them as a yardstick and
must equal the old body too.  Each variant's line also has its registers
and spills (``-Xptxas -v``), the warps an SM holds at those registers and
the grid's warps an SM, and the SASS instructions a term of its hot loop
(``cuobjdump -sass``, ``_build.sass_per_term``).

With ``--route`` only the scan's route runs, on the 32k call's inputs: the
three launches it replaced (the package's states pass, combine and K7)
against the one walk (``mamba_scan_route``) of each variant in
``ROUTE_VARIANTS`` (named edits of the walk's thread layout, tile and ring
constants), in turns; each variant's y and last state must equal the
three launches' bit for bit.  Each variant is also compiled to a cubin
with its cold paths cut (``ROUTE_PROBE``) for its SASS instructions a term
beside K7's and its states pass's.

K2 (``--k2``, none with ``--k2 ''``) at the dense path's (64, 192, 192)^2
and K4's (150, 150) x (150, 1): old and new in each variant
(``K2_VARIANTS``), each bit-identical to the plain version; then
spike_input at HeartClass's synapses against its plain version on the
card.

Run from the repository root on a machine with the card:

    python3 tools/scan_bmm_ab.py --k2 '' --k7 base,g8,g16,share --k7-shape path,p32x128,direct32k
    python3 tools/scan_bmm_ab.py --k7 '' --k2 base,m8n8
    python3 tools/scan_bmm_ab.py --route base,g2,g8,rt32

One JSON line per measurement, each with the card's name and power limit.
It exits non-zero if a kernel does not build or differs from its plain
version or the old body.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from relax_lif_ab import in_turns  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import apps, lif  # noqa: E402
from repro_torch.kernels import _build, ref, work  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402

OLD_K7 = ROOT / "tools" / "pr25_kernels" / "mamba_scan.cu"
OLD_K2 = ROOT / "tools" / "pr15_kernels" / "maxplus_matmul.cu"
OUT = ROOT / "build" / "repro_torch_kernels" / "scan_bmm_ab"

#: the line of csrc/mamba_scan.cu that chooses K7's lanes a channel
K7_CHOICE = "  return channels < (int64_t)K7_FILL * 32 * sms ? 2 : 1;"
#: name -> (old, new) replacements in csrc/mamba_scan.cu: K7's layout
#: (lanes a channel, fixed: G = N / lanes states a lane; the fill below which
#: a channel takes two lanes; threads a block), how a lane gets its step's dt
#: and x, and how the main loop is unrolled; a variant "a+b" applies both;
#: "diag_" variants give wrong results and are only timed
K7_VARIANTS = {
    "base": [],
    # (a) at a fixed G: 16 (one lane a channel), 8 or 4 states a lane
    "g16": [(K7_CHOICE, "  return 1;")],
    "g8": [(K7_CHOICE, "  return 2;")],
    "g4": [(K7_CHOICE, "  return 4;"),
           ("  if constexpr (N >= 16)\n    if (k == 2)\n",
            "  if (k == 4)\n    return launch_lanes<N, 4, T, WRITE_Y>(x, dt, a, bm, cm, h0, y, "
            "hout, Bt, L, D, chunk, smem, stream);\n  if constexpr (N >= 16)\n    if (k == 2)\n")],
    **{f"fill{f}": [("constexpr int K7_FILL = 32;", f"constexpr int K7_FILL = {f};")]
       for f in (16, 64)},
    # (b): a channel's lane 0 reads dt and x; lane g takes the ones lane
    # g - 1 used the iteration before (in step: lane 0's own) by shuffles
    "share": [
        ("  float carry = -0.0f;   // the partial y sum this lane passed on last\n",
         "  float carry = -0.0f;   // the partial y sum this lane passed on last\n"
         "  const bool loads = K == 1 || g == 0;\n"
         "  float pdt = 0.0f, pdtx = 0.0f;\n"
         "  auto share = [&](float& dtt, float& dtx) {\n"
         "    if constexpr (K > 1) {\n"
         "      const float sdt = LAG ? __shfl_up_sync(mask, pdt, 1, K) : __shfl_sync(mask, dtt, 0, K);\n"
         "      const float sdtx = LAG ? __shfl_up_sync(mask, pdtx, 1, K) : __shfl_sync(mask, dtx, 0, K);\n"
         "      if (g > 0) dtt = sdt, dtx = sdtx;\n"
         "      pdt = dtt, pdtx = dtx;\n"
         "    }\n"
         "  };\n"),
        ("    if (act) {\n"
         "      const float dtt = to_f(dt[row + (int64_t)t * D]);\n"
         "      terms(smem + t * BC, dtt, __fmul_rn(dtt, to_f(x[row + (int64_t)t * D])), in,\n"
         "            y + row + (int64_t)t * D);\n"
         "    }",
         "    float dtt = 0.0f, dtx = 0.0f;\n"
         "    if (act && loads) {\n"
         "      dtt = to_f(dt[row + (int64_t)t * D]);\n"
         "      dtx = __fmul_rn(dtt, to_f(x[row + (int64_t)t * D]));\n"
         "    }\n"
         "    share(dtt, dtx);\n"
         "    if (act) terms(smem + t * BC, dtt, dtx, in, y + row + (int64_t)t * D);"),
        ("    T ndt = *dq, nx = *xq;", "    T ndt{}, nx{};\n    if (loads) ndt = *dq, nx = *xq;"),
        ("      if (decltype(ahead)::value) ndt = dq[D], nx = xq[D];",
         "      if (decltype(ahead)::value && loads) ndt = dq[D], nx = xq[D];"),
        ("      const float dtt = to_f(cdt);\n      const float dtx = __fmul_rn(dtt, to_f(cx));",
         "      float dtt = to_f(cdt);\n      float dtx = __fmul_rn(dtt, to_f(cx));\n"
         "      share(dtt, dtx);"),
    ],
    # no read ahead: each step's dt and x read at the step
    "noahead": [("      const T cdt = ndt, cx = nx;\n"
                 "      if (decltype(ahead)::value) ndt = dq[D], nx = xq[D];",
                 "      const T cdt = *dq, cx = *xq;")],
    **{f"t{t}": [("constexpr int K7_THREADS = 128;", f"constexpr int K7_THREADS = {t};")]
       for t in (64, 256)},
    # steps a main-loop pass where a channel takes 2 lanes (one lane: no unrolling)
    **{f"u{u}": [("constexpr int K7_UNROLL = 2;", f"constexpr int K7_UNROLL = {u};")]
       for u in (1, 4)},
    # no exponential: what the rest of a term costs
    "diag_noexp": [("const float decay = expf(__fmul_rn(dtt, av[n]));",
                    "const float decay = __fmul_rn(dtt, av[n]);")],
}
#: K7's calls: name -> (batch, tokens, dtype, start); "zero": no h0 (the
#: package's one-chunk scan), "combined": the states combined from the
#: states pass (the three launches' last)
K7_SHAPES = {
    "path": (8, 32, torch.float32, "zero"),          # jamba_serve's prefill step
    "p32x128": (32, 128, torch.bfloat16, "zero"),    # 32 prompts of one chunk
    "direct32k": (1, 32768, torch.bfloat16, "combined"),
}
#: name -> (old, new) replacements in csrc/mamba_scan.cu: the route's layout
#: (states a thread, so warps a block), steps a tile and ring stages; a
#: variant "a+b" applies both; "diag_" variants give wrong results and are
#: only timed
ROUTE_VARIANTS = {
    "base": [],
    "g8": [("constexpr int ROUTE_G = 4;", "constexpr int ROUTE_G = 8;")],
    # 2 states a thread: 8 warps a block, so 16 converted tiles kept
    "g2": [("constexpr int ROUTE_G = 4;", "constexpr int ROUTE_G = 2;"),
           ("constexpr int NS = 8;", "constexpr int NS = 16;")],
    **{f"rt{t}": [("constexpr int RT = 16;", f"constexpr int RT = {t};")] for t in (8, 32)},
    "rs2": [("constexpr int RS = 4;", "constexpr int RS = 2;")],
    # the decays free to sink beside their uses
    "sink": [("        if (L < 0) break;\n", "")],
    # steps whose decays are computed ahead of their recurrences
    **{f"sub{n}": [("constexpr int SUB = RT < 16 ? RT : 16;", f"constexpr int SUB = {n};")]
       for n in (4, 8)},
    # no exponential: what the rest of a term costs
    "diag_noexp": [("decay[r][g] = expf(__fmul_rn(q.x, av[g]));",
                    "decay[r][g] = __fmul_rn(q.x, av[g]);")],
    # no y: no products, no partial sums passed on, no stores
    "diag_noy": [("          for (int g = 0; g < G; ++g) acc[r] = __fadd_rn(acc[r], pv[g]);",
                  "          for (int g = 0; g < G; ++g) {}")],
}


#: the edits that keep only the route's hot path, for counting its SASS (never
#: run): every tile whole and inside the sequence, no chunk starting
ROUTE_PROBE = [("      if (aligned && (tile + 1) * RT <= L)", "      if (true)"),
               ("      if (tile * RT == next_start) start_chunk();",
                "      if (false) start_chunk();")]
#: the kernels whose SASS is counted: (label, substrings of the mangled name)
SASS_KERNELS = (("k7_full", ("mamba_chunk_scan_kernelILi16ELi1E13__nv_bfloat16Lb1E",)),
                ("k7_states", ("mamba_chunk_scan_kernelILi16ELi1E13__nv_bfloat16Lb0E",)),
                ("route", ("mamba_scan_route_kernelILi16E", "13__nv_bfloat16")))

#: name -> (old, new) replacements in csrc/maxplus_matmul.cu
K2_VARIANTS = {
    "base": [],
    "stages4": [("constexpr int STAGES = 3; ", "constexpr int STAGES = 4; ")],
    "tk32": [("constexpr int TK = 16; ", "constexpr int TK = 32; ")],
    "t96x64": [("constexpr int BM = 64; ", "constexpr int BM = 96; ")],
    "t64x32": [("constexpr int BN = 64; ", "constexpr int BN = 32; ")],
    "t48x64": [("constexpr int BM = 64; ", "constexpr int BM = 48; ")],
    "t32x64": [("constexpr int BM = 64; ", "constexpr int BM = 32; ")],
    "m4n4": [("constexpr int TM = 8, TN = 4;", "constexpr int TM = 4, TN = 4;")],
    "m8n8": [("constexpr int TM = 8, TN = 4;", "constexpr int TM = 8, TN = 8;")],
    "t96x64m8n8": [("constexpr int BM = 64; ", "constexpr int BM = 96; "),
                   ("constexpr int TM = 8, TN = 4;", "constexpr int TM = 8, TN = 8;")],
    # wrong results, timed only: two FADDs or two FMNMXs a term in place of one each
    "diag_addonly": [("acc[r][j] = fmaxf(acc[r][j], __fadd_rn(a, bv[j]));",
                      "acc[r][j] = __fadd_rn(acc[r][j], __fadd_rn(a, bv[j]));")],
    "diag_maxonly": [("acc[r][j] = fmaxf(acc[r][j], __fadd_rn(a, bv[j]));",
                      "acc[r][j] = fmaxf(acc[r][j], fmaxf(a, bv[j]));")],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"scan_bmm_ab: FAILED: {msg}")


def edits(table: dict, name: str) -> list:
    return [e for part in name.split("+") for e in table[part]]


def _variant(source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise SystemExit(f"edit target not found: {old!r}")
        source = source.replace(old, new)
    return source


def build(k7: list[str], k2: list[str], route: list[str]) -> dict[str, ctypes.CDLL]:
    """Libraries ``scan_old``, ``bmm_old``, ``spike_base`` and
    ``<kernel>_<variant>``, or with ``route`` only ``route_<variant>``, built
    in parallel; each route variant's probe is compiled to a cubin beside
    its library (``<OUT>/route_<variant>/probe.cubin``)."""
    src = {stem: (_build.CSRC / f"{stem}.cu").read_text()
           for stem in ("mamba_scan", "maxplus_matmul", "spike_input")}
    if route:
        jobs = {f"route_{n}": _variant(src["mamba_scan"], edits(ROUTE_VARIANTS, n))
                for n in route}
    else:
        jobs = {}
        if k7:
            jobs.update({"scan_old": OLD_K7.read_text(),
                         **{f"scan_{n}": _variant(src["mamba_scan"], edits(K7_VARIANTS, n))
                            for n in k7}})
        if k2:
            jobs.update({"bmm_old": OLD_K2.read_text(),
                         **{f"bmm_{n}": _variant(src["maxplus_matmul"], K2_VARIANTS[n])
                            for n in k2},
                         "spike_base": src["spike_input"]})
    procs = {}
    cubin_flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    for name, text in jobs.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(text)
        for header in _build.CSRC.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
               str(d / "k.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
        if name.startswith("route_"):
            (d / "probe.cu").write_text(_variant(text, ROUTE_PROBE))
            procs[f"{name}/probe"] = subprocess.Popen(
                [_build.nvcc_path(), *cubin_flags, "-cubin", "-o", str(d / "probe.cubin"),
                 str(d / "probe.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name} does not build:\n{out}")
        if name.endswith("/probe"):
            continue
        PTXAS[name] = ptxas_usage(out)
        emit({"build": name, "ptxas": PTXAS[name]})
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        kind = name.split("_")[0]
        stem = {"scan": "mamba_scan", "route": "mamba_scan", "bmm": "maxplus_matmul",
                "spike": "spike_input"}[kind]
        for fn, argtypes in _build.SIGNATURES[stem].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


#: library -> {mangled kernel: {"registers", "spill_stores", "spill_loads",
#: "smem"}} from its ``-Xptxas -v`` output
PTXAS: dict = {}


def ptxas_usage(text: str) -> dict:
    """Registers, spills (bytes) and static shared memory of each kernel
    ``-Xptxas -v`` reports."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if name and m:
            usage[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if name and m:
            usage[name].update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    return usage


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------- K7
def scan_call(lib, x, dt, a, b, c, h0, *, y=True, chunk=128):
    """One K7 launch of a library: ``(y or None, h_out)``; ``y`` False is
    the states-only launch (the old library has none)."""
    bsz, length, d = x.shape
    n = a.shape[1]
    nc = -(-length // chunk)
    yy = torch.empty_like(x) if y else None
    h_out = torch.empty((bsz, nc, d, n), dtype=torch.float32, device=x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = lib.mamba_chunk_scan(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), ptr(c),
                               ptr(h0), ptr(yy), h_out.data_ptr(), int(x.dtype == torch.bfloat16),
                               bsz, length, d, n, chunk, stream())
    check(err == 0, f"K7 launch failed with cudaError_t {err}")
    return yy, h_out


def combine_call(lib, dt, a, s_local, chunk=128):
    bsz, length, d = dt.shape
    h = torch.empty_like(s_local)
    err = lib.mamba_chunk_combine(dt.data_ptr(), a.data_ptr(), s_local.data_ptr(), h.data_ptr(),
                                  int(dt.dtype == torch.bfloat16), bsz, length, d, a.shape[1],
                                  chunk, stream())
    check(err == 0, f"combine launch failed with cudaError_t {err}")
    return h


def scan_inputs(batch: int, seq: int, dtype=torch.bfloat16):
    """x, dt, a, B, C and the chunk of jamba's first Mamba layer at (batch,
    seq) tokens in ``dtype``."""
    dev = torch.device("cuda")
    cfg = get_arch("jamba-v0.1-52b")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = tmamba.init_mamba(gen, cfg, dtype=dtype)
    h = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev).to(dtype)
    with torch.no_grad():
        u, _ = torch.matmul(h, p["w_in"]).chunk(2, dim=-1)
        u, _ = tmamba._causal_conv(p, u)
        dt, a, bm, cm = tmamba._ssm_params(p, u, cfg)
    return u.contiguous(), dt.contiguous(), a, bm.contiguous(), cm.contiguous(), cfg.mamba_chunk


def k7_threads(name: str) -> int:
    """Threads a block of K7 variant ``name``'s source."""
    text = (OUT / f"scan_{name}" / "k.cu").read_text()
    return int(re.search(r"constexpr int K7_THREADS = (\d+);", text).group(1))


def k7_kernel(n: int, lanes: int | None, dtype, write_y: bool = True) -> str:
    """The part of K7's mangled name that tells its instantiation apart
    (``lanes`` None: the old body, which has no lanes parameter)."""
    t = "f" if dtype == torch.float32 else "13__nv_bfloat16"
    return (f"mamba_chunk_scan_kernelILi{n}E" + ("" if lanes is None else f"Li{lanes}E")
            + f"{t}Lb{int(write_y)}E")


def warps_an_sm(usage: dict, threads: int, smem: int) -> int:
    """Warps an H100 SM holds of a kernel with ptxas ``usage`` in blocks of
    ``threads`` with ``smem`` bytes of dynamic shared memory: 65,536
    registers (256 a warp at a time), 64 warps, 32 blocks, 228 KB of shared
    memory (1 KB of it a block's own)."""
    warp_regs = -(-usage["registers"] * 32 // 256) * 256
    per_block = threads // 32
    blocks = min(32, 64 // per_block, 65536 // (warp_regs * per_block),
                 233472 // (smem + usage.get("smem", 0) + 1024))
    return blocks * per_block


def k7(libs, variants, shapes, smi):
    """The old body, the variants and (at one chunk) the route, in turns at
    each call of ``shapes``; every variant equal to the old body."""
    issue_rate = 132 * 4 * 32 * 1.98e9       # thread-instructions a second
    all_equal = True
    for shape in shapes:
        batch, seq, dtype, start = K7_SHAPES[shape]
        x, dt, a, b, c, chunk = scan_inputs(batch, seq, dtype)
        seq, d, n = x.shape[1], x.shape[2], a.shape[1]
        nc = -(-seq // chunk)
        zeros = torch.zeros((batch, nc, d, n), device=x.device)
        h0 = None
        if start == "combined":
            s = ref.mamba_chunk_scan_ref(x, dt, a, b, c, zeros, chunk=chunk)[1]
            h0 = ref.mamba_combine_ref(dt, a, s, chunk=chunk)
            del s
        plain_y, plain_h = ref.mamba_chunk_scan_ref(x, dt, a, b, c,
                                                    zeros if h0 is None else h0, chunk=chunk)
        del zeros
        old = libs["scan_old"]
        oy, oh = scan_call(old, x, dt, a, b, c, h0, chunk=chunk)
        os_ = scan_call(old, x, dt, a, b, None, h0, y=False, chunk=chunk)[1]
        check(torch.equal(oy, plain_y) and torch.equal(oh, plain_h),
              f"the old K7 differs from its plain version at {shape}")
        check(torch.equal(os_, oh), f"the old states-only launch differs at {shape}")
        del plain_y, plain_h
        terms = x.numel() * n
        nbytes, flops = work.scan_work(x, a, b, h0, chunk=chunk)
        row = {"kernel": "mamba_chunk_scan", "call": shape, "shape": [*x.shape, n],
               "dtype": str(dtype).split(".")[-1], "start": start, "chunk": chunk,
               "terms": terms, "nvidia_smi": smi,
               "bound_ms": 1e3 * max(nbytes / 3.35e12, flops / 67e12),
               "bound_by": "bytes" if nbytes / 3.35e12 >= flops / 67e12 else "operations",
               "expf_bound_ms": 1e3 * terms / (132 * 16 * 1.98e9)}
        fns = {"old": lambda: scan_call(old, x, dt, a, b, c, h0, chunk=chunk)}
        smem = 2 * min(chunk, seq) * n * 4
        for v in ["old", *variants]:
            lib_dir = OUT / f"scan_{v}"
            lanes = None if v == "old" else libs[f"scan_{v}"].mamba_chunk_scan_lanes(
                batch, seq, d, n, chunk)
            kernel = k7_kernel(n, lanes, dtype)
            sass = _build.sass_per_term(lib_dir / "lib.so", (("k7", (kernel,)),))["k7"]
            usage = next(u for f, u in PTXAS[lib_dir.name].items() if kernel in f)
            threads = 128 if v == "old" else k7_threads(v)
            blocks = -(-d // (threads // (lanes or 1))) * nc * batch
            info = {"lanes": lanes or 1, "registers": usage.get("registers"),
                    "spill_bytes": usage.get("spill_stores", 0) + usage.get("spill_loads", 0),
                    "warps_an_sm": warps_an_sm(usage, threads, smem),
                    "grid_warps_an_sm": blocks * threads / 32 / 132, "sass": sass}
            per_term = sass.get("instructions_a_term")
            info["issue_floor_ms"] = 1e3 * per_term * terms / issue_rate if per_term else None
            row[v] = info
            if v == "old":
                continue
            lib = libs[f"scan_{v}"]
            fns[v] = lambda lib=lib: scan_call(lib, x, dt, a, b, c, h0, chunk=chunk)
            if v.startswith("diag_"):
                continue
            vy, vh = scan_call(lib, x, dt, a, b, c, h0, chunk=chunk)
            vs = scan_call(lib, x, dt, a, b, None, h0, y=False, chunk=chunk)[1]
            info["equals_old"] = bool(torch.equal(vy, oy) and torch.equal(vh, oh)
                                       and torch.equal(vs, os_))
            all_equal &= info["equals_old"]
            del vy, vh, vs
        if seq <= chunk:   # the route from zero over one chunk: a yardstick
            route = libs[f"scan_{variants[0]}"]
            ry, rh = route_call(route, x, dt, a, b, c, chunk)
            row["route_equals_old"] = bool(torch.equal(ry, oy) and torch.equal(rh, oh[:, -1]))
            all_equal &= row["route_equals_old"]
            fns["route"] = lambda: route_call(route, x, dt, a, b, c, chunk)
            del ry, rh
        del oy, oh, os_
        row["ms_in_turns"] = in_turns(fns)
        emit(row)
        del x, dt, b, c, h0
    check(all_equal, "a K7 variant or the route differs from the old body")


# ------------------------------------------------------------- the route
def route_call(lib, x, dt, a, b, c, chunk=128):
    """One launch of a library's route: ``(y, h_final)``."""
    bsz, length, d = x.shape
    n = a.shape[1]
    y = torch.empty_like(x)
    h = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
    err = lib.mamba_scan_route(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                               c.data_ptr(), y.data_ptr(), h.data_ptr(),
                               int(x.dtype == torch.bfloat16), bsz, length, d, d, n, chunk,
                               stream())
    check(err == 0, f"route launch failed with cudaError_t {err}")
    return y, h


def route_ab(libs, variants, smi, seq):
    x, dt, a, b, c, chunk = scan_inputs(1, seq)
    base = libs["route_base"]

    def three():
        s = scan_call(base, x, dt, a, b, None, None, y=False, chunk=chunk)[1]
        y, h = scan_call(base, x, dt, a, b, c, combine_call(base, dt, a, s, chunk), chunk=chunk)
        return y, h[:, -1]

    y3, h3 = three()
    plain_y, plain_h = ref.mamba_route_ref(x, dt, a, b, c, chunk=chunk)
    row = {"kernel": "mamba_scan_route", "shape": [*x.shape, a.shape[1]], "chunk": chunk,
           "terms": x.numel() * a.shape[1], "nvidia_smi": smi,
           "three_launch_y_tol_ratio": ref.scan_excess(y3, plain_y, chunk),
           "three_launch_state_tol_ratio": ref.state_excess(h3, plain_h)}
    fns = {"three_launches": three}
    for v in variants:
        lib = libs[f"route_{v}"]
        y, h = route_call(lib, x, dt, a, b, c, chunk)
        row[f"{v}_sass"] = _build.sass_per_term(OUT / f"route_{v}" / "probe.cubin",
                                               SASS_KERNELS)
        fns[v] = lambda lib=lib: route_call(lib, x, dt, a, b, c, chunk)
        if "diag_" in v:
            continue
        row[f"{v}_equals_three_launches"] = bool(torch.equal(y, y3) and torch.equal(h, h3))
        row[f"{v}_route_y_tol_ratio"] = ref.scan_excess(y, plain_y, chunk)
        row[f"{v}_route_state_tol_ratio"] = ref.state_excess(h, plain_h)
        del y, h
    del plain_y, plain_h
    row["ms_in_turns"] = in_turns(fns)
    emit(row)
    check(all(row[f"{v}_equals_three_launches"] for v in variants if "diag_" not in v),
          "a route variant differs from the three launches")


# ---------------------------------------------------------------------- K2
def bmm_call(lib, a, b):
    g, m, k = a.shape
    n = b.shape[2]
    c = torch.empty((g, m, n), dtype=torch.float32, device=a.device)
    err = lib.maxplus_bmm(a.data_ptr(), b.data_ptr(), c.data_ptr(), g, m, n, k, stream())
    check(err == 0, f"K2 launch failed with cudaError_t {err}")
    return c


def k2(libs, variants, smi):
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    for g, m, k, n in ((64, 192, 192, 192), (1, 150, 150, 1)):
        a = torch.randn(g, m, k, generator=gen)
        a[a > 1.0] = float("-inf")
        a, b = a.to(dev), torch.randn(g, k, n, generator=gen).to(dev)
        plain = ref.maxplus_bmm_ref(a, b)
        fns = {}
        for name in ["old", *variants]:
            lib = libs["bmm_old" if name == "old" else f"bmm_{name}"]
            check(name.startswith("diag_") or torch.equal(bmm_call(lib, a, b), plain),
                  f"K2 {name} differs at {(g, m, k, n)}")
            fns[name] = (lambda lib=lib: bmm_call(lib, a, b))
        fns["plain"] = lambda: ref.maxplus_bmm_ref(a, b)
        emit({"kernel": "maxplus_bmm" if n > 1 else "maxplus_matmul (N = 1)",
              "shape": [g, m, k, n], "bound_ms": max(
                  1e3 * (a.numel() + b.numel() + plain.numel()) * 4 / 3.35e12,
                  1e3 * g * m * n * k / (67e12 / 4)),
              "ms_in_turns": in_turns(fns), "nvidia_smi": smi})


# ---------------------------------------------------------------- spike_input
def spike(libs, smi):
    dev = torch.device("cuda")
    snn = apps.build_app("HeartClass")
    csr, _ = lif.snn_tensors(snn, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    s = (torch.rand((snn.n_neurons,), generator=gen, device=dev) < 0.1).float()
    host = ref.spike_input_ref(s.cpu(), dataclasses.replace(
        csr, **{f: getattr(csr, f).cpu() for f in ("indptr", "pre", "weight", "post")}))

    def call(lib):
        out = torch.empty_like(s)
        err = lib.spike_input(csr.indptr.data_ptr(), csr.pre.data_ptr(), csr.weight.data_ptr(),
                              s.data_ptr(), out.data_ptr(), csr.n_neurons, stream())
        check(err == 0, f"spike_input launch failed with cudaError_t {err}")
        return out

    lib = libs["spike_base"]
    check(torch.equal(call(lib).cpu(), host), "spike_input differs from the host")
    fns = {"base": lambda: call(lib), "plain_on_card": lambda: ref.spike_input_ref(s, csr)}
    deg = torch.diff(csr.indptr.long())
    e = int(csr.pre.numel())
    emit({"kernel": "spike_input", "neurons": snn.n_neurons, "synapses": e,
          "in_degree_mean": float(deg.double().mean()), "in_degree_max": int(deg.max()),
          "bound_ms": 1e3 * (4 * (snn.n_neurons + 1) + 8 * e + 8 * snn.n_neurons) / 3.35e12,
          "ms_in_turns": in_turns(fns), "nvidia_smi": smi})


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k7", default="base", help="comma-separated K7_VARIANTS ('' for none)")
    ap.add_argument("--k7-shape", default=",".join(K7_SHAPES),
                    help=f"comma-separated K7 calls of {sorted(K7_SHAPES)}")
    ap.add_argument("--k2", default="base",
                    help="comma-separated K2_VARIANTS ('' for none, nor spike_input)")
    ap.add_argument("--route", default="",
                    help="comma-separated ROUTE_VARIANTS: run the route's section alone")
    ap.add_argument("--seq", type=int, default=32768, help="the route's tokens (prefill_32k)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    # base first: the other variants are held against it
    k7_v, k2_v, route_v = (["base"] + [v for v in a.split(",") if v and v != "base"] if a else []
                           for a in (args.k7, args.k2, args.route))
    shapes = [sh for sh in args.k7_shape.split(",") if sh]
    unknown = [sh for sh in shapes if sh not in K7_SHAPES]
    if unknown:
        raise SystemExit(f"unknown --k7-shape {unknown}; known: {sorted(K7_SHAPES)}")
    t0 = time.perf_counter()
    libs = build(k7_v, k2_v, route_v)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"phase": "build", "s": time.perf_counter() - t0, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    if route_v:
        route_ab(libs, route_v, smi, args.seq)
        return
    if k2_v:
        k2(libs, k2_v, smi)
        spike(libs, smi)
    if k7_v:
        k7(libs, k7_v, shapes, smi)


if __name__ == "__main__":
    main(sys.argv[1:])
