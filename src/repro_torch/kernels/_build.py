"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build
takes seconds).  All sources are compiled together, one ``nvcc`` process
each, the first time any kernel is asked for.  Libraries land in
``build/repro_torch_kernels/`` at the repository root under a name that
hashes the source, the headers of ``csrc/`` it includes and the flags, so
an edited source or header is never served from a stale library.  A failed
build or load raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

#: source stem -> {C function: argtypes}; every function returns cudaError_t
SIGNATURES = {
    "relax_round": {
        # dist, lams, indptr, src, w, t, best, psrc, n_nodes, n_actors, k,
        # witness, stream
        "relax_round": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _P],
    },
    "maxplus_matmul": {
        "maxplus_bmm": [_P, _P, _P, _I, _I, _I, _I, _P],  # A, B, C, G, M, N, K, stream
        "maxplus_bmv": [_P, _P, _P, _I, _I, _I, _P],      # A, x, y, G, M, K, stream
    },
    "flash_attention": {
        # q, k, v, o, is_bf16, B, Hq, Hkv, Sq, Skv, D, strides (b, h, s) of
        # q, k and v, causal, window, stream
        "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            *[_I64] * 9, _I, _I, _P],
    },
    "lif_crossbar": {
        # s, w, v, out_s, out_v, G, B, n_in, n_out, leak, v_th, v_reset, stream
        "lif_crossbar_step": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    },
    "mamba_scan": {
        # x, dt, a, b, c, h0, y, h_out, is_bf16, B, L, D, N, chunk, stream
        # (y NULL: states only; h0 NULL: zero states)
        "mamba_chunk_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # B, L, D, N, chunk -> the lanes a channel K7 takes for that call
        "mamba_chunk_scan_lanes": [_I, _I, _I, _I, _I],
        # dt, a, s_local, h_init, is_bf16, B, L, D, N, chunk, stream
        "mamba_chunk_combine": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # x, dt, a, b, c, y, h_final, is_bf16, B, L, D, ld (x and dt's row
        # stride), N, chunk, stream
        "mamba_scan_route": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "spike_input": {
        "spike_input": [_P, _P, _P, _P, _P, _I, _P],   # indptr, pre, w, s, out, n, stream
    },
    "lif_record": {
        # indptr, pre, w, is_input, draws, counts, v, refr, masks, n, E,
        # n_steps, v_th, v_reset, leak, refractory, input_rate, stream
        "lif_record": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _F, _P],
        # n, E, out[5]: blocks, threads, chunk, cached synapses, smem bytes
        "lif_record_grid": [_I, _I, _P],
        "lif_barrier_floor": [_I, _I, _I, _P],     # n, E, n_steps, stream
        "empty_launch": [_P],                  # stream
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, else on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "cannot build the repro_torch CUDA kernels: no nvcc under "
            f"{home}/bin or on PATH"
        )
    return found


def _headers(source: pathlib.Path) -> list[pathlib.Path]:
    """The headers beside ``source`` that it includes by a quoted ``#include``."""
    names = re.findall(r'^\s*#\s*include\s*"([^"]+)"', source.read_text(), re.MULTILINE)
    return [source.parent / n for n in names]


def _lib_path(stem: str) -> pathlib.Path:
    source = CSRC / f"{stem}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in _headers(source):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel, then load them all."""
    with _LOCK:
        if len(_LIBS) == len(SIGNATURES):
            return _LIBS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [s for s in SIGNATURES if not _lib_path(s).is_file()]
        if todo:
            nvcc = nvcc_path()
            procs = {}
            for stem in todo:
                tmp = _lib_path(stem).with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
                procs[stem] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ))
            failed = []
            for stem, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{out}")
                else:
                    os.replace(tmp, _lib_path(stem))
            if failed:
                raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for stem, funcs in SIGNATURES.items():
            lib = ctypes.CDLL(str(_lib_path(stem)))
            for fn, argtypes in funcs.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[stem] = lib
        return _LIBS


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built on first use)."""
    lib = _LIBS.get(stem)
    return lib if lib is not None else build_all()[stem]


def sass_per_term(path: pathlib.Path, kernels) -> dict:
    """The issue cost of the scans' hot loops, read from the SASS of a built
    library or cubin ``path`` (``cuobjdump -sass``, beside ``nvcc``).  Per
    ``(label, substrings of a mangled kernel name)`` of ``kernels``: of the
    loops that hold MUFU.EX2 (one an exponential: one a (t, d, n) term),
    the one with the fewest instructions (NOPs left out) per MUFU.EX2, its
    instructions, its MUFU.EX2 and their quotient."""
    cuobjdump = pathlib.Path(nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name is not None and m:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for label, parts in kernels:
        found = [f for f in funcs if all(p in f for p in parts)]
        if len(found) != 1:
            out[label] = {"error": f"{len(found)} functions match {parts}"}
            continue
        ins = funcs[found[0]]
        loops = []
        for addr, op in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr
                        and not o.split()[0].startswith("NOP")]
                mufu = sum("MUFU.EX2" in o for o in body)
                if mufu:
                    loops.append((len(body) / mufu, len(body), mufu))
        if not loops:
            out[label] = {"error": "no loop holds MUFU.EX2"}
            continue
        per_term, n_ins, mufu = min(loops)
        out[label] = {"loop_instructions": n_ins, "mufu_ex2": mufu,
                      "instructions_a_term": per_term}
    return out
