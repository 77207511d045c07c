"""Side-by-side timing of K7 (the chunked Mamba scan), K2/K4 (the (max,+)
products) and spike_input on one GPU: the K7 and K2 bodies before their
redesign, kept in ``tools/pr15_kernels/``, against the package's ``csrc/``
sources and their named variants (each a one-line edit), in turns.

K7, at jamba's largest call (bf16, (1, 32768, 8192), N = 16, chunk 128) on
the inputs of its first Mamba layer (init_mamba's weights from seed 0 at
full width, a standard normal input): the old full launch and the new one
(both must equal the plain version bit for bit); in each variant
(``K7_VARIANTS``) the states-only launch (equal to the full launch's
states from zero) and the full launch, with their tolerance ratios against
the plain version, and the whole scan with that variant's states pass and
the package's combine and full launch (the route's y and state ratios
against the plain route); the combine against its plain loop; and the
whole scan by the old route (K7, the plain combine, K7) against the new
one (states, combine, K7).

With ``--route`` only the scan's route runs, on the same inputs: the
three launches it replaced (the package's states pass, combine and K7)
against the one walk (``mamba_scan_route``) of each variant in
``ROUTE_VARIANTS`` (named edits of the walk's thread layout, tile and ring
constants), in turns; each variant's y and last state must equal the
three launches' bit for bit.  Each variant is also compiled to a cubin
with its cold paths cut (``ROUTE_PROBE``) and ``cuobjdump -sass`` counts the
instructions of the innermost loop that holds MUFU.EX2 per MUFU.EX2, one
a term: the route's instructions a term beside K7's and its states
pass's (the three launches' sum).

K2 at the dense path's (64, 192, 192)^2 and K4's (150, 150) x (150, 1):
old and new in each variant (``K2_VARIANTS``), each bit-identical to the
plain version.  spike_input at HeartClass's synapses against its plain
version on the card.

Run from the repository root on a machine with the card:

    python3 tools/scan_bmm_ab.py --k7 base,ex2,noexp --k2 base,m8n8
    python3 tools/scan_bmm_ab.py --route base,g2,g8,rt32

One JSON line per measurement, each with the card's name and power limit.
It exits non-zero if a kernel does not build or differs from its plain
version beyond its limit.
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
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402

OLD = ROOT / "tools" / "pr15_kernels"
OUT = ROOT / "build" / "repro_torch_kernels" / "scan_bmm_ab"

#: name -> (old, new) replacements in csrc/mamba_scan.cu
K7_VARIANTS = {
    "base": [],
    # the decay as exp2(dt * a*log2(e)) by ex2.approx (one MUFU.EX2), the
    # state updated by one FMA: the cheaper exponential that was given up
    "ex2": [("    av[n] = a[(int64_t)d * N + n];",
             "    av[n] = __fmul_rn(a[(int64_t)d * N + n], 1.4426950408889634f);"),
            ("      const float decay = expf(__fmul_rn(dtt, av[n]));\n"
             "      h[n] = __fadd_rn(__fmul_rn(decay, h[n]), __fmul_rn(dtx, bt[n]));",
             "      float decay;\n"
             "      asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(decay) : \"f\"(__fmul_rn(dtt, av[n])));\n"
             "      h[n] = __fmaf_rn(decay, h[n], __fmul_rn(dtx, bt[n]));")],
    # no exponential at all (wrong results): what the rest of a term costs
    "noexp": [("const float decay = expf(__fmul_rn(dtt, av[n]));",
               "const float decay = __fmul_rn(dtt, av[n]);")],
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
SASS_KERNELS = (("k7_full", ("mamba_chunk_scan_kernelILi16E13__nv_bfloat16Lb1E",)),
                ("k7_states", ("mamba_chunk_scan_kernelILi16E13__nv_bfloat16Lb0E",)),
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


def route_edits(name: str) -> list:
    return [e for part in name.split("+") for e in ROUTE_VARIANTS[part]]


def _variant(source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise SystemExit(f"edit target not found: {old!r}")
        source = source.replace(old, new)
    return source


def build(k7: list[str], k2: list[str], route: list[str] = ()) -> dict[str, ctypes.CDLL]:
    """Libraries ``scan_old``, ``bmm_old``, ``spike_base`` and
    ``<kernel>_<variant>``, or with ``route`` only ``route_<variant>``, built
    in parallel; each route variant's probe is compiled to a cubin beside
    its library (``<OUT>/route_<variant>/probe.cubin``)."""
    src = {stem: (_build.CSRC / f"{stem}.cu").read_text()
           for stem in ("mamba_scan", "maxplus_matmul", "spike_input")}
    if route:
        jobs = {f"route_{n}": _variant(src["mamba_scan"], route_edits(n)) for n in route}
    else:
        jobs = {"scan_old": (OLD / "mamba_scan.cu").read_text(),
                "bmm_old": (OLD / "maxplus_matmul.cu").read_text(),
                **{f"scan_{n}": _variant(src["mamba_scan"], K7_VARIANTS[n]) for n in k7},
                **{f"bmm_{n}": _variant(src["maxplus_matmul"], K2_VARIANTS[n]) for n in k2},
                "spike_base": src["spike_input"]}
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
        emit({"build": name, "ptxas": [ln.strip() for ln in out.splitlines()
                                       if "registers" in ln or "spill" in ln or "Compiling" in ln]})
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        kind = name.split("_")[0]
        stem = {"scan": "mamba_scan", "route": "mamba_scan", "bmm": "maxplus_matmul",
                "spike": "spike_input"}[kind]
        for fn, argtypes in _build.SIGNATURES[stem].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


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


def scan_inputs(seq: int):
    """x, dt, a, B, C of jamba's first Mamba layer at ``seq`` tokens, bf16."""
    dev = torch.device("cuda")
    cfg = get_arch("jamba-v0.1-52b")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = tmamba.init_mamba(gen, cfg, dtype=torch.bfloat16)
    h = torch.randn((1, seq, cfg.d_model), generator=gen, device=dev).bfloat16()
    with torch.no_grad():
        u, _ = torch.matmul(h, p["w_in"]).chunk(2, dim=-1)
        u, _ = tmamba._causal_conv(p, u)
        dt, a, bm, cm = tmamba._ssm_params(p, u, cfg)
    return u.contiguous(), dt.contiguous(), a, bm.contiguous(), cm.contiguous(), cfg.mamba_chunk


def k7(libs, variants, smi, seq):
    x, dt, a, b, c, chunk = scan_inputs(seq)
    zeros = torch.zeros((1, -(-seq // chunk), x.shape[2], a.shape[1]), device=x.device)
    plain_s = ref.mamba_chunk_scan_ref(x, dt, a, b, c, zeros, chunk=chunk)[1]
    h_init = ref.mamba_combine_ref(dt, a, plain_s, chunk=chunk)
    plain_y, plain_h = ref.mamba_chunk_scan_ref(x, dt, a, b, c, h_init, chunk=chunk)
    old, base = libs["scan_old"], libs["scan_base"]
    for name, lib in (("old", old), ("new", base)):
        ky, kh = scan_call(lib, x, dt, a, b, c, h_init, chunk=chunk)
        check(torch.equal(ky, plain_y) and torch.equal(kh, plain_h), f"{name} K7 differs from plain")
    del ky, kh

    def route(states_lib):
        """The whole scan: ``states_lib``'s states pass, the package's combine and K7."""
        s = scan_call(states_lib, x, dt, a, b, None, None, y=False, chunk=chunk)[1]
        return scan_call(base, x, dt, a, b, c, combine_call(base, dt, a, s, chunk), chunk=chunk)

    row = {"kernel": "mamba_chunk_scan", "shape": [*x.shape, a.shape[1]], "chunk": chunk,
           "terms": x.numel() * a.shape[1],
           "dt_a_abs_max": float((dt.float().amax() * a.abs().amax())), "nvidia_smi": smi}
    fns = {"old_full": lambda: scan_call(old, x, dt, a, b, c, h_init, chunk=chunk)}
    for v in variants:
        lib = libs[f"scan_{v}"]
        st = scan_call(lib, x, dt, a, b, None, None, y=False, chunk=chunk)[1]
        row[f"{v}_states_equal_full"] = bool(torch.equal(
            st, scan_call(lib, x, dt, a, b, c, zeros, chunk=chunk)[1]))
        fns[f"{v}_states"] = lambda lib=lib: scan_call(lib, x, dt, a, b, None, None, y=False,
                                                       chunk=chunk)
        fns[f"{v}_full"] = lambda lib=lib: scan_call(lib, x, dt, a, b, c, h_init, chunk=chunk)
        if v == "noexp":   # wrong results, timed only
            continue
        fy, fh = scan_call(lib, x, dt, a, b, c, h_init, chunk=chunk)
        ry, rh = route(lib)
        row.update({f"{v}_states_tol_ratio": ref.state_excess(st, plain_s),
                    f"{v}_full_y_tol_ratio": ref.scan_excess(fy, plain_y, chunk),
                    f"{v}_full_state_tol_ratio": ref.state_excess(fh, plain_h),
                    f"{v}_route_y_tol_ratio": ref.scan_excess(ry, plain_y, chunk),
                    f"{v}_route_state_tol_ratio": ref.state_excess(rh, plain_h)})
        del st, fy, fh, ry, rh
    check(row["base_states_equal_full"] and row["base_states_tol_ratio"] == 0.0,
          "the states-only launch differs from the plain states")
    check(max(row["base_route_y_tol_ratio"], row["base_route_state_tol_ratio"]) <= 1.0,
          "the new route lies beyond SCAN_TOL of the plain route")
    row["ms_in_turns"] = in_turns(fns)
    emit(row)
    # the combine, and the whole scan by either route
    kc = combine_call(base, dt, a, plain_s, chunk)
    combine = {"kernel": "mamba_chunk_combine", "tol_ratio": ref.state_excess(kc, h_init),
               "equals_plain": bool(torch.equal(kc, h_init)), "nvidia_smi": smi}
    del kc

    def old_route():
        s = scan_call(old, x, dt, a, b, c, zeros, chunk=chunk)[1]
        return scan_call(old, x, dt, a, b, c, ref.mamba_combine_ref(dt, a, s, chunk=chunk),
                         chunk=chunk)

    combine["ms_in_turns"] = in_turns({
        "plain_combine": lambda: ref.mamba_combine_ref(dt, a, plain_s, chunk=chunk),
        "combine": lambda: combine_call(base, dt, a, plain_s, chunk),
        "old_route": old_route, "new_route": lambda: route(base)})
    emit(combine)


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


def sass_per_term(cubin: pathlib.Path) -> dict:
    """Per kernel of ``SASS_KERNELS`` in ``cubin``: the instructions (NOPs
    left out) of the innermost loop that holds MUFU.EX2, the MUFU.EX2 among
    them (one a term), and their quotient."""
    cuobjdump = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True,
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
    for label, parts in SASS_KERNELS:
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
                    loops.append((len(body), mufu))
        if not loops:
            out[label] = {"error": "no loop holds MUFU.EX2"}
            continue
        n_ins, mufu = min(loops)
        out[label] = {"loop_instructions": n_ins, "mufu_ex2": mufu,
                      "instructions_a_term": n_ins / mufu}
    return out


def route_ab(libs, variants, smi, seq):
    x, dt, a, b, c, chunk = scan_inputs(seq)
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
        row[f"{v}_sass"] = sass_per_term(OUT / f"route_{v}" / "probe.cubin")
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
    ap.add_argument("--k7", default="base", help="comma-separated K7_VARIANTS")
    ap.add_argument("--k2", default="base", help="comma-separated K2_VARIANTS")
    ap.add_argument("--route", default="",
                    help="comma-separated ROUTE_VARIANTS: run the route's section alone")
    ap.add_argument("--seq", type=int, default=32768, help="K7's tokens (jamba's prefill_32k)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    # base first: the other variants are held against it
    k7_v, k2_v, route_v = (["base"] + [v for v in a.split(",") if v != "base"]
                           for a in (args.k7, args.k2, args.route))
    t0 = time.perf_counter()
    libs = build(k7_v, k2_v, route_v if args.route else ())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"phase": "build", "s": time.perf_counter() - t0, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    if args.route:
        route_ab(libs, route_v, smi, args.seq)
        return
    k2(libs, k2_v, smi)
    spike(libs, smi)
    k7(libs, k7_v, smi, args.seq)


if __name__ == "__main__":
    main(sys.argv[1:])
