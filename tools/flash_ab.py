"""A/B timing of variants of the bf16 flash-attention kernel on one GPU.

Each variant is the committed ``src/repro_torch/csrc/flash_attention.cu``
with one named edit (``VARIANTS``).  Some edits break the result on
purpose, to time what is left (``TIMING_ONLY``): their distance from the
plain version is printed, not checked.  Every variant is built with the
port's nvcc flags into its own directory under
``build/repro_torch_kernels/flash_ab/``, checked against the plain version
on small cases, then timed in turns (A B .. B A, 5 calls each after a
warm-up) at the bf16 calls of the main path.

Run from the repository root on a machine with the card:

    python3 tools/flash_ab.py base stages2 stages4 pingpong no_split no_softmax no_lo

One JSON line per variant and call.  It exits non-zero if a variant does
not build, or if a variant that is not timing-only misses ``ATTN_TOL``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ref  # noqa: E402

OUT = ROOT / "build" / "repro_torch_kernels" / "flash_ab"

#: name -> (old, new) replacements in flash_attention.cu
VARIANTS = {
    "base": [],
    "stages2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    # the two consumers take turns to issue their wgmma (named barriers 1, 2)
    "pingpong": [
        ("  const uint32_t my_q = sQ + c * R::TILE;\n",
         "  const uint32_t my_q = sQ + c * R::TILE;\n"
         "  const int my_turn = 1 + c, their_turn = 2 - c;\n"
         "  auto turn_sync = [&] { asm volatile(\"bar.sync %0, 256;\" ::\"r\"(my_turn)); };\n"
         "  auto turn_pass = [&] { asm volatile(\"bar.arrive %0, 256;\" ::\"r\"(their_turn)); };\n"
         "  if (c == 1 && n_tiles > 0) asm volatile(\"bar.arrive 1, 256;\");\n"),
        ("    mbar_wait(k_full(0), 0);\n    wg_fence();\n    issue_qk<D>(sc, my_q, sK);\n"
         "    wg_commit();\n",
         "    mbar_wait(k_full(0), 0);\n    turn_sync();\n    wg_fence();\n"
         "    issue_qk<D>(sc, my_q, sK);\n    wg_commit();\n    turn_pass();\n"),
        ("    mbar_wait(v_full(s), (i / STAGES) & 1);\n    wg_fence();\n",
         "    mbar_wait(v_full(s), (i / STAGES) & 1);\n    turn_sync();\n    wg_fence();\n"),
        ("    issue_pv<NA>(pv, hi, lo, sV + s * R::TILE);\n    wg_commit();\n",
         "    issue_pv<NA>(pv, hi, lo, sV + s * R::TILE);\n    wg_commit();\n"
         "    if (c == 0 || next) turn_pass();\n"),
    ],
    # timing only: P V with hi alone, no softmax, no split
    "no_lo": [("    wgmma_rs(pv, lo[kk], dv, kk > 0);\n    wgmma_rs(pv, hi[kk], dv, 1);",
               "    wgmma_rs(pv, hi[kk], dv, kk > 0);")],
    "no_softmax": [("    if (next) softmax_tile(sc, m, l, alpha_next, kv_begin + (i + 1) * WKV, "
                    "rows, masks);",
                    "    alpha_next[0] = alpha_next[1] = 1.f;")],
    "no_split": [("      split_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1], hi[kk][f], "
                  "lo[kk][f]);",
                  "      hi[kk][f] = lo[kk][f] = __float_as_uint(sc[8 * kk + 2 * f]);")],
}
TIMING_ONLY = ("no_lo", "no_softmax", "no_split")

#: (b, hq, hkv, sq, skv, d, causal, window): the card tests' bf16 cases
SMALL = [
    (1, 2, 2, 128, 128, 64, True, 0), (2, 4, 2, 200, 200, 64, True, 0),
    (1, 8, 1, 384, 384, 128, True, 0), (1, 4, 2, 300, 300, 96, True, 0),
    (1, 4, 2, 384, 384, 128, True, 64), (2, 4, 4, 130, 130, 64, False, 0),
    (1, 4, 2, 257, 257, 128, False, 100), (1, 2, 1, 70, 190, 64, True, 0),
    (1, 4, 2, 100, 40, 128, True, 0), (1, 4, 1, 1100, 1100, 128, True, 0),
    (1, 4, 2, 500, 500, 128, True, 24), (1, 4, 2, 1200, 1200, 96, True, 0),
]
#: name -> (hq, hkv, s, window), causal, b = 1, D = 128: K6's bf16 main-path calls
CALLS = {
    "jamba_prefill": (32, 8, 32768, 0),
    "lm_prefill_qwen2": (12, 2, 32768, 0),
    "lm_prefill_starcoder2_windowed": (24, 2, 8192, 4096),
}


def build(names: list[str]) -> dict[str, ctypes.CDLL]:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: edit target not found: {old[:60]!r}")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for header in _build._headers(_build.CSRC / "flash_attention.cu"):
            (d / header.name).write_bytes(header.read_bytes())
        (d / "flash_attention.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "flash_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{out}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.flash_attention.argtypes = _build.SIGNATURES["flash_attention"]["flash_attention"]
        libs[name] = lib
    return libs


def run(lib, q, k, v, causal, window):
    b, hq, sq, d = q.shape
    o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, b, hq, k.shape[1], sq,
        k.shape[2], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
        int(window), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError_t {err}")
    return o


def main(names: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    names = names or list(VARIANTS)
    libs = build(names)
    dev = torch.device("cuda")
    worst = {n: 0.0 for n in names}
    for b, hq, hkv, sq, skv, d, causal, window in SMALL:
        gen = torch.Generator(device="cpu").manual_seed(sq + d)
        q = torch.randn(b, sq, hq, d, generator=gen).to(dev, torch.bfloat16).transpose(1, 2)
        kv = torch.randn(b, skv, 2 * hkv, d, generator=gen).to(dev, torch.bfloat16)
        k, v = kv[:, :, :hkv].transpose(1, 2), kv[:, :, hkv:].transpose(1, 2)
        plain = ref.attention_ref(q, k, v, causal=causal, window=window)
        for n in names:
            worst[n] = max(worst[n], ref.attention_excess(run(libs[n], q, k, v, causal, window),
                                                          plain))
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for call, (hq, hkv, s, window) in CALLS.items():
        gen = torch.Generator(device="cpu").manual_seed(0)
        q = torch.randn(1, hq, s, 128, generator=gen).to(dev, torch.bfloat16)
        k = torch.randn(1, hkv, s, 128, generator=gen).to(dev, torch.bfloat16)
        v = torch.randn(1, hkv, s, 128, generator=gen).to(dev, torch.bfloat16)
        plain = ref.attention_ref(q, k, v, causal=True, window=window)
        excess = {n: ref.attention_excess(run(libs[n], q, k, v, True, window), plain)
                  for n in names}
        del plain
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            run(libs[n], q, k, v, True, window)
            torch.cuda.synchronize()
            a, b_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                run(libs[n], q, k, v, True, window)
            b_.record()
            b_.synchronize()
            ms[n].append(a.elapsed_time(b_) / 5)
        for n in names:
            print(json.dumps({"variant": n, "call": call, "ms_in_turns": ms[n],
                              "tol_ratio": excess[n], "small_cases_tol_ratio": worst[n],
                              "timing_only": n in TIMING_ONLY, "device": card,
                              "nvidia_smi": smi}), flush=True)
    bad = [n for n in names if n not in TIMING_ONLY and worst[n] > 1.0]
    if bad:
        raise SystemExit(f"variants off ATTN_TOL on the small cases: {bad}")


if __name__ == "__main__":
    main(sys.argv[1:])
