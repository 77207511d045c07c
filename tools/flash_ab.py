"""A/B timing of variants of the flash-attention kernel on one GPU.

Each variant is the committed ``src/repro_torch/csrc/flash_attention.cu``
with one named edit (``VARIANTS``), or a whole earlier source
(``SOURCES``: ``fma``, the float32 body of scalar FMAs on the CUDA cores
that the 3xTF32 body replaced, kept in ``tools/flash_fma_body/``).  Some
edits break the result on purpose, to time what is left
(``TIMING_ONLY``): their distance from the plain version is printed, not
checked.  Every variant is built with the port's nvcc flags into its own
directory under ``build/repro_torch_kernels/flash_ab/``, checked against
the plain version on small cases, then timed in turns (A B .. B A, 5 calls
each after a warm-up) at the main path's bf16 calls, or with ``--f32`` at
its float32 train call, where ``F.scaled_dot_product_attention``'s
memory-efficient backend is timed in the same turns as a yardstick (row
``sdpa``; TF32 off, as for the plain version).

Run from the repository root on a machine with the card:

    python3 tools/flash_ab.py base stages2 stages4 pingpong no_split no_softmax no_lo
    python3 tools/flash_ab.py --f32 base fma f32_cvt f32_lo_unrounded f32_one_pass

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
# float32 body: the split's rounding by cvt.rna.tf32.f32 (the same bits as
# the two integer operations of tf32_rna); lo left unrounded (the tensor
# cores drop its 13 low bits); timing only: one TF32 pass (hi x hi)
VARIANTS["f32_cvt"] = [
    ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
     '  uint32_t y;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(y) : "f"(x));\n  return y;')]
VARIANTS["f32_lo_unrounded"] = [
    ("  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));",
     "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));")]
VARIANTS["f32_one_pass"] = [
    ("  mma_tf32(d, a_lo, b0_hi, b1_hi);\n  mma_tf32(d, a_hi, b0_lo, b1_lo);\n", ""),
    ("          mma_tf32(sl + 4 * j, ql[h], kh[j][2 * h], kh[j][2 * h + 1]);\n"
     "          mma_tf32(sl + 4 * j, qh[h], kl[j][2 * h], kl[j][2 * h + 1]);\n", "")]
# timing only, to see where the float32 body's time goes: none of the
# products and no softmax
_NO_QK = ("          mma_tf32(sl + 4 * j, ql[h], kh[j][2 * h], kh[j][2 * h + 1]);\n"
          "          mma_tf32(sl + 4 * j, qh[h], kl[j][2 * h], kl[j][2 * h + 1]);\n"
          "          mma_tf32(sc + 4 * j, qh[h], kh[j][2 * h], kh[j][2 * h + 1]);\n", "")
_NO_PV = ("            mma_3xtf32(pv[4 * aa + c], ph[kk], pl[kk], vh[aa][0][c], vh[aa][1][c],\n"
          "                       vl[aa][0][c], vl[aa][1][c]);", "            ;")
_NO_SOFTMAX = ("    softmax_tile(sc, m, l, alpha, k0, rows, masks);",
               "    alpha[0] = alpha[1] = 1.f;")
VARIANTS["f32_no_math"] = [_NO_QK, _NO_PV, _NO_SOFTMAX]
# timing only: lo taken as hi (three products a term, no remainder to form)
VARIANTS["f32_lo_is_hi"] = [
    ("  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));", "  lo = hi;")]
# timing only, what is left without the math, and without the stores too
VARIANTS["f32_skel_no_store"] = VARIANTS["f32_no_math"] + [
    ("    if (q0 + r < Sq)\n", "    if (q0 + r < 0)\n")]
# the cheapest split: hi x as it lies (the tensor cores drop its 13 low
# bits), lo the exact remainder of that, unrounded
VARIANTS["f32_trunc_split"] = [
    ("  hi = tf32_rna(x);\n  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));",
     "  hi = __float_as_uint(x);\n"
     "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi & 0xffffe000u)));")]
TIMING_ONLY = ("no_lo", "no_softmax", "no_split", "f32_one_pass", "f32_no_math",
               "f32_skel_no_store", "f32_lo_is_hi")
SOURCES = {"fma": ROOT / "tools" / "flash_fma_body" / "flash_attention.cu"}

#: (b, hq, hkv, sq, skv, d, causal, window): the card tests' bf16 cases
SMALL = [
    (1, 2, 2, 128, 128, 64, True, 0), (2, 4, 2, 200, 200, 64, True, 0),
    (1, 8, 1, 384, 384, 128, True, 0), (1, 4, 2, 300, 300, 96, True, 0),
    (1, 4, 2, 384, 384, 128, True, 64), (2, 4, 4, 130, 130, 64, False, 0),
    (1, 4, 2, 257, 257, 128, False, 100), (1, 2, 1, 70, 190, 64, True, 0),
    (1, 4, 2, 100, 40, 128, True, 0), (1, 4, 1, 1100, 1100, 128, True, 0),
    (1, 4, 2, 500, 500, 128, True, 24), (1, 4, 2, 1200, 1200, 96, True, 0),
]
#: (b, hq, hkv, sq, skv, d, causal, window): float32 cases at the 3xTF32
#: body's tile edges (64 q rows, two 64-key stages)
SMALL_F32 = [
    (1, 4, 2, 100, 40, 128, True, 0), (1, 4, 1, 700, 700, 128, True, 0),
    (1, 4, 2, 300, 300, 128, True, 24), (1, 4, 2, 400, 400, 96, True, 0),
    (2, 2, 2, 150, 333, 64, False, 0), (1, 4, 2, 70, 333, 128, True, 0),
]
#: name -> (b, hq, hkv, s, d), causal: K6's float32 call of the train step
#: (qwen2-1.5b, 8 x 256 tokens)
CALLS_F32 = {"train": (8, 12, 2, 256, 128)}
#: name -> (hq, hkv, s, window), causal, b = 1, D = 128: K6's bf16 main-path calls
CALLS = {
    "jamba_prefill": (32, 8, 32768, 0),
    "lm_prefill_qwen2": (12, 2, 32768, 0),
    "lm_prefill_starcoder2_windowed": (24, 2, 8192, 4096),
}


def build(names: list[str]) -> dict[str, ctypes.CDLL]:
    procs = {}
    for name in names:
        text = SOURCES.get(name, _build.CSRC / "flash_attention.cu").read_text()
        for old, new in VARIANTS.get(name, []):
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
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), int(q.dtype == torch.bfloat16),
        b, hq, k.shape[1], sq,
        k.shape[2], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
        int(window), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError_t {err}")
    return o


def in_turns(fns: dict, reps: int = 5) -> dict[str, list[float]]:
    """ms a call of each, timed A B .. B A after a warm-up.  A sleep kernel
    first keeps the card busy while the host enqueues the calls, so the
    events time the device work and not the launch overhead."""
    ms = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        fns[n]()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(reps):
            fns[n]()
        b.record()
        b.synchronize()
        ms[n].append(a.elapsed_time(b) / reps)
    return ms


def sdpa_efficient(q, k, v):
    """The yardstick: SDPA's memory-efficient backend, k and v expanded to
    q's heads (timed here only)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    g = q.shape[1] // k.shape[1]
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return scaled_dot_product_attention(q, kk, vv, is_causal=True)
    return call


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = "--f32" in argv
    names = [a for a in argv if a != "--f32"] or list(VARIANTS)
    dtype = torch.float32 if f32 else torch.bfloat16
    libs = build(names)
    dev = torch.device("cuda")
    worst = {n: 0.0 for n in names}
    for b, hq, hkv, sq, skv, d, causal, window in SMALL_F32 if f32 else SMALL:
        gen = torch.Generator(device="cpu").manual_seed(sq + d)
        q = torch.randn(b, sq, hq, d, generator=gen).to(dev, dtype).transpose(1, 2)
        kv = torch.randn(b, skv, 2 * hkv, d, generator=gen).to(dev, dtype)
        k, v = kv[:, :, :hkv].transpose(1, 2), kv[:, :, hkv:].transpose(1, 2)
        plain = ref.attention_ref(q, k, v, causal=causal, window=window)
        for n in names:
            worst[n] = max(worst[n], ref.attention_excess(run(libs[n], q, k, v, causal, window),
                                                          plain))
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    calls = ({c: (b, hq, hkv, s, d, 0) for c, (b, hq, hkv, s, d) in CALLS_F32.items()} if f32
             else {c: (1, hq, hkv, s, 128, w) for c, (hq, hkv, s, w) in CALLS.items()})
    for call, (b, hq, hkv, s, d, window) in calls.items():
        gen = torch.Generator(device="cpu").manual_seed(0)
        q = torch.randn(b, hq, s, d, generator=gen).to(dev, dtype)
        k = torch.randn(b, hkv, s, d, generator=gen).to(dev, dtype)
        v = torch.randn(b, hkv, s, d, generator=gen).to(dev, dtype)
        plain = ref.attention_ref(q, k, v, causal=True, window=window)
        excess = {n: ref.attention_excess(run(libs[n], q, k, v, True, window), plain)
                  for n in names}
        fns = {n: (lambda n=n: run(libs[n], q, k, v, True, window)) for n in names}
        if f32:
            fns["sdpa"] = sdpa_efficient(q, k, v)
            excess["sdpa"] = ref.attention_excess(fns["sdpa"](), plain)
        del plain
        ms = in_turns(fns)
        for n in fns:
            print(json.dumps({"variant": n, "call": call, "ms_in_turns": ms[n],
                              "tol_ratio": excess[n], "small_cases_tol_ratio": worst.get(n),
                              "timing_only": n in TIMING_ONLY, "device": card,
                              "nvidia_smi": smi}), flush=True)
    bad = [n for n in names if n not in TIMING_ONLY and worst[n] > 1.0]
    if bad:
        raise SystemExit(f"variants off ATTN_TOL on the small cases: {bad}")


if __name__ == "__main__":
    main(sys.argv[1:])
