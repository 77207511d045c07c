"""The MoE's kept-row pair (``ops.moe_gate_up`` then ``ops.moe_down``)
against the padded route it replaces, on one GPU, from a few rows an
expert up past ``models/moe.py``'s ``R_MAX``.

At each shape (E, D, F, tokens, top-k, capacity factor), float32, each
token's experts drawn at random (distinct): the pair, checked within
``ref.MOE_TOL`` of the plain version, and the padded route
(``moe._pad``'s (E, C, D) dispatch and ``moe._run_experts``' three
``torch.matmul``), timed in turns (pair, padded, padded, pair), with the
pair's bound (the experts hit's weights, x, h and the outputs once, over
3.35 TB/s) and the mean choices an expert, T·k/E, that the route is
chosen by.  The decode cells' two layers (``ref.MOE_DECODE_SHAPES``,
dropless) and, at capacity 1.25, jamba's and deepseek-v3's layers at 8,
16, 32 and 64 choices an expert.

Run from the repository root on a machine with the card:

    python3 tools/moe_kept_ab.py [--shapes jamba_r32,deepseek_r8]

One JSON line a shape; exits non-zero if the pair misses the tolerance.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import ops, ref, work  # noqa: E402
from repro_torch.models import moe  # noqa: E402

HBM_BYTES_PER_S = 3.35e12

#: name: (E, D, F, T, k, capacity factor; None: dropless, capacity T)
SHAPES = {name: (*shape, None) for name, shape in ref.MOE_DECODE_SHAPES.items()}
for _rows in (8, 16, 32, 64):
    SHAPES[f"jamba_r{_rows}"] = (16, 4096, 14336, 8 * _rows, 2, 1.25)
    SHAPES[f"deepseek_r{_rows}"] = (256, 7168, 2048, 32 * _rows, 8, 1.25)


def timed(fn, trials=11, reps=5):
    """Device ms per call: median over trials of CUDA-event time of ``reps``
    back-to-back calls behind a sleep kernel."""
    for _ in range(3):
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


def measure(name, e, d, f, t, k, factor, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((t, d), generator=gen, device=dev)
    wg, wu = (0.02 * torch.randn((e, d, f), generator=gen, device=dev) for _ in range(2))
    wd = 0.02 * torch.randn((e, f, d), generator=gen, device=dev)
    idx = torch.rand((t, e), generator=gen, device=dev).argsort(dim=1)[:, :k]
    cap = t if factor is None else max(int(t * k * factor / e), 4)    # moe._capacity
    load = torch.bincount(idx.reshape(-1), minlength=e)
    kept, hit = int(load.clamp(max=cap).sum()), int((load > 0).sum())

    def pair():
        h = ops.moe_gate_up(x, idx, wg, wu, capacity=cap)
        return h, ops.moe_down(h, idx, wd, capacity=cap)

    def padded():
        buf = moe._pad(x, idx, e, cap)[0]
        return moe._run_experts({"experts": {"w_gate": wg, "w_up": wu, "w_down": wd}}, buf)

    h, out = pair()
    h_plain = ref.moe_gate_up_ref(x, idx, wg, wu, capacity=cap)
    tol = (ref.moe_excess(h, h_plain),
           ref.moe_excess(out, ref.moe_down_ref(h_plain, idx, wd, capacity=cap)))
    bytes_gu, _ = work.moe_rows_work(x, idx, wg, mats=2, kept=kept, hit=hit)
    bytes_dn, _ = work.moe_rows_work(h, idx, wd, mats=1, kept=kept, hit=hit)
    ms = {"pair": [], "padded": []}
    for n, fn in (("pair", pair), ("padded", padded), ("padded", padded), ("pair", pair)):
        ms[n].append(timed(fn))
    row = {"shape": name, "E": e, "D": d, "F": f, "T": t, "k": k, "capacity": cap,
           "mean_rows": t * k / e, "max_rows": int(load.max()), "kept_rows": kept,
           "experts_hit": hit, "tol_ratio_h": tol[0], "tol_ratio_out": tol[1],
           "pair_ms": ms["pair"], "padded_ms": ms["padded"],
           "bound_ms": 1e3 * (bytes_gu + bytes_dn) / HBM_BYTES_PER_S,
           "padded_over_pair": statistics.median(ms["padded"]) / statistics.median(ms["pair"])}
    print(json.dumps(row), flush=True)
    return max(tol)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    worst = 0.0
    for name in args.shapes.split(","):
        worst = max(worst, measure(name, *SHAPES[name], dev))
        torch.cuda.empty_cache()
    if worst > 1.0:
        raise SystemExit(f"moe_kept_ab: FAILED: the pair is {worst} times MOE_TOL")


if __name__ == "__main__":
    main()
