"""Run the dry run's 80 cells (``--all --both-meshes``: ten architectures x
four shapes x the two production meshes) as processes side by side.

Each process is ``python -m repro_torch.launch.dryrun --arch A --shape S``,
``--multi-pod`` for the (2, 16, 16) mesh: 80 processes, ``--jobs`` of them
at a time, train cells first, then prefill, then decode, the largest
architectures first within each.  The cells are what one ``--all
--both-meshes`` process would count: every cell makes and destroys its
own fake world, and the records are the same files under
``build/dryrun_torch/``; the pool only spreads them over the host's
cores.

    PYTHONPATH=src python3 tools/dryrun_all.py --jobs 8 [--device cpu] [--timeout 3000]

Prints each process's ``[dryrun]`` lines as it ends, then one JSON line per
cell (its status, wall, per-device flops, peak bytes, dominant term) and
the summary ``[dryrun] k/80 cells OK`` with the wall of the whole run.  It
exits non-zero unless every cell is OK.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch.dryrun import ART  # noqa: E402


def run_one(arch: str, shape: str, multi_pod: bool, device: str, timeout: float) -> dict:
    """One process, one cell: its output lines, exit code and wall."""
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
            "--device", device] + (["--multi-pod"] if multi_pod else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])]))
    t = time.perf_counter()
    try:
        proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=timeout)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = "timeout", e.stdout or "", e.stderr or ""
        out, err = (s.decode() if isinstance(s, bytes) else s for s in (out, err))
    lines = [ln for ln in out.splitlines() if ln.startswith("[dryrun]")]
    print("\n".join(lines), flush=True)
    return {"arch": arch, "shape": shape, "multi_pod": multi_pod, "rc": rc,
            "wall_s": time.perf_counter() - t, "stderr_tail": err[-1500:] if rc != 0 else ""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="the meshes' device type (cpu on a host)")
    ap.add_argument("--timeout", type=float, default=3000.0, help="seconds a process may take")
    args = ap.parse_args(argv)

    # the longest cells first: train, then prefill, the largest models first
    kinds = {"train": 0, "prefill": 1, "decode": 2}
    cells = sorted(((a, s, mp) for a in ARCHS for s in SHAPES for mp in (False, True)),
                   key=lambda c: (kinds[SHAPES[c[1]]["kind"]], -ARCHS[c[0]].param_count()))
    started, t0 = time.time(), time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(lambda c: run_one(*c, args.device, args.timeout), cells))
    wall = time.perf_counter() - t0

    ok = 0
    for arch in ARCHS:
        for shape in SHAPES:
            for mp in (False, True):
                name = f"{arch}__{shape}__{'512' if mp else '256'}"
                path = ART / f"{name}.json"
                fresh = path.exists() and path.stat().st_mtime >= started
                rec = json.loads(path.read_text()) if fresh else {"error": "no record of this run"}
                row = {"cell": name, "status": rec.get("error", rec.get("skipped", "ok"))}
                if "cost" in rec:
                    row.update(wall_s=rec["wall_s"], flops=rec["cost"]["flops"],
                               bytes_accessed=rec["cost"]["bytes_accessed"],
                               collective_bytes=rec["collectives"]["bytes_total"],
                               argument_bytes=rec["memory"]["argument_bytes"],
                               peak_bytes=rec["memory"]["peak_bytes"],
                               grad_accum=rec.get("grad_accum"), roofline=rec["roofline"],
                               probes_equal_cost=rec.get("probes_equal_cost"),
                               top_flops=rec["breakdown"]["by_flops"][:3],
                               top_bytes=rec["breakdown"]["by_bytes"][:3],
                               largest_outputs=rec["breakdown"]["largest_outputs"][:3])
                ok += "error" not in rec
                print(json.dumps(row), flush=True)
    n = len(ARCHS) * len(SHAPES) * 2
    print(json.dumps({"processes": results, "jobs": args.jobs, "wall_s": wall}), flush=True)
    print(f"[dryrun] {ok}/{n} cells OK in {wall:.1f} s ({len(cells)} processes, "
          f"{args.jobs} at a time)", flush=True)
    return 0 if ok == n else 1


if __name__ == "__main__":
    sys.exit(main())
