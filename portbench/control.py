"""The check's readings on several seeds in one process: the program's
numbers, and the control's, the reference one precision below the
configuration's in the program's place (float32 -> TF32, bfloat16 -> fp8).
A limit lies between the two.  The benchmark's own runs never run this.

  python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s> \
      [--controls <k>] [--dump <dir>]

Each seed runs the cell's set-up and a window of ``--seconds`` at its own
load, then prints one JSON line: the seed, the window's counts and both
readings (the control's only on the first ``--controls`` seeds, where
given).  ``--dump`` writes each seed's per-position values beside them.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

from portbench import check, harness, spec  # noqa: E402


def readings(root, workload: str, seed: int, seconds: float, device, dump=None,
             with_control=True) -> dict:
    """One seed's numbers of the program and, with ``with_control``, of the
    control; with ``dump`` (a directory) also their per-position values, as
    ``<cell>.<seed>.json``."""
    run = harness.Run(root, workload, seed, device)
    run.warm()
    stats, _ = run.window(seconds, False)
    control = check.CONTROL[run.traffic["params_dtype"]]
    out, found = run.judge(controls=(control,) if with_control else ())
    if dump is not None:
        rows = {k: [{name: t.tolist() for name, t in u.items()} for u in v]
                for k, v in found.items()}
        path = pathlib.Path(dump) / f"{workload}.{seed}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rows))
    return {"seed": seed, "workload": workload, "control": control, "program": out["program"],
            "control_reading": out.get(control),
            "stats": {k: v for k, v in stats.items() if k != "tbt_ms"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", help="a directory for each seed's per-position values")
    ap.add_argument("--controls", type=int, help="run the control on the first this many seeds "
                    "only (default: every seed)")
    args = ap.parse_args(argv)
    harness.use_checkout_caches(spec.ROOT)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        with_control = args.controls is None or i < args.controls
        print(json.dumps(readings(spec.ROOT, args.workload, seed, args.seconds, device, args.dump,
                                  with_control)), flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
