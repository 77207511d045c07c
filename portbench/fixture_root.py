"""A benchmark root at CPU test size, made of new files and entries only:
two tiny configurations of the two architectures, a prefill and a decode
mix, and one cell of each pairing, with the repository's metric readers and
plain references.
The tests run the harness on it exactly as on ``BENCHMARK.json``."""

from __future__ import annotations

import json
import pathlib
import shutil

from portbench.spec import ROOT

JAMBA = {
    "port": {"arch": "jamba-v0.1-52b", "repeats": [1], "overrides": {
        "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16, "d_ff": 128, "vocab": 256,
        "moe_experts": 4, "moe_top_k": 2, "moe_d_ff": 64, "mamba_d_inner": 128,
        "mamba_dt_rank": 8, "mamba_chunk": 16}},
    "initializer_range": 0.02,
    "model": {"layers": [["mamba", "swiglu"], ["mamba", "moe"], ["mamba", "swiglu"], ["gqa", "moe"],
                         ["mamba", "swiglu"], ["mamba", "moe"], ["mamba", "swiglu"],
                         ["mamba", "moe"]],
              "d_model": 64, "vocab": 256, "norm_eps": 1e-6, "n_heads": 4, "n_kv_heads": 2,
              "head_dim": 16, "rope_theta": 10000.0, "d_ff": 128, "moe_experts": 4,
              "moe_top_k": 2, "moe_shared": 0, "moe_d_ff": 64, "mamba_d_inner": 128,
              "mamba_d_state": 16, "mamba_d_conv": 4, "mamba_dt_rank": 8, "mamba_chunk": 16},
}
DEEPSEEK = {
    "port": {"arch": "deepseek-v3-671b", "repeats": [1, 1], "overrides": {
        "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 128, "vocab": 256,
        "moe_experts": 8, "moe_top_k": 2, "moe_d_ff": 32, "mla_q_rank": 48, "mla_kv_rank": 32,
        "mla_nope_dim": 16, "mla_rope_dim": 8, "mla_v_dim": 16}},
    "initializer_range": 0.02,
    "model": {"layers": [["mla", "swiglu"], ["mla", "moe"]], "d_model": 64, "vocab": 256,
              "norm_eps": 1e-6, "n_heads": 4, "rope_theta": 10000.0, "mla_q_rank": 48,
              "mla_kv_rank": 32, "mla_nope_dim": 16, "mla_rope_dim": 8, "mla_v_dim": 16,
              "d_ff": 128, "moe_experts": 8, "moe_top_k": 2, "moe_shared": 1, "moe_d_ff": 32},
}
#: the readings at this size (program well under, control well over)
CHECKS = {"prefill": {"limits": {"logit_err_p50": 0.02, "logit_err_share": 0.1},
                      "share_over": 0.02},
          "decode": {"limits": {"logit_err_p50": 1e-5, "logit_err_p95": 1e-5, "served_gap": 1e-4}}}
#: the decode mix's cache slots at this size
DECODE_MAX_LEN = 12
CELLS = (("tiny-jamba.prefill", "tiny-jamba", "tiny-prefill"),
         ("tiny-jamba.decode", "tiny-jamba", "tiny-decode"),
         ("tiny-deepseek.prefill", "tiny-deepseek", "tiny-prefill"),
         ("tiny-deepseek.decode", "tiny-deepseek", "tiny-decode"))


def make(root) -> pathlib.Path:
    root = pathlib.Path(root)
    pb = root / "portbench"
    for sub in ("configs", "traffic", "cells"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "reference"):
        shutil.copytree(ROOT / "portbench" / sub, pb / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    if not (root / "src").exists():
        (root / "src").symlink_to(ROOT / "src")
    (pb / "configs" / "tiny-jamba.json").write_text(json.dumps(JAMBA))
    (pb / "configs" / "tiny-deepseek.json").write_text(json.dumps(DEEPSEEK))
    prefill = json.loads((ROOT / "portbench" / "traffic" / "prefill4k.json").read_text())
    prefill.update(tokens=48, check={"requests": 1, "drawn_from_first": 2, "positions": 16})
    decode = json.loads((ROOT / "portbench" / "traffic" / "decode.json").read_text())
    decode.update(sessions=4, prompt_tokens=4, max_len=DECODE_MAX_LEN,
                  check=dict(decode["check"], sessions=2, columns=64, near_tie=1e-6))
    (pb / "traffic" / "tiny-prefill.json").write_text(json.dumps(prefill))
    (pb / "traffic" / "tiny-decode.json").write_text(json.dumps(decode))

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "file": f"portbench/configs/{n}.json"}
                        for n in ("tiny-jamba", "tiny-deepseek")]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1} for n, c, t in CELLS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "prefill" if ("prefill" in m["name"] or "roofline" in m["name"]) else "decode"
            m["workloads"] = [n for n, _, _ in CELLS if n.endswith(kind)
                              and ("roofline" not in m["name"] or "jamba" in n)]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    for n, _, t in CELLS:
        kind = "prefill" if t.endswith("prefill") else "decode"
        (pb / "cells" / f"{n}.json").write_text(json.dumps(CHECKS[kind]))
    return root
