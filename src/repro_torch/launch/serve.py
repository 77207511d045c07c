"""Batched serving: prefill by teacher-forced decode steps, then
greedy decode (the port of ``repro.launch.serve``).

``serve(..., mesh=)`` serves on an LM mesh as the reference's decode cells
lay it out: weight-stationary params (``params_shardings(inference=True)``),
expert-parallel MoE with whole experts per rank (``inference_ep``), the
caches by ``cache_shardings``, every step under ``use_mesh``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --requests 8 --gen-tokens 32 --device cpu

Without ``--device`` it runs on the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import device as device_mod
from ..configs import get_arch, reduced
from ..configs.base import ArchConfig
from ..models import transformer as tf
from ..tree import tree_leaves
from . import sharding as sh
from .steps import make_serve_step


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray                  # (B, gen_tokens) generated token ids
    prefill_s: float                    # wall of the teacher-forced prompt steps
    decode_s: float                     # wall of the greedy decode steps
    prompt_logits: Optional[torch.Tensor] = None  # (B, P, V), when kept

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.size / self.decode_s


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ArchConfig, params, prompts: np.ndarray, gen_tokens: int, max_len: int,
          device=None, *, keep_prompt_logits: bool = False, mesh=None) -> ServeResult:
    """Serve ``prompts`` (B, P) token ids: P teacher-forced decode steps
    fill a float32 cache of ``max_len`` slots, then ``gen_tokens`` greedy
    steps generate.  ``keep_prompt_logits`` keeps the prompt steps' logits.
    ``mesh`` serves on an LM mesh (the module docstring); plain params are
    distributed first (every rank holds the same full leaves)."""
    dev = device_mod.resolve(device)
    b, p_len = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    cache = tf.init_cache(cfg, b, max_len, dtype=torch.float32, device=dev)
    if mesh is not None:
        cfg = dataclasses.replace(cfg, inference_ep=True)
        if not isinstance(tree_leaves(params)[0], DTensor):
            params = sh.distribute(params, sh.params_shardings(params, mesh, inference=True))
        cache = sh.distribute(cache, sh.cache_shardings(cache, mesh))
    step = make_serve_step(cfg)
    kept = []
    with sh.use_mesh(mesh):
        t0 = time.perf_counter()
        for i in range(p_len):
            logits, cache = step(params, cache, toks[:, i:i + 1], i)
            if keep_prompt_logits:
                kept.append(sh.full(logits[:, 0]))
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        out = []
        tok = sh.full(logits[:, -1:]).argmax(dim=-1)
        t1 = time.perf_counter()
        for j in range(gen_tokens):
            out.append(tok)
            logits, cache = step(params, cache, tok, p_len + j)
            tok = sh.full(logits[:, -1:]).argmax(dim=-1)
        gen = torch.cat(out, dim=1).cpu().numpy()
        _sync(dev)
        decode_s = time.perf_counter() - t1
    return ServeResult(
        tokens=gen, prefill_s=t_prefill, decode_s=decode_s,
        prompt_logits=torch.stack(kept, dim=1) if keep_prompt_logits else None,
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, dev: torch.device, cfg: Optional[ArchConfig] = None):
    """(cfg, float32 params from seed 0, prompts from ``default_rng(0)``);
    ``cfg`` replaces ``--arch``'s config (a depth cut of it, say)."""
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.smoke:
            cfg = reduced(cfg)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.float32)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(args.requests, args.prompt_len))
    return cfg, params, prompts


def main(argv=None, device=None) -> ServeResult:
    args = parse_args(argv)
    dev = device_mod.resolve(device if device is not None else args.device)
    cfg, params, prompts = setup(args, dev)
    res = serve(cfg, params, prompts, args.gen_tokens, args.max_len, dev)
    print(f"[serve] prefill={res.prefill_s:.2f}s decode={res.decode_s:.2f}s "
          f"({res.tokens_per_s:.1f} tok/s) sample={res.tokens[0][:16].tolist()}")
    return res


if __name__ == "__main__":
    main()
