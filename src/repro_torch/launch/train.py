"""End-to-end training driver (the port of ``repro.launch.train``).

Deterministic data (``TokenStream``, a batch per (seed, step), made ahead
in a thread), AdamW with the cosine schedule and the global-norm clip,
checkpoint and restart (bit-exact through the (seed, step) data
contract), optional int8 error-feedback gradient compression.

On one rank it trains unsharded on one device.  In a world of several
ranks (``torch.distributed`` initialised by the caller) it meshes them as
the reference does: the production mesh (``--multi-pod`` for the pod
axis), or the mesh the caller passes; params and optimizer state are
DTensors laid out by ``params_shardings`` and ``opt_state_shardings``,
each batch by ``batch_shardings``, and the step runs under ``use_mesh``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
      --steps 200 --ckpt-dir /tmp/ckpt --device cpu

Without ``--device`` it runs on the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from ..checkpoint import CheckpointManager
from ..configs import get_arch, reduced
from ..data import DataConfig, TokenStream, make_batches
from ..models import transformer as tf
from ..optim import AdamWConfig, adamw_init
from ..tree import tree_map
from . import sharding as sh
from . import steps
from .mesh import make_production_mesh


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--opt-dtype", default="float32")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument(
        "--compress-grads", action="store_true",
        help="int8 error-feedback gradient compression before the update",
    )
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, device=None, mesh=None) -> list[float]:
    """Train ``--steps`` steps (resuming from ``--ckpt-dir``'s latest
    checkpoint); prints the reference's ``[train]`` lines and returns the
    losses of the steps run.  ``mesh`` (an LM ``DeviceMesh``) shards the
    run; without it a world of several ranks gets the production mesh."""
    args = parse_args(argv)
    dev = device_mod.resolve(device if device is not None else args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=dev.type)

    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                  global_batch=args.batch))
    opt = AdamWConfig(lr=1e-3, state_dtype=args.opt_dtype)
    step_fn = steps.make_train_step(cfg, opt, accum=args.accum,
                                    compress_grads=args.compress_grads)

    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.float32)
    opt_state = adamw_init(params, opt)
    if args.compress_grads:     # the state tree has the same leaves from step 0
        opt_state["ef"] = tree_map(lambda p: torch.zeros(p.shape, device=dev), params)
    shardings = None
    if mesh is not None:        # every rank made the same full leaves: each keeps its shards
        shardings = (sh.params_shardings(params, mesh),
                     sh.opt_state_shardings(opt_state, params, mesh))
        params, opt_state = sh.distribute((params, opt_state), shardings)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        restored = ckpt.restore_latest((params, opt_state), shardings=shardings)
        if restored[0] is not None:
            start_step, (params, opt_state), _ = restored
            print(f"[train] resumed from step {start_step}")

    losses = []
    batches = make_batches(data, start=start_step)
    data_s = 0.0
    t0 = time.time()
    try:
        with sh.use_mesh(mesh):
            for step in range(start_step, args.steps):
                t_data = time.perf_counter()
                batch = {k: torch.as_tensor(v, device=dev) for k, v in next(batches).items()}
                if mesh is not None:
                    batch = sh.distribute(batch, sh.batch_shardings(batch, mesh))
                data_s += time.perf_counter() - t_data
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                losses.append(float(sh.full(metrics["loss"])))
                if step % args.log_every == 0 or step == args.steps - 1:
                    tok_s = (step - start_step + 1) * args.batch * args.seq_len / (time.time() - t0)
                    print(
                        f"[train] step={step} loss={losses[-1]:.4f} "
                        f"gnorm={float(sh.full(metrics['grad_norm'])):.3f} tok/s={tok_s:.0f}",
                        flush=True,
                    )
                if ckpt:
                    ckpt.maybe_save(step + 1, (params, opt_state), extra={"data_step": step + 1})
    finally:
        batches.close()

    if losses:
        first = np.mean(losses[: max(3, len(losses) // 10)])
        last = np.mean(losses[-max(3, len(losses) // 10):])
        print(f"[train] loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    print(f"[train] waited {data_s:.2f}s for data")
    return losses


if __name__ == "__main__":
    main()
