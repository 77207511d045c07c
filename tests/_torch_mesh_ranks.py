"""Rank bodies of tests/test_torch_mesh.py: each runs in one of four spawned
processes that form a gloo world over a file store, builds a ``(2, 2)``
``("data", "model")`` mesh (or another), and rank 0 writes what the test
compares to an ``.npz``.  Importing this module imports no JAX: the ranks
start from a fresh interpreter."""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


def expert_coordinates(n_experts, sizes, expert_axes=("model", "data")):
    """Where each expert of an expert-parallel layer lies on a mesh of axis
    ``sizes`` ({name: size}, in mesh order): ``{"port": [...], "reference":
    [...]}``, expert ``e``'s ``{axis: index}`` in each layout.  The port
    splits the expert dim in the mesh's axis order (DTensor's), the
    reference in ``expert_axes``' order (JAX's)."""
    axes = [a for a in expert_axes if a in sizes]
    per = n_experts // int(np.prod([sizes[a] for a in axes]))

    def coords(order):
        out = []
        for e in range(n_experts):
            rank, c = e // per, {}
            for a in reversed(order):
                rank, c[a] = divmod(rank, sizes[a])
            out.append({a: c[a] for a in axes})
        return out

    return {"port": coords([a for a in sizes if a in axes]), "reference": coords(axes)}


def _init(rank, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def moe(rank, store, inputs, out):
    """Training EP (``_dispatch_shard_map``) and inference EP
    (``_dispatch_inference_ep``) of reduced deepseek-moe-16b on the (2, 2)
    mesh; the gradients of ``sum(y * r)`` through training EP and through
    the unsharded ``gather`` path; the router's and the tokens' gradients
    of the aux loss through both EP modes; where each rank's inference
    experts lie.  Then ``serve(mesh=)`` against unsharded ``serve`` for
    each of SERVE_CASES."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import sharding as sh
    from repro_torch.models import moe as tmoe

    mesh = _init(rank, store)
    try:
        cfg = reduced(get_arch("deepseek-moe-16b"))
        a = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
        p = {"router": a["router"],
             "experts": {"w_gate": a["w_gate"], "w_up": a["w_up"], "w_down": a["w_down"]}}
        names = ("router", "w_gate", "w_up", "w_down", "x")

        def leaves(q, x):
            return [q["router"], q["experts"]["w_gate"], q["experts"]["w_up"],
                    q["experts"]["w_down"], x]

        def grads_of(q, x, run, of_aux=False):
            """y, aux and the gradients of sum(y * r) by every leaf, or of
            aux by the router and the tokens."""
            ls = [t.detach().requires_grad_() for t in leaves(q, x)]
            q = {"router": ls[0], "experts": dict(zip(("w_gate", "w_up", "w_down"), ls[1:4]))}
            y, aux = run(q, ls[4])
            if of_aux:
                return y, aux, torch.autograd.grad(aux, [ls[0], ls[4]])
            return y, aux, torch.autograd.grad((y * a["r"]).sum(), ls)

        res = {}
        with sh.use_mesh(mesh):
            pd = sh.distribute(p, sh.params_shardings(p, mesh))
            xd = sh.distribute(a["x"], sh.NamedSharding(mesh, ("data", None)))

            def sm(q, x):
                return tmoe._dispatch_shard_map(q, x, cfg, mesh)

            def ie(q, x):
                return tmoe._dispatch_inference_ep(q, x, cfg, mesh)

            y, aux, g = grads_of(pd, xd, sm)
            res.update(y_sm=sh.full(y), aux_sm=sh.full(aux))
            res.update({f"g_ep_{n}": sh.full(t) for n, t in zip(names, g)})
            pi = sh.distribute(p, sh.params_shardings(p, mesh, inference=True))
            wg = pi["experts"]["w_gate"]
            y, aux, _ = grads_of(pi, a["x"], ie, of_aux=True)
            res.update(y_ie=sh.full(y), aux_ie=sh.full(aux))
            for mode, q, x, run in (("sm", pd, xd, sm), ("ie", pi, a["x"], ie)):
                _, _, g = grads_of(q, x, run, of_aux=True)
                res.update({f"g_aux_{mode}_router": sh.full(g[0]), f"g_aux_{mode}_x": sh.full(g[1])})
        _, offset = compute_local_shape_and_global_offset(wg.shape, mesh, wg.placements)
        e_loc = wg.to_local().shape[0]
        coords = [None] * dist.get_world_size()
        dist.all_gather_object(coords, (mesh.get_coordinate(), offset[0], e_loc))

        def plain(q, x):
            gates, idx, aux = tmoe._routing(q, x, cfg)
            return tmoe._dispatch_gather(q, x, gates, idx, cfg), aux

        y, aux, g = grads_of(p, a["x"], plain)
        res.update(y_gather=y, aux_gather=aux)
        res.update({f"g_plain_{n}": t for n, t in zip(names, g)})
        res.update(_serve_on(mesh))
        if rank == 0:
            layout = np.zeros((cfg.moe_experts, 2), np.int64)
            for (d, m), lo, n in coords:
                layout[lo:lo + n] = (d, m)
            np.savez(out, layout=layout,
                     **{k: v.detach().numpy() for k, v in res.items()})
    finally:
        dist.destroy_process_group()


#: (arch, requests) served on the (2, 2) mesh: deepseek-v3's MLA caches
#: (sequence over "model") and inference EP with whole experts over both
#: axes, batch over "data"; qwen2's GQA caches with one request, so the
#: batch is replicated
SERVE_CASES = (("deepseek-v3-671b", 4), ("qwen2-1.5b", 1))


def _serve_on(mesh):
    """Greedy tokens and prompt logits of reduced SERVE_CASES, unsharded and
    on ``mesh`` from the same params (6 prompt and 6 generated tokens)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import serve as sv
    from repro_torch.models import transformer as tf

    res = {}
    for arch, requests in SERVE_CASES:
        cfg = reduced(get_arch(arch))
        params = tf.init_params(cfg, torch.Generator().manual_seed(0))
        prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(requests, 6))
        for key, m in (("unsharded", None), ("sharded", mesh)):
            r = sv.serve(cfg, params, prompts, 6, 16, "cpu", keep_prompt_logits=True, mesh=m)
            res[f"serve_{arch}_{key}_tokens"] = torch.as_tensor(r.tokens)
            res[f"serve_{arch}_{key}_logits"] = r.prompt_logits
    return res


def train(rank, store, out):
    """Train steps unsharded and on the (2, 2) mesh from the same params and
    batches: two of reduced qwen2-1.5b and of reduced deepseek-moe-16b, one
    of reduced qwen2-1.5b with int8 moments and of reduced jamba cut to one
    8-layer block (K7's route per shard); the MoE models at aux weight 0."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves

    mesh = _init(rank, store)
    try:
        res = {}
        # (arch, aux weight, moments, repeats of each layer group, steps)
        runs = (("qwen2-1.5b", None, "float32", 2, 2), ("deepseek-moe-16b", 0.0, "float32", 2, 2),
                ("qwen2-1.5b", None, "int8", 2, 1), ("jamba-v0.1-52b", 0.0, "float32", 1, 1))
        for arch, aux, opt_dtype, depth, n_steps in runs:
            cfg = reduced(get_arch(arch))
            cfg = dataclasses.replace(cfg, stacks=tuple((min(r, depth), sp)
                                                        for r, sp in cfg.stacks))
            if aux is not None:
                cfg = dataclasses.replace(cfg, aux_loss_weight=aux)
            opt = AdamWConfig(lr=1e-3, state_dtype=opt_dtype)
            step = steps.make_train_step(cfg, opt)
            params = tf.init_params(cfg, torch.Generator().manual_seed(0))
            state = adamw_init(params, opt)
            data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
            batches = [{k: torch.as_tensor(v) for k, v in data.batch(i).items()}
                       for i in range(n_steps)]
            shardings = (sh.params_shardings(params, mesh),
                         sh.opt_state_shardings(state, params, mesh))
            ps, ss = sh.distribute((params, state), shardings)
            pu, su, lu, ls = params, state, [], []
            for b in batches:
                pu, su, m = step(pu, su, b)
                lu.append(float(m["loss"]))
                with sh.use_mesh(mesh):
                    ps, ss, m = step(ps, ss, sh.distribute(b, sh.batch_shardings(b, mesh)))
                    ls.append(float(sh.full(m["loss"])))
            kept = all(tuple(n.placements) == s.placements for n, s in zip(
                tree_leaves(ps), tree_leaves(shardings[0], sh.is_sharding)))
            err = max(float((a - sh.full(b)).abs().max())
                      for a, b in zip(tree_leaves(pu), tree_leaves(ps)))
            key = f"{arch}_{opt_dtype}"
            res.update({f"{key}_unsharded": np.array(lu), f"{key}_sharded": np.array(ls),
                        f"{key}_param_err": np.array(err), f"{key}_layout_kept": np.array(kept)})
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def remesh(rank, store, ckpt_dir, out):
    """The reference's test_remesh_checkpoint_restore_roundtrip on four
    ranks: saved from the (2, 2) mesh, restored onto a (4,) data mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
    from repro_torch.launch import sharding as sh

    mesh_a = _init(rank, store)
    try:
        w = torch.arange(64.0).reshape(8, 8)
        tree = {"w": w, "b": torch.arange(8, dtype=torch.bfloat16)}
        shard_a = {"w": sh.NamedSharding(mesh_a, ("data", "model")),
                   "b": sh.NamedSharding(mesh_a, ("model",))}
        save_checkpoint(ckpt_dir, 10, sh.distribute(tree, shard_a))
        mesh_b = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        shard_b = {"w": sh.NamedSharding(mesh_b, ("data", None)),
                   "b": sh.NamedSharding(mesh_b, (None,))}
        restored, _ = load_checkpoint(ckpt_dir, 10, tree, shardings=shard_b)
        step, again, _ = CheckpointManager(ckpt_dir).restore_latest(tree, shardings=shard_b)
        rows = restored["w"].to_local()
        gathered = [None] * 4
        dist.all_gather_object(gathered, rows.numpy())
        res = {"w": sh.full(restored["w"]).numpy(), "b": sh.full(restored["b"]).float().numpy(),
               "again_w": sh.full(again["w"]).numpy(), "step": np.array(step),
               "rows": np.stack(gathered),
               "placements_b": np.array([str(p) for p in restored["w"].placements])}
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()
