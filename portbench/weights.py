"""The benchmark's weights: the port's parameter layout, the values drawn
here from the seed on the device.

The layout is the port's shape-only init (``meta`` tensors).  Each leaf
takes its published initialisation, chosen by its name: RMSNorm weights
and Mamba's D are one, Mamba's ``a_log`` is log(1..N) (S4D-real), its
depthwise convolution is uniform within 1/sqrt(d_conv) (PyTorch's
``Conv1d``), dt's projection uniform within 1/sqrt(dt_rank) (Mamba's
``dt_init="random"``), biases zero, and every other matrix and the
embedding normal with the configuration's ``initializer_range``.  A
configuration's reference module may name leaves in its ``INIT``, a rule a
leaf name, which take that rule in place of this one: ``("normal", std)``,
``("uniform", bound)``, ``("ones",)``, ``("zeros",)``, or ``("fill",
name)``, the module's function ``name(view, generator)`` that fills each such
leaf in place.  Leaves of one rule are drawn together: one buffer and one
call a rule, the leaves views into it, so the card draws a model in a
handful of launches.
"""

from __future__ import annotations

import math

import torch

ONES = ("norm1", "norm2", "final_norm", "d_skip")
ZEROS = ("bq", "bk", "bv", "b_up", "b_down")
#: leaves start on multiples of this many elements (aligned rows for TMA)
ALIGN = 256
#: the rules a reference module's ``INIT`` may give a leaf
RULES = ("normal", "uniform", "ones", "zeros", "fill")


def leaves(tree, prefix=""):
    """(path, leaf) in the tree's order."""
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from leaves(value, path)
        else:
            yield path, value


def _kind(path: str, shape, init_range: float, init: dict):
    name = path.rsplit("/", 1)[-1]
    if name in init:
        rule = tuple(init[name])
        if rule[0] not in RULES:
            raise ValueError(f"leaf {name!r}: rule {rule!r} is none of {RULES}")
        return rule
    if name in ONES:
        return ("ones",)
    if name in ZEROS:
        return ("zeros",)
    if name == "a_log":
        return ("a_log",)
    if name in ("w_conv", "w_dt"):      # within 1/sqrt(d_conv) or 1/sqrt(dt_rank)
        return ("uniform", 1.0 / math.sqrt(shape[-2]))
    return ("normal", init_range)


def draw(meta_tree, seed: int, device, init_range: float, module=None):
    """A tree like ``meta_tree`` (shapes and dtypes) with values drawn on
    ``device`` from ``seed``; ``module``, the configuration's reference,
    gives its ``INIT`` and the fills it names."""
    gen = torch.Generator(device=device).manual_seed(seed)
    init = getattr(module, "INIT", {})
    groups: dict = {}
    for path, t in leaves(meta_tree):
        groups.setdefault((t.dtype, _kind(path, t.shape, init_range, init)), []).append((path, t))
    fills = {kind[1]: getattr(module, kind[1]) for _, kind in groups if kind[0] == "fill"}
    made = {}
    for (dtype, kind), items in sorted(groups.items(), key=lambda kv: repr(kv[0])):
        sizes = [-(-t.numel() // ALIGN) * ALIGN for _, t in items]
        buf = torch.empty(sum(sizes), dtype=dtype, device=device)
        if kind[0] == "normal":
            buf.normal_(0.0, kind[1], generator=gen)
        elif kind[0] == "uniform":
            buf.uniform_(-kind[1], kind[1], generator=gen)
        elif kind[0] == "ones":
            buf.fill_(1.0)
        else:
            buf.zero_()
        offset = 0
        for (path, t), size in zip(items, sizes):
            view = buf[offset:offset + t.numel()].view(t.shape)
            if kind[0] == "a_log":
                n = t.shape[-1]
                view.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
                           .expand(t.shape))
            elif kind[0] == "fill":
                fills[kind[1]](view, gen)
            made[path] = view
            offset += size
    return _rebuild(meta_tree, made)


def _rebuild(tree, made, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out[key] = _rebuild(value, made, path) if isinstance(value, dict) else made[path]
    return out


def _index(tree, r):
    return {k: _index(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


def per_layer(tree, repeats, layers_per_stack):
    """The reference's view of a port tree: (head weights, one dict a layer
    in model order).  ``repeats`` and ``layers_per_stack`` give each
    ``stack{i}``'s repeat count and layers."""
    layers = []
    for si, (repeat, n_layers) in enumerate(zip(repeats, layers_per_stack)):
        for r in range(repeat):
            for li in range(n_layers):
                layers.append(_index(tree[f"stack{si}"][f"l{li}"], r))
    head = {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "lm_head": tree["lm_head"] if "lm_head" in tree else tree["embed"].T}
    return head, layers
