"""The port's shape-only side of the LM substrate against the JAX reference:
``ArchConfig.param_count`` and ``active_param_count``, ``init_abstract``
(``meta`` tensors where the reference has ``jax.eval_shape``),
``input_specs`` and ``decode_cache_specs`` for the four shape cells, full
and reduced, for all ten architectures; and that the shape-only init
allocates nothing and leaves the random init as it was."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import SHAPES as RSHAPES
from repro.configs import decode_cache_specs as r_cache_specs
from repro.configs import get_arch as r_get_arch
from repro.configs import input_specs as r_input_specs
from repro.models import transformer as rtf

from repro_torch.configs import SHAPES, get_arch, reduced
from repro_torch.configs import decode_cache_specs, input_specs
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_leaves

_DTYPES = {"int32": torch.int32, "float32": torch.float32, "bfloat16": torch.bfloat16}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _ref_leaves(tree):
    """(path, shape, torch dtype) of every leaf of a reference abstract tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(k.key) for k in path), tuple(leaf.shape), _DTYPES[str(leaf.dtype)])
            for path, leaf in flat]


def _port_leaves(tree):
    leaves = tree_leaves(tree)
    assert all(t.device.type == "meta" for t in leaves)
    return [(p, tuple(t.shape), t.dtype) for p, t in zip(_paths(tree), leaves)]


@functools.lru_cache(maxsize=None)
def _ref_abstract(name):
    return _ref_leaves(rtf.init_abstract(r_get_arch(name)))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_counts_match_the_reference(name):
    cfg, rcfg = get_arch(name), r_get_arch(name)
    # the reference's param_count: the sum over its eval_shape'd init
    ref = sum(int(np.prod(s)) for _, s, _ in _ref_abstract(name))
    assert cfg.param_count() == ref
    assert cfg.active_param_count() == rcfg.active_param_count()
    if name == "qwen2-1.5b":
        assert cfg.param_count() == 1_543_714_304
    if name == "deepseek-v3-671b":
        assert cfg.param_count() == 671_026_279_424


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_init_abstract_matches_the_reference(name):
    assert _port_leaves(ttf.init_abstract(get_arch(name))) == _ref_abstract(name)


@pytest.mark.parametrize("cut", ["full", "reduced"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_shape_cells_match_the_reference(name, cut):
    cfg, rcfg = get_arch(name), r_get_arch(name)
    small = cut == "reduced"
    assert SHAPES == RSHAPES
    for shape in SHAPES:
        rspecs, rinfo = r_input_specs(rcfg, shape, reduced=small)
        if any(d < 0 for s in rspecs.values() for d in s.shape):
            # the reference cuts the cell below the frontend's tokens and
            # returns a negative token length; the port refuses the cell
            with pytest.raises(ValueError, match="frontend tokens"):
                input_specs(cfg, shape, reduced=small)
            continue
        specs, info = input_specs(cfg, shape, reduced=small)
        assert info == rinfo
        assert {k: (tuple(t.shape), t.dtype) for k, t in specs.items()} == {
            k: (tuple(s.shape), _DTYPES[str(s.dtype)]) for k, s in rspecs.items()}
        assert all(t.device.type == "meta" for t in specs.values())
        if info["kind"] == "decode":
            got = _port_leaves(decode_cache_specs(cfg, shape, reduced=small))
            assert got == _ref_leaves(r_cache_specs(rcfg, shape, reduced=small))


def test_init_abstract_allocates_nothing_and_leaves_the_random_init_alone():
    before = torch.randn(3, generator=torch.Generator().manual_seed(5))
    cfg = get_arch("deepseek-v3-671b")
    ttf.init_abstract(cfg)                      # 671 B parameters as meta tensors
    ttf.init_cache_abstract(cfg, 128, 32_768)
    # no draw happened: a generator seeded the same gives the same numbers
    assert torch.equal(torch.randn(3, generator=torch.Generator().manual_seed(5)), before)
    # the random route still draws from its generator, and its tree has the
    # shape-only tree's shapes
    small = reduced(get_arch("qwen2-1.5b"))
    a = tree_leaves(ttf.init_params(small, torch.Generator().manual_seed(0)))
    b = tree_leaves(ttf.init_params(small, torch.Generator().manual_seed(0)))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    abstract = tree_leaves(ttf.init_abstract(small))
    assert [(t.shape, torch.float32) for t in abstract] == [(t.shape, t.dtype) for t in a]


def test_init_abstract_does_not_allocate_through_the_allocator(monkeypatch):
    """Every tensor of the shape-only init is made on the meta device."""
    made = []
    empty, ones, zeros = torch.empty, torch.ones, torch.zeros

    def spy(fn):
        def call(*args, **kwargs):
            t = fn(*args, **kwargs)
            made.append(t.device.type)
            return t
        return call

    monkeypatch.setattr(torch, "empty", spy(empty))
    monkeypatch.setattr(torch, "ones", spy(ones))
    monkeypatch.setattr(torch, "zeros", spy(zeros))
    ttf.init_abstract(get_arch("jamba-v0.1-52b"))
    ttf.init_cache_abstract(get_arch("jamba-v0.1-52b"), 4, 64)
    assert made and set(made) == {"meta"}
