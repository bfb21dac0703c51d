"""The benchmark's frozen plain copy of the env and the GST
(``benchmark/reference``), for the tests that hold the port's env step and
GST against it: its modules, a copy of an env tree as its dataclasses, and
a bit-for-bit comparison. It imports no jax, so it serves the card's tests
too."""

import dataclasses
import os
import sys

import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")


def modules():
    """(config, crowd_sim, types) of the frozen reference (read, never
    changed); ``benchmark/`` is on the import path only while they load."""
    sys.path.insert(0, BENCH)
    try:
        import reference.config as rconfig
        import reference.crowd_sim as rsim
        import reference.types as rtypes
    finally:
        sys.path.remove(BENCH)
    return rconfig, rsim, rtypes


def gst_modules():
    """(config, predictor, pretext, types) of the frozen reference's GST
    path (read, never changed), loaded as :func:`modules` loads the env."""
    sys.path.insert(0, BENCH)
    try:
        import reference.config as rconfig
        import reference.predictor as rpredictor
        import reference.pretext as rpretext
        import reference.types as rtypes
    finally:
        sys.path.remove(BENCH)
    return rconfig, rpredictor, rpretext, rtypes


def copy_tree(x, rtypes=None):
    """A deep copy of an env tree (generators cloned at their state), as
    the reference's dataclasses when ``rtypes`` is given."""
    if dataclasses.is_dataclass(x):
        cls = type(x) if rtypes is None else getattr(rtypes, type(x).__name__)
        return cls(**{f.name: copy_tree(getattr(x, f.name), rtypes)
                      for f in dataclasses.fields(x)})
    if isinstance(x, list):
        return [copy_tree(v, rtypes) for v in x]
    if isinstance(x, torch.Generator):
        g = torch.Generator()
        g.set_state(x.get_state())
        return g
    return x.clone() if isinstance(x, torch.Tensor) else x


def assert_same_tree(a, b, where):
    """Every tensor (dtype and bits) and generator state of ``a`` and
    ``b`` equal; ``where`` names the tree in a failure."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same_tree(getattr(a, f.name), getattr(b, f.name),
                             f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state()), where
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
