"""Flax-style parameter trees <-> the port's ``state_dict``s.

The inverse of the JAX package's ``utils/torch_import.py``: a nested numpy
tree as flax stores it (dense ``kernel`` (in, out), conv ``kernel``
(kh, kw, in, out), LayerNorm ``scale``) becomes a flat ``state_dict`` with
torch names and layouts (``weight`` (out, in) and (out, in, kh, kw)), and
back. Every other leaf (GRU/LSTM gate matrices, the packed
MHA ``in_proj`` matrices, ``logstd``, biases) keeps its name and layout.
The committed weights are ``.npz`` files whose keys are the tree paths joined
with ``'/'`` (written by ``tools/export_torch_weights.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    """{'a/b/c': array} -> nested dict."""
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_npz(path: str) -> Dict:
    """Read a committed weight file into a nested numpy tree."""
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def params_tree(params) -> Dict:
    """The model tree from ``params``: a flax-style tree with or without the
    top ``'params'`` level, or the path of a ``.npz`` export."""
    if isinstance(params, str):
        params = load_npz(params)
    if set(params) == {"params"}:
        params = params["params"]
    return params


def tree_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax tree -> torch state_dict: a dense ``kernel`` (in, out) becomes
    ``weight`` (out, in), a conv ``kernel`` (kh, kw, in, out) becomes
    ``weight`` (out, in, kh, kw); a LayerNorm ``scale`` becomes ``weight``;
    all else is kept."""
    sd = {}
    for path, v in flatten_tree(tree).items():
        parts = path.split("/")
        leaf = parts[-1]
        if leaf == "kernel":
            parts[-1] = "weight"
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        elif leaf == "scale":
            parts[-1] = "weight"
        sd[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(v))
    return sd


def state_dict_to_tree(sd: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`tree_to_state_dict`: a 2-D ``weight`` was a dense
    kernel, a 4-D one a conv kernel, a 1-D one a LayerNorm scale."""
    flat = {}
    for name, t in sd.items():
        parts = name.split(".")
        v = t.detach().cpu().numpy()
        if parts[-1] == "weight":
            if v.ndim == 2:
                parts[-1], v = "kernel", v.T
            elif v.ndim == 4:
                parts[-1], v = "kernel", v.transpose(2, 3, 1, 0)
            else:
                parts[-1] = "scale"
        flat["/".join(parts)] = np.ascontiguousarray(v)
    return unflatten_tree(flat)
