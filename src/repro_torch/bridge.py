"""Parameter trees between the JAX package and the port.

A parameter tree is nested dicts and lists whose leaves are arrays, with
the ``rom``/``sram`` split of the JAX package.  The JAX side hands trees
over as numpy arrays (``jax.tree.map(np.asarray, params)``); this module
turns them into the port's tree of tensors on a device and back.

Leaves are named with the keystr scheme of the JAX checkpoint manager
(``checkpoint/manager.py::_flatten``): ``['convs'][0]['rom']['w_q']``,
dict keys in sorted order, ``None`` leaves dropped — so a checkpoint
written by either package can be addressed leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(tree, fn):
    """``fn`` applied to every non-None leaf of a dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(v, fn) for v in tree)
    return None if tree is None else fn(tree)


def to_torch(tree, device) -> dict:
    """numpy (or array-like) leaves -> tensors on ``device``, dtype kept."""
    return tree_map(tree, lambda a: torch.from_numpy(np.array(a)).to(device))


def to_numpy(tree) -> dict:
    """Tensor leaves -> host numpy arrays, dtype kept."""
    return tree_map(tree, lambda t: t.detach().cpu().numpy())


def flatten(tree, prefix: str = "") -> dict:
    """``{keystr: leaf}`` in the JAX flatten order (dict keys sorted)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}[{k!r}]"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}[{i}]"))
    elif tree is not None:
        out[prefix] = tree
    return out
