"""Parameter trees between the JAX package and the port.

A parameter tree is nested dicts and lists whose leaves are arrays, with
the ``rom``/``sram`` split of the JAX package.  The JAX side hands trees
over as numpy arrays (``jax.tree.map(np.asarray, params)``); this module
turns them into the port's tree of tensors on a device and back.

Leaves are named with the keystr scheme of the JAX checkpoint manager
(``checkpoint/manager.py::_flatten``): ``['convs'][0]['rom']['w_q']``,
dict keys in sorted order, ``None`` leaves dropped — so a checkpoint
written by either package can be addressed leaf by leaf.

LM trees keep the JAX package's stacked layout (every leaf under
``['layers']`` carries a leading L dim), so they cross unchanged.  numpy
has no bfloat16 of its own: JAX hands bfloat16 leaves over as
``ml_dtypes.bfloat16`` arrays, which cross through float32 (exact).
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


def tree_map2(a, b, fn):
    """``fn(leaf_a, leaf_b)`` over two trees of the same structure."""
    if isinstance(a, dict):
        return {k: tree_map2(a[k], b[k], fn) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(tree_map2(x, y, fn) for x, y in zip(a, b))
    return None if a is None else fn(a, b)


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def to_torch(tree, device) -> dict:
    """numpy (or array-like) leaves -> tensors on ``device``, dtype kept."""
    return tree_map(tree, lambda a: _leaf_to_torch(a, device))


def to_numpy(tree) -> dict:
    """Tensor leaves -> host numpy arrays, dtype kept (bfloat16 leaves come
    back as float32, which holds them exactly)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(tree, leaf)


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


def map_named(tree, fn, prefix: str = ""):
    """``fn(keystr, leaf)`` over every non-None leaf, names as
    :func:`flatten` gives them; the tree's structure is kept."""
    if isinstance(tree, dict):
        return {k: map_named(v, fn, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_named(v, fn, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def abstract(fn, *args):
    """The tree ``fn(*args)`` returns, as meta tensors of the same shapes
    and dtypes, with no memory allocated on any device (the port's
    ``jax.eval_shape``): ``fn`` runs under a fake-tensor mode, so even
    full-width initialisers cost only their host bookkeeping."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = fn(*args)
    return tree_map(tree, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                device="meta"))
