"""A small tree flatten for dict, list, tuple and None, with a JSON
tree definition: what the platform stores with ``VolumeStore.put`` and
``JobContext.save_result`` (the JAX package uses ``jax.tree`` and a
pickled treedef there).  Anything else is a leaf.  Dict keys are sorted,
as ``jax.tree`` sorts them, and must survive JSON (str, int, float, bool).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


def flatten(tree: Any) -> Tuple[List[Any], Dict[str, Any]]:
    """Returns (leaves, treedef); the treedef is plain JSON."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return {"t": "none"}
        if isinstance(node, dict):
            keys = sorted(node)
            return {"t": "dict", "k": keys, "c": [walk(node[k]) for k in keys]}
        if isinstance(node, (list, tuple)):
            return {"t": type(node).__name__, "c": [walk(c) for c in node]}
        leaves.append(node)
        return {"t": "leaf"}

    return leaves, walk(tree)


def unflatten(treedef: Dict[str, Any], leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d):
        t = d["t"]
        if t == "none":
            return None
        if t == "leaf":
            return next(it)
        children = [build(c) for c in d["c"]]
        if t == "dict":
            return dict(zip(d["k"], children))
        return tuple(children) if t == "tuple" else children

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree definition holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in leaves])


def to_numpy(x: Any) -> np.ndarray:
    """A host array of a leaf: tensors on any device are copied back."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
