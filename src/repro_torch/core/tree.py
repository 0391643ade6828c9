"""A small tree flatten for dict, list, tuple, None and the port's
dataclasses, with a JSON tree definition: what the platform stores with
``VolumeStore.put`` and ``JobContext.save_result`` and the checkpoint
manager with every checkpoint (the JAX package uses ``jax.tree`` and a
pickled treedef there).  Anything else is a leaf.  Dict keys are sorted,
as ``jax.tree`` sorts them, and must survive JSON (str, int, float, bool).
A dataclass node records its class by module and name, and only classes
of ``repro_torch`` are rebuilt.

``leaf_paths``, ``get_path`` and ``from_paths`` address the leaves of a
nested dict by key paths: how the optimizer walks a parameter tree
beside its states, whose int8 leaves are themselves dicts.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch


def flatten(tree: Any) -> Tuple[List[Any], Dict[str, Any]]:
    """Returns (leaves, treedef); the treedef is plain JSON."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _walk(node: Any, leaves: List[Any]) -> Dict[str, Any]:
    # module-level, not a closure: a closure that calls itself is a
    # reference cycle, which keeps ``leaves`` (say, a model's gradients)
    # alive until the cyclic garbage collector runs
    if node is None:
        return {"t": "none"}
    if isinstance(node, dict):
        keys = sorted(node)
        return {"t": "dict", "k": keys,
                "c": [_walk(node[k], leaves) for k in keys]}
    if isinstance(node, (list, tuple)):
        return {"t": type(node).__name__,
                "c": [_walk(c, leaves) for c in node]}
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        cls = type(node)
        keys = [f.name for f in dataclasses.fields(node)]
        return {"t": "dataclass", "cls": [cls.__module__, cls.__qualname__],
                "k": keys, "c": [_walk(getattr(node, k), leaves)
                                 for k in keys]}
    leaves.append(node)
    return {"t": "leaf"}


def unflatten(treedef: Dict[str, Any], leaves: List[Any]) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree definition holds")
    return out


def _build(d: Dict[str, Any], it: Iterator[Any]) -> Any:
    t = d["t"]
    if t == "none":
        return None
    if t == "leaf":
        return next(it)
    children = [_build(c, it) for c in d["c"]]
    if t == "dict":
        return dict(zip(d["k"], children))
    if t == "dataclass":
        return _dataclass(*d["cls"])(**dict(zip(d["k"], children)))
    return tuple(children) if t == "tuple" else children


def _dataclass(module: str, name: str) -> type:
    if module != "repro_torch" and not module.startswith("repro_torch."):
        raise ValueError(f"will not rebuild {module}.{name}: only the "
                         f"port's own dataclasses")
    cls = getattr(importlib.import_module(module), name)
    if not dataclasses.is_dataclass(cls):
        raise ValueError(f"{module}.{name} is not a dataclass")
    return cls


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in leaves])


def to_numpy(x: Any) -> np.ndarray:
    """A host array of a leaf: tensors on any device are copied back."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def leaf_paths(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[str, ...]]:
    """The key path of every leaf of a nested dict, keys sorted at every
    level as ``flatten`` (and ``jax.tree``) sorts them, so the order does
    not depend on the order a dict was built in (a restored
    checkpoint's, for one)."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def get_path(tree: Any, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def from_paths(paths: List[Tuple[str, ...]], values: List[Any]
               ) -> Dict[str, Any]:
    """The nested dict holding ``values`` at ``paths``."""
    out: Dict[str, Any] = {}
    for path, value in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out
