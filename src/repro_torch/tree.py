"""Parameter trees: the port's ``jax.tree``.

A tree is nested dicts, lists and tuples (``NamedTuple`` s such as
``train.optimizer.OptState`` included) whose leaves are tensors.  A
dataclass node (``PasmParams``, ``ConvParams``, ``PASMTensor``) contributes
each field that holds a tensor; its other fields (kind, shapes, bins) are
metadata that every mapped tree keeps.  ``None`` is an empty subtree, as in
``jax.tree``.  The optimizer maps over these trees and the checkpoint keys
its arrays by their paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_leaves", "flatten_with_path", "tree_unflatten", "STACKED"]

# the per-layer (per-group) lists of the LM params trees, which the JAX
# package stacks on a leading axis: its one leaf at a path is the list's
# leaves there, layer after layer
STACKED = ("layers", "groups", "enc_layers", "dec_layers")


def _is_node(t: Any) -> bool:
    return isinstance(t, (dict, list, tuple)) or (
        dataclasses.is_dataclass(t) and not isinstance(t, type))


def _items(t: Any) -> list:
    """``(key, child)`` pairs of a node, in a fixed order."""
    if isinstance(t, dict):
        return list(t.items())
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return list(zip(t._fields, t))
    if isinstance(t, (list, tuple)):
        return list(enumerate(t))
    return [(f.name, getattr(t, f.name)) for f in dataclasses.fields(t)
            if isinstance(getattr(t, f.name), torch.Tensor)]


def _child(t: Any, key) -> Any:
    if t is None:
        return None
    if isinstance(t, (dict, list)) or (isinstance(t, tuple) and not hasattr(t, "_fields")):
        return t[key]
    return getattr(t, key)


def _rebuild(t: Any, keys: list, values: list) -> Any:
    if isinstance(t, dict):
        return dict(zip(keys, values))
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*values)
    if isinstance(t, (list, tuple)):
        return type(t)(values)
    return dataclasses.replace(t, **dict(zip(keys, values)))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest)`` over the leaves of ``tree``; returns
    the same structure.  ``rest`` trees follow ``tree``'s structure; where
    one holds ``None`` in place of a subtree, ``fn`` gets ``None`` there."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    items = _items(tree)
    values = [tree_map(fn, c, *(_child(r, k) for r in rest)) for k, c in items]
    return _rebuild(tree, [k for k, _ in items], values)


def flatten_with_path(tree: Any, path: tuple = ()) -> list:
    """``[(path, leaf)]`` in :func:`tree_map`'s order; a path is the tuple
    of dict keys, sequence indices and field names down to the leaf, as
    strings."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(path, tree)]
    out = []
    for k, c in _items(tree):
        out += flatten_with_path(c, path + (str(k),))
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_unflatten(template: Any, leaves: list) -> Any:
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
