"""Nested parameter dicts <-> flat ``{path: tensor}`` dicts in JAX's
flatten order (dict keys sorted at every level).

The optimizer walks leaves in this order, and the per-leaf sketch of the
JAX package is keyed by a leaf's position in it, so both packages have to
agree on it.  Flattening and unflattening share tensors; nothing is copied.
"""
from __future__ import annotations


def flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            flat.update(flatten(tree[key], path + "/"))
        else:
            flat[path] = tree[key]
    return flat


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree
