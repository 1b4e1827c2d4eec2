"""Nested dict / list state trees (the port's counterpart of the pytree
helpers the reference's optimizer and checkpoints use).

A tree is a dict, list or tuple of trees, or a leaf (a tensor, an array
or a number).  Leaves are visited in the order `jax.tree_util` flattens
a pytree: dict keys sorted, sequences by index.
"""
from __future__ import annotations


def _children(node):
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree, prefix=()):
    """-> [(path, leaf)], each path a tuple of key / index strings."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(flatten_with_paths(child, prefix + (key,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map_with_path(fn, tree, prefix=()):
    """fn(path, leaf) over the leaves, in the tree's structure; paths as
    `flatten_with_paths` gives them."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`,
    in `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)
