"""Parameter and state trees as nested dicts of tensors.

The port keeps the JAX package's tree paths, so its trees are plain nested
dicts.  A dict leaf — a quantized plane such as `{"packed", "scale"}` —
is kept whole when `is_leaf` says so; without `is_leaf` the walk descends
into it, as JAX's flatten does.  Keys are visited in sorted order, the
JAX flatten order; `leaves_with_path` also walks lists, by index.
"""
from __future__ import annotations

from typing import Callable, Optional


def _walk(tree, path, is_leaf):
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,), is_leaf)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,), is_leaf)
    else:
        yield path, tree


def keystr(path: tuple) -> str:
    """JAX's `keystr` form of a path: "['blocks']['att']['wr']", a list
    index as "[0]"."""
    return "".join(f"[{k!r}]" for k in path)


def leaves_with_path(tree, is_leaf: Optional[Callable] = None):
    """[(path tuple, leaf)] in sorted-key order."""
    return list(_walk(tree, (), is_leaf))


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """Apply fn leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict) and not (is_leaf is not None and is_leaf(tree)):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    return fn(tree, *rest)
