"""Plain trees of dicts, lists and tuples, walked as JAX walks a pytree:
a dict's keys in sorted order, a list's or tuple's items in order, None
an empty subtree, anything else a leaf.  Checkpoints and gradient
compression address leaves by these paths, so a tree saved by either
package names its leaves alike."""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in JAX's order; a path is the tuple of dict keys and
    sequence indices from the root."""
    out: list[tuple[tuple, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, path + (i,))
        elif node is not None:
            out.append((path, node))
    walk(tree, ())
    return out


def key(path: tuple) -> str:
    """A path as the reference's checkpoint key: its parts joined by /."""
    return "/".join(str(p) for p in path)


def map_with_path(fn: Callable, tree, *rest,
                  is_leaf: Callable[[Any], bool] | None = None):
    """A tree of tree's structure whose leaf at each path is fn(path,
    leaf, *the leaves at the same path in `rest`)."""
    def walk(node, others, path):
        if is_leaf is not None and is_leaf(node):
            return fn(path, node, *others)
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, [o[k] for o in others], path + (k,))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, [o[i] for o in others], path + (i,))
                              for i, v in enumerate(node))
        return fn(path, node, *others)
    return walk(tree, list(rest), ())
