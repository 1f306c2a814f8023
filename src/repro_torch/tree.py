"""Trees of nested dicts, flattened in ``jax.tree.flatten`` order.

JAX flattens a dict by its sorted keys, so a train state flattens as
``opt`` < ``params`` < ``step`` and a parameter tree as ``blocks`` <
``embed`` < ``final_norm``, whatever the insertion order.  The checkpoint
layout numbers its leaves in that order, so the two packages read each
other's checkpoints leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def map_leaves(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def items(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from items(tree[key], f"{prefix}/{key}")
    else:
        yield prefix or "/", tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in items(tree)]


def unflatten(like: Any, flat: list) -> Any:
    """A tree of ``like``'s structure holding ``flat`` in sorted-key order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def structure(tree: Any) -> str:
    """The tree's shape as text, leaves as ``*`` (JAX's ``PyTreeDef`` form)."""
    def fmt(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"'{k}': {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        return "*"

    return f"PyTreeDef({fmt(tree)})"
