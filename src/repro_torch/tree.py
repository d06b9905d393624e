"""Nested containers of tensors (the port's pytrees) in the JAX package's
leaf order.

A tree is a dict, a NamedTuple, a tuple or a list of trees, or a leaf.
``jax.tree.leaves`` visits a dict's keys sorted, a NamedTuple's fields and
a sequence's items in order; :func:`named_leaves` visits them the same
way and names each leaf as ``jax.tree_util.keystr`` does (``['k']`` for a
dict key, ``.f`` for a NamedTuple field, ``[i]`` for a sequence item).
Sums over leaves (AdamW's global norm) and the checkpoint's leaf names
follow this order.
"""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def named_leaves(tree, prefix: str = ""):
    """Yield ``(name, leaf)`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from named_leaves(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in named_leaves(tree)]


def map_named(fn, tree, prefix: str = ""):
    """``tree``'s structure with ``fn(name, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_named(fn, getattr(tree, f), f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_named(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def unflatten_like(tree, new_leaves):
    """``tree``'s structure holding ``new_leaves``, given in
    :func:`leaves` order."""
    by_name = dict(zip((n for n, _ in named_leaves(tree)), new_leaves))
    return map_named(lambda name, _: by_name[name], tree)
