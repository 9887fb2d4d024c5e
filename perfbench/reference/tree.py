"""Tree helpers over nested dicts, lists and tuples of tensors."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> list:
    """(path, leaf) pairs, dict keys sorted, paths such as
    ``groups/0/slots/1/mixer/wq``."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in tree_items(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree)
                for e in tree_items(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]
