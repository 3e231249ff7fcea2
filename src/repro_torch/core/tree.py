"""Parameter trees of the port: ordered ``{path: leaf}`` mappings.

The reference keeps parameters as jax pytrees and salts every leaf's fault
stream with its index in ``jax.tree_util.tree_flatten`` order, which visits
dict keys sorted at every level (``embed``, ``groups/blk0/attn/wk``, ...,
``unembed``). The port keeps them as flat mappings whose keys are the
``/``-joined paths and whose order is that same flatten order, so leaf
index ``i`` salts the same stream on both sides.
"""
from __future__ import annotations

from typing import Dict, Mapping


def flatten(tree: Mapping, keep_none: bool = False) -> Dict[str, object]:
    """Nested (dicts, lists, tuples) or flat mapping -> ``{path: leaf}`` in
    the reference's flatten order: dict keys sorted at every level (sorting
    whole ``/``-split paths does the same), sequences in order. Empty
    containers and ``None`` hold no leaf, as in jax; ``keep_none`` keeps
    ``None`` as a leaf, as the reference's trees of frozen exponents and
    signs flatten with ``is_leaf=lambda x: x is None``."""
    out = []

    def walk(node, key):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, key + tuple(str(k).split("/")))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, key + (i,))
        elif node is not None or keep_none:
            out.append((key, node))

    walk(tree, ())
    out.sort(key=lambda kv: kv[0])
    return {"/".join(map(str, k)): leaf for k, leaf in out}
