"""Which modules of JAX, its libraries or the JAX package a process has
loaded, compared by whole top-level names (``grakel_torch`` begins with
the JAX package's name and is not one of them)."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_loaded"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "grakel_tpu"})


def forbidden_loaded(names=FORBIDDEN, modules=None):
    """The sorted top-level names among ``modules`` (default
    ``sys.modules``) that are in ``names``."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in mods} & set(names))
