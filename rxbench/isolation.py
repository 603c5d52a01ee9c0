"""The run's own check that neither JAX nor the JAX package is loaded.

Module names are compared by their top-level name, whole: the port
``liquiddsp_tpu_torch`` begins with the JAX package's name and passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "liquiddsp_tpu"})


class Loaded(RuntimeError):
    pass


def found(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def check(when: str, modules=None) -> None:
    bad = found(modules)
    if bad:
        raise Loaded(f"{when}, the process holds {', '.join(bad[:10])}"
                     f"{' and more' if len(bad) > 10 else ''}: the benchmark measures "
                     "liquiddsp_tpu_torch alone")
