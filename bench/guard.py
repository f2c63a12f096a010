"""The import guard: the run's process may hold no module of JAX or of
the JAX package.  Names are compared whole, by their top-level part
(before the first dot): ``repro_torch`` is the port, ``repro`` the JAX
package."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def offenders(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``modules`` (e.g.
    ``sys.modules``)."""
    return sorted({name.split(".", 1)[0] for name in modules}
                  & FORBIDDEN)
