"""The modules no process of a run may load: JAX, its libraries and the
JAX package (top-level names compared whole, since the port's name,
``panvc3_tpu_torch``, begins with the JAX package's).  The consumer and
the plain reference also may not load the port."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "panvc3_tpu")
PROGRAM = "panvc3_tpu_torch"


def forbidden_loaded(also: tuple[str, ...] = ()) -> list[str]:
    """The forbidden top-level module names this process has loaded, with
    ``also`` forbidden too."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & {*FORBIDDEN, *also})
