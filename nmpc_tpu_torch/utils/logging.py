"""print_level-gated solver logging.

Port of ``nmpc_tpu/utils/logging.py``.  The reference gates ``std::cout``
diagnostics on an integer ``print_level`` (0-3) in every component
(``DDPSolver.h:62-63``, ``BoxQP.h:35-36``, ``FmpcSolver.h:60-61``; usage
e.g. ``DDPSolver.hpp:106-109,198-207``).  Here a message at or above its
threshold is a Python ``print``; below it nothing is evaluated, so the
default level 0 reads no device value.  Tensor arguments and event
predicates are brought to the host by ``read`` (the solvers pass their
counted host read).
"""

from __future__ import annotations


def _item(v):
    return v.item() if hasattr(v, "item") else v


def log(print_level: int, threshold: int, fmt: str, *, read=_item,
        **kwargs) -> None:
    """Message at ``threshold`` or above; ``fmt`` is a ``str.format``
    template over ``kwargs``."""
    if print_level >= threshold:
        print(fmt.format(**{k: read(v) for k, v in kwargs.items()}),
              flush=True)


def log_when(print_level: int, threshold: int, pred, fmt: str, *,
             read=_item, **kwargs) -> None:
    """Message gated on an event predicate as well (a bool tensor, read
    only when the level admits the message)."""
    if print_level >= threshold and read(pred):
        log(print_level, threshold, fmt, read=read, **kwargs)
