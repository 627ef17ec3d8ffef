"""Lock-discipline annotations (ISSUE 9).

``guarded_by`` is a zero-cost class decorator that DECLARES which lock
protects which attributes of a concurrent class.  It does nothing at
runtime beyond recording the mapping on the class — the enforcement is
static: the ``lock-discipline`` pass of ``tools/analysis/repro_lint.py``
reads the decorator from the AST and verifies that every access to a
guarded attribute (outside ``__init__``) is lexically inside a
``with self.<lock>:`` block of the matching lock.

Usage::

    @guarded_by("_lock", "_plans", "_packs", "hits")
    class PlanCache:
        def __init__(self):
            self._lock = threading.Lock()
            ...

``holds`` names methods that REQUIRE the lock to already be held by
their caller (private helpers called from inside a locked region).  The
pass skips enforcement inside those methods but instead verifies that
every call site of such a method within the class is itself under the
lock::

    @guarded_by("_lock", "_items", "_cursor", holds=("_scan",))
    class Scrubber: ...

A ``threading.Condition`` counts as a lock (``with self._cond:``
acquires its underlying lock), so executor-style classes annotate their
condition variable as the guard.

The mapping is also available at runtime as ``cls.__guarded_by__``
(attr -> lock name) and ``cls.__guard_holds__`` (lock name -> methods
that assume it held) for introspection and tests.
"""
from __future__ import annotations

from typing import Callable, Iterable, TypeVar

T = TypeVar("T", bound=type)


def guarded_by(
    lock_attr: str, *attrs: str, holds: Iterable[str] = ()
) -> Callable[[T], T]:
    """Declare that ``attrs`` of the decorated class are protected by
    ``self.<lock_attr>``.  Stack multiple decorators to declare several
    locks on one class.  Purely declarative — see module docstring."""
    if not attrs:
        raise ValueError("guarded_by needs at least one guarded attribute")

    def deco(cls: T) -> T:
        mapping = dict(getattr(cls, "__guarded_by__", {}))
        for a in attrs:
            mapping[a] = lock_attr
        cls.__guarded_by__ = mapping
        hold_map = dict(getattr(cls, "__guard_holds__", {}))
        hold_map[lock_attr] = tuple(
            sorted(set(hold_map.get(lock_attr, ())) | set(holds))
        )
        cls.__guard_holds__ = hold_map
        return cls

    return deco
