"""The kernel wrappers' launch tallies, in one registry.

Each kernel wrapper counts its launches on itself: an int per variant
(``launches``, ``ring_launches``, ``w8a8_launches``, ...) and a Counter per
shape or dtype (``by_shape``, ``by_dtype``). ``counted`` zeroes a wrapper's
tallies and registers their names here, so this module knows every tally
there is. ``snapshot``, ``delta`` and ``add`` read and move all of them at
once: a caller whose kernels run without the wrappers' calls (a CUDA
graph's replay, ``runtime.decode_graph``) keeps them as counting every call
would.
"""

from __future__ import annotations

import collections

_REGISTRY: dict = {}  # wrapper -> the names of its tallies


def counted(*ints: str, counters: tuple = ()):
    """Decorator: the wrapper's tallies ``ints`` set to 0 and ``counters``
    to empty Counters, and every name registered."""
    def register(wrapper):
        for name in ints:
            setattr(wrapper, name, 0)
        for name in counters:
            setattr(wrapper, name, collections.Counter())
        _REGISTRY[wrapper] = ints + tuple(counters)
        return wrapper
    return register


def snapshot() -> dict:
    """A copy of every registered tally: {(wrapper, name): count, or a
    Counter}."""
    out = {}
    for fn, names in _REGISTRY.items():
        for name in names:
            value = getattr(fn, name)
            out[fn, name] = collections.Counter(value) if isinstance(value, dict) else value
    return out


def delta(before: dict, after: dict) -> dict:
    """What the wrappers counted from ``before`` to ``after`` (two
    ``snapshot``s): each changed count, and of a Counter its changed keys."""
    out = {}
    for key, old in before.items():
        new = after[key]
        if isinstance(old, dict):
            diff = {k: new[k] - old[k] for k in new.keys() | old.keys() if new[k] != old[k]}
        else:
            diff = new - old
        if diff:
            out[key] = diff
    return out


def add(change: dict, times: int = 1) -> None:
    """Add ``times`` x ``change`` (a ``delta``) to the wrappers' tallies; a
    Counter key that comes to zero is removed, as counting the calls never
    made it."""
    for (fn, name), diff in change.items():
        if not isinstance(diff, dict):
            setattr(fn, name, getattr(fn, name) + times * diff)
            continue
        counter = getattr(fn, name)
        for k, v in diff.items():
            counter[k] += times * v
            if not counter[k]:
                del counter[k]
