"""Cached shallow detector views (the resource ladder's rung views; the
port's copy of ``das4whales_tpu.utils.views``).

Every detector family exposes memory-lean "views" of itself for the
planner's downshift ladder (``workflows.planner``): a shallow copy
sharing the design/device arrays with ONE knob changed (channel tile,
spectrogram chunk, classifier row chunk, host placement). The
copy-pop-mutate-cache dance is identical everywhere — one
implementation here so the idiom cannot diverge per family.
"""

from __future__ import annotations

import copy

#: every view-cache slot a shallow copy must shed: a view must never
#: inherit its parent's cached views (a tiled view's host_view must be
#: derived from the tiled knobs, not aliased to the parent's; a bank
#: view's tiled/host views from the sub-bank slice, and vice versa)
_VIEW_CACHE_ATTRS = ("_tiled_view_cache", "_host_view_cache",
                     "_bank_view_cache")


def cached_shallow_view(obj, cache_attr: str, mutate):
    """Return (and memoize on ``obj.__dict__[cache_attr]``) a shallow
    copy of ``obj`` with ``mutate(view)`` applied. The copy sheds every
    known view-cache slot before mutation; repeated calls return the
    SAME view object (the ladder's rung views are sticky, so identity
    caching keeps one compiled program per rung)."""
    cached = obj.__dict__.get(cache_attr)
    if cached is not None:
        return cached
    view = copy.copy(obj)
    for attr in _VIEW_CACHE_ATTRS:
        view.__dict__.pop(attr, None)
    mutate(view)
    obj.__dict__[cache_attr] = view
    return view
