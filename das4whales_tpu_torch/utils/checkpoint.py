"""Checkpointing of design artifacts (the port's copy of
``das4whales_tpu.utils.checkpoint``).

A design is host work done once per shape — the matched filter's f-k
mask takes tens of seconds of float64 numpy at the canonical shape — so
a campaign loads it instead of redoing it. Design dataclasses are flat
bags of numpy arrays + static Python fields, so a checkpoint is a single
``.npz``: array fields stored natively, static fields in an embedded
JSON header. No pickle — files are portable and safe to load. The
format is the JAX package's: a checkpoint either package writes loads
in the other under the same type name (``MatchedFilterDesign``, which
``models.matched_filter`` registers here).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type

import numpy as np

from . import artifacts

_REGISTRY: Dict[str, Type] = {}


def register_design(cls: Type) -> Type:
    """Register a dataclass so checkpoints can name their type."""
    _REGISTRY[cls.__name__] = cls
    return cls


def _builtin(value):
    if isinstance(value, tuple):
        return list(value)
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    return value


def save_design(path: str, design: Any) -> str:
    """Write a design dataclass to ``path`` (.npz). Returns the path."""
    if not dataclasses.is_dataclass(design):
        raise TypeError(f"save_design expects a dataclass, got {type(design)}")
    arrays = {}
    static: Dict[str, Any] = {}
    for f in dataclasses.fields(design):
        value = getattr(design, f.name)
        if isinstance(value, np.ndarray) or hasattr(value, "__array_namespace__") or (
            hasattr(value, "shape") and hasattr(value, "dtype")
        ):
            arrays[f.name] = np.asarray(value)
        else:
            static[f.name] = _builtin(value)
    header = json.dumps({"type": type(design).__name__, "static": static})
    if not path.endswith(".npz"):
        path += ".npz"   # np.savez(str) appended it; the durable writer
        # takes a file handle, so preserve that contract explicitly
    with artifacts.atomic_file(path, "wb") as fh:
        np.savez(fh, __header__=np.frombuffer(header.encode(),
                                              dtype=np.uint8), **arrays)
    return path


def load_design(path: str, cls: Type | None = None) -> Any:
    """Load a design checkpoint written by :func:`save_design`.

    ``cls`` overrides the registry lookup (needed only for unregistered
    types)."""
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"].tobytes()).decode())
        fields: Dict[str, Any] = dict(header["static"])
        for key in data.files:
            if key != "__header__":
                fields[key] = data[key]
    if cls is None:
        cls = _REGISTRY.get(header["type"])
        if cls is None:
            raise KeyError(
                f"design type {header['type']!r} is not registered; pass cls= explicitly")
    # dataclasses with tuple-typed fields get lists back from JSON; coerce
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            # a field added after this checkpoint was written (e.g. the
            # template-bank threshold_factors/threshold_scope pair):
            # the dataclass default/__post_init__ reconstructs the
            # legacy value, so old artifacts keep loading
            continue
        value = fields[f.name]
        if isinstance(value, list):
            value = tuple(value)
        kwargs[f.name] = value
    return cls(**kwargs)
