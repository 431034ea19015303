"""State carried across from the JAX package.

The matched-filter path has no learned weights: its state is the
design — the f-k mask, the bandpass gain and the template stack with
its threshold policy. ``design_from_arrays`` builds the port's
``MatchedFilterDesign`` from the JAX design's fields given as numpy
arrays and Python scalars, so both packages can run on one and the same
mask and template stack; ``MatchedFilterDetector.from_design`` then
builds a detector on it. Nothing here imports the JAX package: the
caller hands over plain arrays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .models.matched_filter import MatchedFilterDesign

#: The design fields carried across, by their JAX names.
DESIGN_FIELDS = (
    "fk_mask", "bp_gain", "bp_padlen", "templates", "template_names",
    "trace_shape", "fs", "bp_band", "fk_channels", "threshold_factors",
    "threshold_scope",
)


def design_from_arrays(d: Mapping) -> MatchedFilterDesign:
    """``{field: numpy array or Python scalar}`` for every name in
    :data:`DESIGN_FIELDS` -> the port's ``MatchedFilterDesign``. Arrays are
    copied with their dtypes unchanged, so the result equals the source
    design bit for bit."""
    missing = [f for f in DESIGN_FIELDS if f not in d]
    if missing:
        raise KeyError(f"design fields missing: {missing}")
    return MatchedFilterDesign(
        fk_mask=np.array(d["fk_mask"]),
        bp_gain=np.array(d["bp_gain"]),
        bp_padlen=int(d["bp_padlen"]),
        templates=np.array(d["templates"]),
        template_names=tuple(str(n) for n in d["template_names"]),
        trace_shape=tuple(int(s) for s in d["trace_shape"]),
        fs=float(d["fs"]),
        bp_band=tuple(float(b) for b in d["bp_band"]),
        fk_channels=int(d["fk_channels"]),
        threshold_factors=np.array(d["threshold_factors"]),
        threshold_scope=str(d["threshold_scope"]),
    )
