"""The prefilter every signal-processing family shares (the port's copy
of ``das4whales_tpu.workflows.common.mf_prefilter``)."""

from __future__ import annotations

from ..config import ChannelSelection, as_metadata
from ..models.matched_filter import MatchedFilterDetector


def mf_prefilter(metadata, selected_channels, trace_shape=None, *,
                 fused_bandpass: bool = True, device=None) -> MatchedFilterDetector:
    """The bandpass + f-k front end of main_mfdetect / main_spectrodetect:
    a :class:`MatchedFilterDetector` whose ``filter_block`` is the
    prefilter. ``trace_shape=None`` derives the post-selection shape from
    the metadata."""
    meta = as_metadata(metadata)
    if trace_shape is None:
        sel = ChannelSelection.from_list(list(selected_channels))
        trace_shape = (sel.n_channels(meta.nx), meta.ns)
    return MatchedFilterDetector(meta, list(selected_channels), tuple(trace_shape),
                                 fused_bandpass=fused_bandpass, device=device)
