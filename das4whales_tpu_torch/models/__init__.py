"""Detectors: the matched filter and its call templates. The spectro,
Gabor and learned families are imported by path."""

from . import matched_filter, templates  # noqa: F401
from .matched_filter import MatchedFilterDetector  # noqa: F401
