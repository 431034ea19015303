"""Detectors: the matched filter and its call templates."""
