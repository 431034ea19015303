"""Synthetic scenes (the port's only input in this slice)."""
