"""Detector wiring of the reference's workflows (the port's copy)."""
