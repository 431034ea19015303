"""Detector wiring of the reference's workflows (the port's copy): each
main is a ``main(url=None, outdir=None, ...)`` callable that runs offline
on a synthetic OOI-like scene when no URL or file is given."""

from . import (bathynoise, common, fkcomp, gabordetect, longrecord, mfdetect,  # noqa: F401
               planner, plots, spectrodetect)
from .common import acquire, default_scene  # noqa: F401
from .longrecord import detect_long_record  # noqa: F401
from .planner import DetectorProgram, RoutePlanner, program_for  # noqa: F401
