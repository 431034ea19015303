"""Ingest: OptaSense HDF5 and Silixa TDMS readers, the native C++ reader,
the ordered multi-file streams and slab assembler, pinned staging onto
the card, and synthetic scenes."""

from . import coords, download, hdf5, interrogators, native, stream, synth, tdms  # noqa: F401
from .download import dl_file  # noqa: F401
from .hdf5 import StrainBlock, load_das_data, raw2strain, write_optasense  # noqa: F401
from .interrogators import get_acquisition_parameters  # noqa: F401
from .stream import stream_file_batches, stream_strain_blocks  # noqa: F401


def hello_world_das_package():
    """Smoke-test greeting (reference ``data_handle.py:21-22``)."""
    print("Yepee! You now have access to all the functionalities of the das4whales_tpu "
          "package!")
