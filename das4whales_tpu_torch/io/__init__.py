"""Ingest: OptaSense HDF5 and Silixa TDMS readers, the native C++ reader,
the ordered multi-file streams and slab assembler, pinned staging onto
the card, and synthetic scenes."""


def hello_world_das_package():
    """Smoke-test greeting (reference ``data_handle.py:21-22``)."""
    print("Yepee! You now have access to all the functionalities of the das4whales_tpu "
          "package!")
