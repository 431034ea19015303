"""Ingest: OptaSense HDF5 and Silixa TDMS readers, the native C++ reader,
the ordered multi-file streams and slab assembler, pinned staging onto
the card, and synthetic scenes."""
