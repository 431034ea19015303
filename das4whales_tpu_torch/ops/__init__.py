"""Signal-processing operators on torch tensors. The two kernels'
wrappers, ``fused_picks`` and ``fused_stft``, are imported by path; none
builds its kernel before its first launch."""

from . import (chunked, conditioning, fk, filters, health, image, mxu, peaks,  # noqa: F401
               spectral, xcorr)
