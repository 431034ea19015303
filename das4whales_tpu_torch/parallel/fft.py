"""Distributed 2-D FFT and f-k filtering over a channel-sharded mesh (the
port of ``das4whales_tpu.parallel.fft``).

The channel axis is split over the mesh's ``channel`` axis and the
transform runs as a pencil decomposition:

1. rFFT along time — local (time is whole on every rank);
2. ``all_to_all`` transpose over ``channel``: the frequency axis is
   scattered, the channel axis gathered;
3. FFT along channels — now local;
4. the (frequency-sharded) f-k mask;
5. inverse channel FFT, ``all_to_all`` back, inverse rFFT.

The only communication is the two ``all_to_all``\\ s, and the banded form
carries only the mask's in-band rFFT columns. The result equals the one-
device ``ops.fk.fk_filter_apply_rfft`` up to the FFT's rounding.

Each rank calls these with its LOCAL block and gets its local result
(``parallel.mesh``). Functions ending in ``_local`` are the JAX package's
``shard_map`` bodies; they take the axis name and the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fk import banded_mask_half, symmetrize_mask_fftorder  # noqa: F401
from . import collectives as coll
from .mesh import Mesh, Sharding


def prepare_mask_half(mask: np.ndarray, nns: int, pad_f: int = 0) -> np.ndarray:
    """Hermitian-symmetrize an fftshifted ``[k x f]`` mask and keep the
    rfft half ``[k x nns//2+1]`` (fft order along k), zero-padded along f
    by ``pad_f`` (to a multiple of the mesh axis size)."""
    half = symmetrize_mask_fftorder(mask)[:, : nns // 2 + 1]
    if pad_f:
        half = np.pad(half, ((0, 0), (0, pad_f)))
    return half


def fk_apply_local(trace: torch.Tensor, mask_half: torch.Tensor, axis_name: str, *,
                   mesh: Mesh) -> torch.Tensor:
    """f-k filter a channel-sharded ``[..., C/P, T]`` block against this
    rank's columns ``[..., K, F_pad/P]`` of the half mask. The full-band
    case of :func:`fk_apply_local_banded`."""
    nns = trace.shape[-1]
    return fk_apply_local_banded(trace, mask_half, 0, nns // 2 + 1, axis_name, mesh=mesh)


def fk_apply_local_banded(trace: torch.Tensor, mask_band: torch.Tensor, lo: int, hi: int,
                          axis_name: str, *, mesh: Mesh) -> torch.Tensor:
    """Band-limited :func:`fk_apply_local`: the two transposes and the
    channel FFT pair carry only the in-band rFFT columns ``[lo, hi)``,
    padded to a multiple of the axis size; out-of-band columns are zero.
    ``mask_band`` is this rank's ``[K, B_pad/P]`` columns."""
    p = mesh.axis_size(axis_name)
    nns = trace.shape[-1]
    nf = nns // 2 + 1
    nb = hi - lo
    pad_b = (-nb) % p
    spec = torch.fft.rfft(trace, dim=-1)                      # [..., C/P, F]
    band = spec[..., lo:hi]
    if pad_b:
        band = torch.nn.functional.pad(band, (0, pad_b))
    nd = band.ndim
    # scatter the band, gather C -> [..., C, Bp/P]
    band = coll.all_to_all(band, mesh, axis_name, split_axis=nd - 1, concat_axis=nd - 2)
    band = torch.fft.fft(band, dim=-2)
    band = band * mask_band.to(band.real.dtype)
    band = torch.fft.ifft(band, dim=-2)
    # scatter C, gather the band -> [..., C/P, Bp]
    band = coll.all_to_all(band, mesh, axis_name, split_axis=nd - 2, concat_axis=nd - 1)
    full = torch.zeros(spec.shape[:-1] + (nf,), dtype=spec.dtype, device=spec.device)
    full[..., lo:hi] = band[..., :nb]
    del spec, band
    return torch.fft.irfft(full, n=nns, dim=-1).to(trace.dtype)


def prepare_mask_band(mask: np.ndarray, p: int, tol: float = 1e-6):
    """The banded half-spectrum mask padded along f to a multiple of the
    mesh axis size ``p``: ``(mask_band [K, B_pad], lo, hi)``."""
    mask_band, lo, hi = banded_mask_half(mask, tol=tol)
    pad_b = (-(hi - lo)) % p
    if pad_b:
        mask_band = np.pad(mask_band, ((0, 0), (0, pad_b)))
    return mask_band, lo, hi


def sharded_fk_apply(trace: torch.Tensor, mask, mesh: Mesh,
                     channel_axis: str = "channel") -> torch.Tensor:
    """f-k filter this rank's channel slice ``[C/P, T]`` of a block split
    over ``channel_axis``; ``mask`` is the GLOBAL fftshifted ``[C, T]``
    design. Returns this rank's slice of the filtered block."""
    nnx_local, nns = trace.shape
    p = mesh.axis_size(channel_axis)
    mask = np.asarray(mask)
    if mask.shape != (nnx_local * p, nns):
        raise ValueError(f"mask {mask.shape} does not fit {p} channel shards of "
                         f"{tuple(trace.shape)}")
    nf = nns // 2 + 1
    pad_f = (-nf) % p
    half = Sharding(mesh, (None, channel_axis)).place(prepare_mask_half(mask, nns, pad_f))
    return fk_apply_local(trace, half.to(trace.device), channel_axis, mesh=mesh)


def pfft2(x: torch.Tensor, mesh: Mesh, channel_axis: str = "channel") -> torch.Tensor:
    """Distributed complex 2-D FFT of this rank's channel slice ``[C/P,
    T]``; returns this rank's frequency slice ``[K, F/P]`` of the
    spectrum (the pencil layout)."""
    nnx_local, nns = x.shape
    p = mesh.axis_size(channel_axis)
    if nns % p:
        raise ValueError("both axes must be divisible by the mesh axis size")
    s = torch.fft.fft(x, dim=-1)
    s = coll.all_to_all(s, mesh, channel_axis, split_axis=1, concat_axis=0)
    return torch.fft.fft(s, dim=-2)
