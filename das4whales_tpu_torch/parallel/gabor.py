"""Gabor/image detection over a device mesh: file-parallel batches and
time-split long records (the port of ``das4whales_tpu.parallel.gabor``).

The Gabor pipeline's 2-D image operators couple channels (the oriented
pair spans about 100 binned pixels, about 1000 raw channels, of the t-x
image; reference ``improcess.py:98-140``), so channel sharding would need
kilochannel halos. Two layouts avoid that:

* :func:`make_sharded_gabor_step` — data parallelism over FILES: each
  rank owns whole files and runs the whole image pipeline on them, one
  file at a time (only one file's image temps live at once), with no
  collective;
* :func:`make_sharded_gabor_step_time` — one record longer than a card,
  its TIME axis split: one ``all_to_all`` relabel, ``pmin``/``pmax``
  pairs for the pipeline's global scalings, a channel-row halo for the
  two-stage Gabor receptive field, one ``pmax`` for the threshold.

Both pick through the fused pick kernel
(``ops.fused_picks.analytic_envelope_peaks``: the Hilbert transform on
``torch.fft``, then the hand-written counterpart of the JAX package's
Pallas ``_picks_kernel`` on a CUDA tensor, its plain version on the CPU)
at JAX's ``find_peaks_sparse_batched`` settings (``max_peaks``,
``topk``), as ``models.gabor.GaborDetector`` does.

Every rank calls the factories with the same arguments and the step with
its LOCAL slice (``parallel.mesh``). ``design=`` and ``note_arrays=``
take a ready design and note samples (``convert`` carries the JAX
package's across), as ``GaborDetector`` does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import C0_WATER, ChannelSelection, as_metadata
from ..models.gabor import DEFAULT_NOTES, design_gabor, gabor_mask, masked_matched_filter
from ..models.gabor import synthesize_notes
from ..ops import fused_picks
from ..ops import image as img_ops
from ..ops import peaks as peak_ops
from ..ops import spectral
from . import collectives as coll
from .mesh import Mesh, Sharding
from .timeshard import halo_exchange

#: the pick method of both steps (JAX's ``find_peaks_sparse_batched``
#: default)
PICK_METHOD = "topk"


def gabor_input_sharding(mesh: Mesh, file_axis: str = "file") -> Sharding:
    """A ``[file x channel x time]`` batch with files split over the
    mesh's file axis and every file whole on its rank."""
    return Sharding(mesh, (file_axis, None, None))


def _notes_and_factors(notes, note_arrays, fs, hf_factor, dev):
    """The notes at their TRUE length on ``dev`` (the ``same`` window of
    ``masked_matched_filter`` is centred by the note's length, so padding
    them to a common length would shift every pick) and the per-note
    threshold factors, by name (HF at ``hf_factor``)."""
    params = dict(DEFAULT_NOTES if notes is None else notes)
    names = tuple(params)
    arrays = note_arrays if note_arrays is not None else synthesize_notes(params, fs)
    if set(arrays) != set(names):
        raise ValueError(f"note arrays {sorted(arrays)} != notes {sorted(names)}")
    notes_dev = [torch.as_tensor(np.asarray(arrays[n], np.float32), device=dev) for n in names]
    factors = torch.as_tensor([hf_factor if n == "HF" else 1.0 for n in names],
                              dtype=torch.float32, device=dev)
    return names, notes_dev, factors


def _picks(corr: torch.Tensor, thr: torch.Tensor, max_peaks: int) -> peak_ops.SparsePicks:
    """The envelope picks of ``corr [nT, ..., T]`` with ``thr [nT]``."""
    shape = (-1,) + (1,) * (corr.ndim - 2)
    return fused_picks.analytic_envelope_peaks(corr, thr.reshape(shape), max_peaks=max_peaks,
                                               method=PICK_METHOD)


def make_sharded_gabor_step(
    metadata,
    selected_channels,
    mesh: Mesh,
    c0: float = C0_WATER,
    notes: Dict[str, Tuple[float, float, float]] | None = None,
    max_peaks: int = 256,
    relative_threshold: float = 0.5,
    hf_factor: float = 0.9,
    file_axis: str = "file",
    *,
    design=None,
    note_arrays: Dict[str, np.ndarray] | None = None,
):
    """The file-sharded Gabor step: returns ``(step, names)``.
    ``step(local)`` maps this rank's ``[B/P, C, T]`` files
    (:func:`gabor_input_sharding`) to ``(correlograms [nT, B/P, C, T],
    picks, thresholds [B/P])``: the picks an ``ops.peaks.SparsePicks``
    over ``[nT, B/P, C]``, the thresholds each file's ``0.5 · max`` (the
    HF note picked at ``hf_factor`` of it). No collective."""
    meta = as_metadata(metadata)
    if design is None:
        design = design_gabor(meta, list(selected_channels), c0=c0)
    dev = mesh.device
    names, notes_dev, factors = _notes_and_factors(notes, note_arrays, meta.fs, hf_factor, dev)
    kernels = tuple(torch.as_tensor(np.ascontiguousarray(k), dtype=torch.float32, device=dev)
                    for k in (design.gabor_up, design.gabor_down))

    def one_file(trf):                                   # [C, T]
        _, _, masked = gabor_mask(trf, design, kernels=kernels)
        corr = torch.stack([masked_matched_filter(masked, nt) for nt in notes_dev])
        del masked
        thres = relative_threshold * corr.amax()
        return corr, _picks(corr, thres * factors, max_peaks), thres

    def step(x):
        x = torch.as_tensor(x).to(dev, torch.float32)
        if x.ndim != 3:
            raise ValueError(f"local batch {tuple(x.shape)} is not [B, C, T]")
        outs = [one_file(x[b]) for b in range(x.shape[0])]
        corr = torch.stack([o[0] for o in outs], dim=1)            # [nT, B/P, C, T]
        picks = peak_ops.SparsePicks(*(torch.stack([getattr(o[1], f) for o in outs], dim=1)
                                       for f in peak_ops.SparsePicks._fields))
        return corr, picks, torch.stack([o[2] for o in outs])

    step.mesh = mesh
    return step, names


def make_sharded_gabor_step_time(
    metadata,
    selected_channels,
    mesh: Mesh,
    c0: float = C0_WATER,
    bin_factor: float = 0.1,
    threshold1: float = 9100.0,
    threshold2: float = 150.0,
    ksize: int = 100,
    notes: Dict[str, Tuple[float, float, float]] | None = None,
    max_peaks: int = 256,
    relative_threshold: float = 0.5,
    hf_factor: float = 0.9,
    channel_halo: int | None = None,
    time_axis: str = "time",
    n_channels: int | None = None,
    outputs: str = "full",
    *,
    design=None,
    note_arrays: Dict[str, np.ndarray] | None = None,
):
    """The Gabor step for a ``[channel x time]`` record whose TIME axis is
    split over ``time_axis``: returns ``(step, names)``; ``step(local)``
    takes this rank's ``[C, T/P]`` slice.

    One ``all_to_all`` makes time whole on each channel shard (the
    per-channel Hilbert envelope needs it); the image's min-max scaling and
    the smoothed mask's renormalisation take ``pmin``/``pmax`` pairs; the
    Gabor correlations see a channel-row ``halo_exchange`` of
    ``channel_halo`` rows; the threshold is one more ``pmax``. Interior
    channels match the one-device ``GaborDetector`` to resize-antialias
    rounding; the outermost ``channel_halo`` rows at the two cable ends
    differ (the antialiased binning renormalises at a true image edge but
    sees zero halo rows here), as in JAX.

    ``channel_halo`` defaults to ``(2 (ksize // 2) + 4) / bin_factor``
    rows rounded up to the binning grain. ``n_channels`` is the block's
    row count (default: ``selected_channels`` applied to
    ``metadata.nx``); ``C / P`` and ``channel_halo`` must bin to whole
    pixels. ``outputs="full"``: ``(correlograms [nT, C/P, T] (channels
    split over ``time_axis`` after the relabel), picks, threshold [])``;
    ``"picks"``: ``(picks, threshold)``."""
    meta = as_metadata(metadata)
    if design is None:
        design = design_gabor(meta, list(selected_channels), c0=c0, bin_factor=bin_factor,
                              threshold1=threshold1, threshold2=threshold2, ksize=ksize)
    bin_factor = design.bin_factor
    dev = mesh.device
    names, notes_dev, factors = _notes_and_factors(notes, note_arrays, meta.fs, hf_factor, dev)
    grain = max(int(round(1.0 / bin_factor)), 1)
    if channel_halo is None:
        need = (2 * (ksize // 2) + 4) / bin_factor
        channel_halo = int(-(-need // grain) * grain)
    if channel_halo % grain:
        raise ValueError(
            f"channel_halo {channel_halo} must be a multiple of the binning "
            f"granularity {grain}"
        )
    if outputs not in ("full", "picks"):
        raise ValueError(f"outputs must be 'full' or 'picks', got {outputs!r}")
    if n_channels is None:
        n_channels = ChannelSelection.from_list(list(selected_channels)).n_channels(meta.nx)
    C = n_channels
    p_mesh = mesh.axis_size(time_axis)
    if C % p_mesh:
        raise ValueError(f"channels {C} not divisible by mesh axis {time_axis}={p_mesh}")
    local_c = C // p_mesh
    if not (0 < channel_halo < local_c):
        raise ValueError(f"channel_halo {channel_halo} must be in (0, C/P={local_c})")
    # the per-shard resize scale equals the whole image's only where the
    # local channel count and the halo both bin to whole pixels
    for label, n in (("C/P", local_c), ("channel_halo", channel_halo)):
        if abs(n * bin_factor - round(n * bin_factor)) > 1e-9:
            raise ValueError(
                f"{label}={n} times bin_factor={bin_factor} is not an "
                f"integer: the per-shard binned grid would misalign with "
                f"the single-chip grid"
            )
    up, down = (torch.as_tensor(np.ascontiguousarray(k), dtype=torch.float32, device=dev)
                for k in (design.gabor_up, design.gabor_down))
    t1, t2 = design.threshold1, design.threshold2

    def step(x):
        x = torch.as_tensor(x).to(dev, torch.float32)
        if x.ndim != 2 or x.shape[0] != C:
            raise ValueError(f"local record {tuple(x.shape)} is not [{C}, T/P]")
        # relabel: time gathered whole, channels scattered -> [C/P, T]
        xr = coll.all_to_all(x, mesh, time_axis, split_axis=0, concat_axis=1)
        del x
        # the t-x image with the GLOBAL min-max scaling (trace2image's)
        img = torch.abs(spectral.analytic_signal(xr, dim=-1))
        img = img / xr.std(dim=-1, keepdim=True, correction=0)
        lo = coll.pmin(img.amin(), mesh, time_axis)
        hi = coll.pmax(img.amax(), mesh, time_axis)
        image = (img - lo) / (hi - lo) * 255.0
        del img
        # channel-row halo: zero rows at the global edges, the zero padding
        # the one-device filters see
        ext = halo_exchange(image.T.contiguous(), channel_halo, time_axis, mesh=mesh).T
        del image
        imagebin = img_ops.binning(ext, bin_factor, bin_factor)
        score = img_ops.filter2d_same(imagebin, up) + img_ops.filter2d_same(imagebin, down)
        del imagebin
        binary = (score > t1).to(ext.dtype)
        del score
        mask_binned = (img_ops.filter2d_same(binary, up)
                       + img_ops.filter2d_same(binary, down)) > t2
        del binary
        mask_full = img_ops.resize_linear(mask_binned.to(ext.dtype), tuple(ext.shape),
                                          antialias=False)
        shape_ext = tuple(ext.shape)
        del ext, mask_binned
        smoothed = img_ops.gaussian_filter2d(mask_full, 1.5)
        del mask_full
        smoothed = smoothed[channel_halo:shape_ext[0] - channel_halo]
        slo = coll.pmin(smoothed.amin(), mesh, time_axis)
        shi = coll.pmax(smoothed.amax(), mesh, time_axis)
        span = shi - slo
        smoothed = torch.where(span > 0, (smoothed - slo) / torch.where(span > 0, span, 1.0),
                               smoothed)
        masked = xr * smoothed
        del xr, smoothed
        corr = torch.stack([masked_matched_filter(masked, nt) for nt in notes_dev])
        del masked                                       # [nT, C/P, T]
        thres = relative_threshold * coll.pmax(corr.amax(), mesh, time_axis)
        picks = _picks(corr, thres * factors, max_peaks)
        if outputs == "picks":
            return picks, thres
        return corr, picks, thres

    step.mesh = mesh
    return step, names
