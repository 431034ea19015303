"""Processing with the TIME axis split over a mesh (the port of
``das4whales_tpu.parallel.timeshard``).

A continuous multi-minute record lives ``[channel x time]`` with time
split over the mesh's ``time`` axis, each rank holding ``[C, T/P]``:

* zero-phase filtering is exact across shard boundaries: each rank
  receives ``halo`` real samples from each neighbour (:func:`ppermute`
  halo exchange) before it filters, so the only error is the filter's
  own response truncated at ``halo`` samples. The first and last rank
  odd-extend instead, as the one-device ``filtfilt`` does; every rank
  takes part in both exchanges and selects afterwards, since a
  collective inside a branch only some ranks take deadlocks;
* the f-k transform is a pencil decomposition with two ``all_to_all``\\ s:
  the channel FFT is local, one transpose makes time local for the time
  FFT and the mask, one transpose back;
* the detection step transposes once more into the channel-split layout
  (a row then holds the whole record) and correlates, thresholds (one
  ``pmax``) and picks there. Its sparse picks go through the pick kernel
  in ``pick_tile`` row tiles (``models.matched_filter.mf_pick_tiled``, as
  ``parallel.pipeline`` does): the Hilbert analytic signal, then
  ``ops.fused_picks`` (the kernel on a card, its plain version on the
  CPU). A row of the record too long for one CTA's shared memory (about
  52800 samples on an H100 at K = 512, ``topk``) takes the kernel's
  long-row form, its envelope in device memory (:func:`pick_route`, asked
  by shape; ``step.route`` names the form).

Every rank calls these with its local block (``parallel.mesh``).
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import scipy.signal as sp
import torch

from ..models.matched_filter import mf_pick_tiled
from ..ops import conditioning as cond_ops
from ..ops import fused_picks
from ..ops import mxu as mxu_ops
from ..ops import peaks as peak_ops
from ..ops import spectral, xcorr
from ..ops.filters import butter_zero_phase_gain_full, zero_phase_gain
from ..ops.fk import symmetrize_mask_fftorder
from . import collectives as coll
from .mesh import Mesh, Sharding, make_mesh


def halo_exchange(x: torch.Tensor, halo: int, axis_name: str, *, mesh: Mesh) -> torch.Tensor:
    """Pad the local time axis with ``halo`` samples from each neighbour
    (zeros at the global edges): ``[..., L]`` -> ``[..., halo + L +
    halo]``. Two neighbour exchanges (:func:`collectives.ppermute`)."""
    p = mesh.axis_size(axis_name)
    if p == 1:
        z = torch.zeros(x.shape[:-1] + (halo,), dtype=x.dtype, device=x.device)
        return torch.cat([z, x, z], dim=-1)
    from_left = coll.ppermute(x[..., -halo:].contiguous(), mesh, axis_name,
                              [(i, i + 1) for i in range(p - 1)])
    from_right = coll.ppermute(x[..., :halo].contiguous(), mesh, axis_name,
                               [(i + 1, i) for i in range(p - 1)])
    return torch.cat([from_left, x, from_right], dim=-1)


def _halo_with_edge_oddext(x: torch.Tensor, halo: int, axis_name: str, *,
                           mesh: Mesh) -> torch.Tensor:
    """Halo exchange whose global-edge ranks odd-extend instead of
    zero-padding (the one-device ``filtfilt`` edges, ``ops.filters``)."""
    ext = halo_exchange(x, halo, axis_name, mesh=mesh)
    idx = mesh.axis_index(axis_name)
    p = mesh.axis_size(axis_name)
    left, right = ext[..., :halo], ext[..., -halo:]
    if idx == 0:
        left = (2.0 * x[..., :1] - torch.flip(x[..., 1:halo + 1], dims=(-1,))).to(x.dtype)
    if idx == p - 1:
        right = (2.0 * x[..., -1:] - torch.flip(x[..., -halo - 1:-1], dims=(-1,))).to(x.dtype)
    return torch.cat([left, ext[..., halo:-halo], right], dim=-1)


def _bp_time_local(x: torch.Tensor, gain: torch.Tensor, *, halo: int, axis_name: str,
                   mesh: Mesh) -> torch.Tensor:
    """Zero-phase bandpass along a time-split axis, exact across shard
    boundaries to the filter's decay at ``halo`` samples."""
    ext = _halo_with_edge_oddext(x, halo, axis_name, mesh=mesh)
    spec = torch.fft.rfft(ext, dim=-1)
    y = torch.fft.irfft(spec * gain.to(spec.real.dtype), n=ext.shape[-1], dim=-1)
    return y[..., halo:-halo].to(x.dtype)


@functools.lru_cache(maxsize=32)
def _bp_time_gain(order: int, fs: float, fmin: float, fmax: float, local: int,
                  halo: int) -> np.ndarray:
    """The zero-phase gain over ``rfftfreq(local + 2*halo)``, cached per
    filter design and shard geometry (host float32)."""
    sos = sp.butter(order, [fmin / (fs / 2), fmax / (fs / 2)], "bp", output="sos")
    return zero_phase_gain(np.fft.rfftfreq(local + 2 * halo), sos).astype(np.float32)


def sharded_bp_filt_time(trace: torch.Tensor, mesh: Mesh, fs: float, fmin: float,
                         fmax: float, *, order: int = 8, halo: int = 512,
                         time_axis: str = "time") -> torch.Tensor:
    """Zero-phase Butterworth bandpass of this rank's time slice ``[C,
    T/P]`` of a record split over ``time_axis``; boundary-exact through
    the halo exchange."""
    local = trace.shape[-1]
    if halo >= local:
        raise ValueError(f"halo {halo} must be < local shard length {local}")
    gain = torch.from_numpy(_bp_time_gain(order, float(fs), float(fmin), float(fmax),
                                          local, halo)).to(trace.device)
    return _bp_time_local(trace, gain, halo=halo, axis_name=time_axis, mesh=mesh)


def prepare_mask_full(mask: np.ndarray) -> np.ndarray:
    """fftshifted ``[k x f]`` design mask -> symmetrized full mask in fft
    order on both axes (float32)."""
    return symmetrize_mask_fftorder(mask).astype(np.float32)


def _mask_rows(mask, mesh: Mesh, time_axis: str, device, gain=None) -> torch.Tensor:
    """This rank's rows ``[C/P, T]`` of :func:`prepare_mask_full`'s mask
    (times ``gain [1, T]`` first, where given), made on ``device`` in the
    mask's own dtype with the host's arithmetic, so bitwise the host's: a
    record's mask is gigabytes, which numpy takes seconds over. Row ``i``
    of the symmetrised mask needs rows ``i`` and ``-i`` of the unshifted
    one, so only those ``2 C/P`` rows of the design reach the device."""
    mask = np.asarray(mask)
    C = mask.shape[0]
    n = C // mesh.axis_size(time_axis)
    i = mesh.axis_index(time_axis) * n + np.arange(n)

    def unshifted(rows):
        # ifftshift on the channel axis: row r of the result is row
        # (r + C // 2) % C of the design; then along time on the device
        m = torch.from_numpy(mask[(rows + C // 2) % C]).to(device)
        if gain is not None:
            m = m * torch.as_tensor(np.asarray(gain).astype(mask.dtype)).to(device)
        return torch.fft.ifftshift(m, dim=1)

    mu = unshifted(i)
    reflected = torch.roll(torch.flip(unshifted((-i) % C), (1,)), 1, dims=1)  # [-i, -j]
    return (0.5 * (mu + reflected)).to(torch.float32).contiguous()


def fk_apply_time_local(x: torch.Tensor, mask_rows: torch.Tensor, axis_name: str, *,
                        mesh: Mesh) -> torch.Tensor:
    """f-k filter a time-split ``[C, T/P]`` block against this rank's rows
    ``[C/P, T]`` of the full mask (fft order on both axes)."""
    s = torch.fft.fft(x, dim=0)                                   # channel FFT: local
    s = coll.all_to_all(s, mesh, axis_name, split_axis=0, concat_axis=1)   # [C/P, T]
    s = torch.fft.fft(s, dim=1)
    s = s * mask_rows.to(s.real.dtype)
    s = torch.fft.ifft(s, dim=1)
    s = coll.all_to_all(s, mesh, axis_name, split_axis=1, concat_axis=0)   # [C, T/P]
    return torch.fft.ifft(s, dim=0).real.to(x.dtype)


def sharded_fk_apply_time(trace: torch.Tensor, mask, mesh: Mesh,
                          time_axis: str = "time") -> torch.Tensor:
    """f-k filter this rank's time slice ``[C, T/P]``; ``mask`` is the
    GLOBAL fftshifted ``[C, T]`` design. Equals the one-device
    ``ops.fk.fk_filter_apply`` up to the FFT's rounding."""
    nnx, local = trace.shape
    p = mesh.axis_size(time_axis)
    mask = np.asarray(mask)
    if nnx % p or mask.shape != (nnx, local * p):
        raise ValueError(f"mask {mask.shape} / block {tuple(trace.shape)} must divide "
                         f"the mesh axis size {p}")
    rows = _mask_rows(mask, mesh, time_axis, trace.device)
    return fk_apply_time_local(trace, rows, time_axis, mesh=mesh)


def pick_route(n_samples: int, max_peaks: int, method: str, device) -> str:
    """The pick kernel's form for the time-split step's rows of
    ``n_samples`` (the whole record) on ``device``: ``"fused_picks"``
    where one CTA's shared memory takes the row (``ops.fused_picks.fits``:
    always off a card, where the plain version runs), else
    ``"fused_picks_long"``, the long-row form. Decided by shape."""
    return ("fused_picks" if fused_picks.fits(n_samples, max_peaks, method, device)
            else "fused_picks_long")


def make_sharded_mf_step_time(
    design,
    mesh: Mesh,
    *,
    time_axis: str = "time",
    halo: int = 512,
    relative_threshold: float = 0.5,
    hf_factor: float | None = None,
    threshold_factors=None,
    threshold_scope: str | None = None,
    pick_mode: str = "sparse",
    max_peaks: int = 256,
    outputs: str = "full",
    fused_bandpass: bool = True,
    pick_tile: int = 512,
    pick_method: str = "topk",
    wire: str = "conditioned",
    scale_factor: float | None = None,
    cond_time_samples: int | None = None,
    cond_segments=None,
    cond_means=None,
    mf_engine: str = "fft",
):
    """The flagship detection step for a record whose TIME axis is split
    over ``time_axis``: every rank calls ``step(local)`` with its ``[C,
    T/P]`` slice and gets its local outputs.

    Stages: conditioning (``wire="raw"``: a ``psum`` demean,
    ``ops.conditioning.condition_time_sharded``, over ``cond_time_samples``
    real samples; or with ``cond_segments``/``cond_means`` the exact
    per-file host means, ``condition_segmented``) -> the halo-exchange
    bandpass (or, ``fused_bandpass=True``, ``|H(f)|²`` folded into the
    mask) -> the two-collective pencil f-k filter -> one ``all_to_all``
    into the channel-split layout ``[C/P, T]`` -> correlograms on
    ``mf_engine`` (``ops.mxu.correlograms_body``), one ``pmax`` for the
    threshold, the sparse picks through the pick kernel in ``pick_tile``
    row tiles (its long-row form where the record's rows do not fit one
    CTA's shared memory: :func:`pick_route`; ``step.route`` names it).

    ``outputs="full"``: ``(trf_fk [C, T/P] time-split, corr, env [nT, C/P,
    T] channel-split, picks, thres)``; ``"picks"``: ``(picks, thres)``.
    Sparse picks are ``[nT, C/P, K]`` with global time positions; the
    threshold base is a scalar (global scope) or ``[nT]``
    (``per_template``), the same on every rank. Interior samples match
    the one-device pipeline to float32 roundoff; the record's first and
    last ``halo`` samples take the halo-length odd extension on the staged
    route."""
    if pick_mode not in ("sparse", "dense"):
        raise ValueError(f"pick_mode must be 'sparse' or 'dense', got {pick_mode!r}")
    if outputs not in ("full", "picks"):
        raise ValueError(f"outputs must be 'full' or 'picks', got {outputs!r}")
    if wire not in ("conditioned", "raw"):
        raise ValueError(f"unknown wire {wire!r}; expected 'conditioned' or 'raw'")
    if wire == "raw" and scale_factor is None:
        raise ValueError("wire='raw' needs scale_factor (metadata.scale_factor)")
    nnx, nns = design.trace_shape
    if design.fk_channels != nnx:
        raise ValueError(
            "channel-padded designs (design_matched_filter(channel_pad=...)) "
            "are single-device only; design without padding for the sharded step"
        )
    p = mesh.axis_size(time_axis)
    if nnx % p or nns % p:
        raise ValueError(f"trace shape {design.trace_shape} must divide mesh axis {p}")
    local = nns // p
    dev = mesh.device
    band, order, fs = design.bp_band, design.bp_order, design.fs
    gain = None
    if not fused_bandpass:
        if halo >= local:
            raise ValueError(f"halo {halo} must be < local shard length {local}")
        # the design's bandpass at the shard window's length
        gain = torch.from_numpy(_bp_time_gain(order, float(fs), float(band[0]),
                                              float(band[1]), local, halo)).to(dev)
    mask_rows = _mask_rows(design.fk_mask, mesh, time_axis, dev,
                           butter_zero_phase_gain_full(nns, fs, band, order)[None, :]
                           if fused_bandpass else None)
    templates_true, template_mu, template_scale = xcorr.padded_template_stats_device(
        design.templates, dev)
    factors_np, thr_scope = design.resolve_threshold_policy(
        hf_factor, threshold_factors, threshold_scope)
    factors = torch.as_tensor(factors_np, device=dev)
    route = pick_route(nns, max_peaks, pick_method, dev) if pick_mode == "sparse" else "dense"

    condition = wire == "raw"
    cond_scale = 0.0 if scale_factor is None else scale_factor
    cond_n = int(cond_time_samples or nns)
    segmented = cond_segments is not None or cond_means is not None
    seg = None
    if segmented:
        if not condition:
            raise ValueError("cond_segments/cond_means apply to wire='raw' only")
        if cond_segments is None or cond_means is None:
            raise ValueError("cond_segments and cond_means go together")
        seg_lens = [int(n) for n in cond_segments]
        n_real = sum(seg_lens)
        if min(seg_lens, default=0) < 1 or not n_real <= nns:
            raise ValueError(f"cond_segments {seg_lens} must be positive and sum to at "
                             f"most the record length {nns}")
        means = np.asarray(cond_means, np.float32)
        if means.shape != (nnx, len(seg_lens)):
            raise ValueError(f"cond_means shape {means.shape} != "
                             f"{(nnx, len(seg_lens))} ([channel x n_segments])")
        # sample -> file column; the divisibility pad maps to a trailing
        # all-zero column and conditions to exactly 0
        seg_ids = np.full(nns, len(seg_lens), np.int64)
        seg_ids[:n_real] = np.repeat(np.arange(len(seg_lens)), seg_lens)
        i = mesh.axis_index(time_axis)
        seg = (torch.from_numpy(seg_ids[i * local:(i + 1) * local]).to(dev),
               torch.from_numpy(np.concatenate([means, np.zeros((nnx, 1), np.float32)],
                                               axis=1)).to(dev))

    def step(trace):
        x = torch.as_tensor(trace).to(dev)
        if tuple(x.shape) != (nnx, local):
            raise ValueError(f"local record {tuple(x.shape)} is not [{nnx}, {local}] (this "
                             f"rank's time slice of {design.trace_shape})")
        if condition and segmented:
            x = cond_ops.condition_segmented(x, cond_scale, seg[0], seg[1],
                                             dtype=templates_true.dtype)
        elif condition:
            x = cond_ops.condition_time_sharded(x, cond_scale, time_axis, cond_n, mesh=mesh,
                                                dtype=templates_true.dtype)
        if not fused_bandpass:
            x = _bp_time_local(x, gain, halo=halo, axis_name=time_axis, mesh=mesh)
        trf = fk_apply_time_local(x, mask_rows, time_axis, mesh=mesh)   # [C, T/P]
        del x
        # relabel: one transpose into the channel-split layout [C/P, T]
        y = coll.all_to_all(trf, mesh, time_axis, split_axis=0, concat_axis=1)
        if outputs == "picks":
            del trf
        corr = mxu_ops.correlograms_body(y, templates_true, template_mu, template_scale,
                                         mf_engine)
        del y
        if thr_scope == "per_template":
            thres = relative_threshold * coll.pmax(corr.amax(dim=(1, 2)), mesh, time_axis)
            thr = (thres * factors)[:, None, None]
        else:
            thres = relative_threshold * coll.pmax(corr.amax(), mesh, time_axis)
            thr = thres * factors[:, None, None]
        env = (spectral.envelope_sqrt(corr, dim=-1)
               if outputs == "full" or route == "dense" else None)
        if route != "dense":
            picks = mf_pick_tiled(list(corr.split(pick_tile, dim=-2)), thr.reshape(-1),
                                  max_peaks, pick_method, release=True)
        else:
            picks = peak_ops.local_maxima(env) & (peak_ops.peak_prominences_dense(env) >= thr)
        if outputs == "picks":
            del corr
        if outputs == "picks":
            return picks, thres
        return trf, corr, env, picks, thres

    step.mesh = mesh
    step.route = route
    return step


def time_sharding(mesh: Mesh, time_axis: str = "time") -> Sharding:
    """The layout of a ``[channel x time]`` block with time split."""
    return Sharding(mesh, (None, time_axis))


# ---------------------------------------------------------------------------
# The resource ladder's time-sharded rung (workflows.planner)
# ---------------------------------------------------------------------------


def viable_time_mesh_size(trace_shape, n_devices: int) -> int | None:
    """The largest mesh size ``p >= 2`` that can serve ``trace_shape``
    time-split (the pencil f-k transform needs BOTH axes divisible by
    ``p``), or None: never in a world of one."""
    C, T = trace_shape
    for p in range(min(int(n_devices), C, T), 1, -1):
        if C % p == 0 and T % p == 0:
            return p
    return None


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def ladder_time_mesh(trace_shape, device=None) -> Mesh | None:
    """The ladder's time-split rung mesh for ``trace_shape``: every rank
    of the world on one ``time`` axis, each on ``device`` (None: its card),
    or None when that size does not divide the shape (the rung needs every
    rank in lockstep, so it never takes a subset). Built once a world and
    device (collective: every rank reaches the rung together)."""
    n = _world_size()
    if viable_time_mesh_size(tuple(trace_shape)[-2:], n) != n:
        return None
    key = (n, None if device is None else str(device))
    if key not in _LADDER_MESHES:
        devices = None if device is None else [str(device)] * n
        _LADDER_MESHES[key] = make_mesh(shape=(n,), axis_names=("time",), devices=devices)
    return _LADDER_MESHES[key]


#: (world size, device) -> the ladder's time mesh
_LADDER_MESHES: dict = {}


def sparse_time_picks_to_dict(sp_picks, template_names, n_samples=None,
                              row_offset: int = 0):
    """A time-split step's ``SparsePicks`` (``[nT, C, K]`` global time
    positions; ``row_offset`` the first channel of this rank's rows) ->
    the campaign picks dict ``{name: (2, n) [channel, time]}``, row-major.
    ``n_samples`` drops positions at or past the real record length."""
    pos = sp_picks.positions.cpu().numpy() if isinstance(sp_picks.positions, torch.Tensor) \
        else np.asarray(sp_picks.positions)
    sel = (sp_picks.selected.cpu().numpy() if isinstance(sp_picks.selected, torch.Tensor)
           else np.asarray(sp_picks.selected)).astype(bool)
    out = {}
    for i, name in enumerate(template_names):
        mask = sel[i]
        if n_samples is not None:
            mask = mask & (pos[i] < int(n_samples))
        ch, slot = np.nonzero(mask)
        t = pos[i][ch, slot]
        order = np.lexsort((t, ch))
        out[name] = np.asarray([ch[order] + row_offset, t[order]], dtype=np.int64)
    return out


def detect_picks_time_sharded(det, trace, mesh: Mesh, n_real=None):
    """One file's picks through the time-split step — the resource
    ladder's multi-device rung: each rank's working set shrinks about
    1/P. Every rank of ``mesh`` calls it with the same host ``[C, T]``
    block (stored-dtype counts on the raw wire) and takes its time slice;
    the picks of every rank's channel rows are gathered, so every rank
    returns the same ``(picks, thresholds)`` in the campaign dict
    convention. The first/last ``halo`` samples differ from the one-device
    routes' edge handling, so the rung's picks are detection-equivalent,
    not bitwise."""
    nr_key = int(n_real) if (n_real is not None and det.wire == "raw") else None
    key = (id(mesh), nr_key)
    step = _LADDER_STEPS.setdefault(det, {}).get(key)
    if step is None:
        wire_kw = ({"wire": "raw", "scale_factor": det.metadata.scale_factor,
                    "cond_time_samples": None if n_real is None else int(n_real)}
                   if det.wire == "raw" else {})
        step = make_sharded_mf_step_time(
            det.design, mesh, outputs="picks", pick_mode="sparse",
            max_peaks=det.max_peaks, fused_bandpass=det.fused_bandpass,
            mf_engine=getattr(det, "mf_engine", "fft"), **wire_kw)
        _LADDER_STEPS[det][key] = step
    x = time_sharding(mesh).place(np.asarray(trace))
    sp_picks, thres = step(x)
    C = det.design.trace_shape[0]
    rows = C // mesh.axis_size("time")
    local = sparse_time_picks_to_dict(sp_picks, det.design.template_names, n_samples=n_real,
                                      row_offset=mesh.axis_index("time") * rows)
    parts = coll.all_gather_object(local, mesh)
    picks = {name: np.concatenate([pt[name] for pt in parts], axis=1)
             for name in det.design.template_names}
    factors = np.asarray(det.design.threshold_factors, np.float32)
    base = np.broadcast_to(thres.detach().cpu().numpy().astype(np.float32), factors.shape)
    thresholds = {name: float(base[i]) * float(factors[i])
                  for i, name in enumerate(det.design.template_names)}
    return picks, thresholds


#: detector -> {(mesh id, n_real): the ladder's time-split step}; weak-keyed
#: by the detector, so steps die with the campaign's bucket detectors
_LADDER_STEPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
