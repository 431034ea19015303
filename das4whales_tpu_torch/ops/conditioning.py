"""On-device conditioning of raw interrogator counts (the narrow wire).

On ``wire="raw"`` the stored-dtype counts cross to the device untouched
and the host readers' affine map — ``(x.float() - mean(x, time)) *
scale_factor`` — runs on the device as the detection program's first
pass. The port's copy of ``das4whales_tpu.ops.conditioning``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import to_device_async


def condition(trace: torch.Tensor, scale, *, dtype=torch.float32) -> torch.Tensor:
    """Raw counts -> strain: cast to ``dtype``, demean each channel along
    time, multiply by the interrogator scale factor (rounded to
    ``dtype`` first, as the JAX package's ``jnp.asarray(scale, dtype)``)."""
    x = trace.to(dtype)
    x = x - x.mean(dim=-1, keepdim=True)
    return x * _scalar(scale, dtype)


def condition_padded(trace: torch.Tensor, scale, n_real, *,
                     dtype=torch.float32) -> torch.Tensor:
    """:func:`condition` for a time-padded record whose real samples are
    ``[..., :n_real]`` and whose tail is zero padding: the mean spans the
    real samples only and the pad conditions to exactly 0. ``n_real`` is
    a scalar (a Python or numpy integer, or a 0-d array), or one length
    per record of a ``[B, C, T]`` stack."""
    x = trace.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    if np.ndim(n_real) == 0:
        n_real = int(n_real)
        valid = torch.arange(x.shape[-1], device=x.device) < n_real
        count = _scalar(n_real, dtype)
    else:
        nr = to_device_async(n_real, torch.int64, x.device).reshape(-1, 1, 1)
        valid = torch.arange(x.shape[-1], device=x.device) < nr
        count = nr.to(dtype)
    s = torch.where(valid, x, zero).sum(dim=-1, keepdim=True)
    x = torch.where(valid, x - s / count, zero)
    return x * _scalar(scale, dtype)


def condition_time_sharded(trace: torch.Tensor, scale, axis_name: str,
                           n_time_global: int, *, mesh, demean: bool = True,
                           dtype=torch.float32) -> torch.Tensor:
    """:func:`condition` for a block whose TIME axis is split over
    ``axis_name`` of ``mesh`` (``parallel.timeshard``): the per-channel
    mean spans the shards, so it is a ``psum`` of local sums divided by
    the GLOBAL time length (one scalar a channel crosses the mesh; the
    order of the sum differs from the one-device mean by roundoff). A
    record padded past ``n_time_global`` samples (divisibility zeros)
    has its pad masked back to exactly 0 after the demean, as the
    conditioned wire pads after conditioning."""
    from ..parallel import collectives

    x = trace.to(dtype)
    if demean:
        m = collectives.psum(x.sum(dim=-1, keepdim=True), mesh, axis_name)
        x = x - m / n_time_global
        local = x.shape[-1]
        pos = mesh.axis_index(axis_name) * local + torch.arange(local, device=x.device)
        x = torch.where(pos < n_time_global, x, torch.zeros((), dtype=dtype, device=x.device))
    return x * _scalar(scale, dtype)


def condition_segmented(trace: torch.Tensor, scale, seg_ids, seg_means, *,
                        dtype=torch.float32) -> torch.Tensor:
    """:func:`condition` for a record joined from several files (the long
    record): each file is demeaned by its own mean, as the conditioned
    wire demeans each file before the join. ``seg_ids [T]`` maps each time
    sample to its file's column of ``seg_means [C, n_segments]`` (float32
    means computed on the host with the conditioned readers' numpy
    reduction, so the result is bitwise the host route's). Divisibility
    padding maps to a trailing all-zero column and conditions to exactly
    0. Numpy operands cross to ``trace``'s device."""
    x = trace.to(dtype)
    ids = torch.as_tensor(seg_ids, device=x.device).long()
    means = torch.as_tensor(seg_means, device=x.device).to(dtype)
    return (x - means[:, ids]) * _scalar(scale, dtype)


def _scalar(v, dtype) -> float:
    """``v`` rounded to ``dtype`` and handed to torch as a Python scalar
    (torch computes a float32 op with a Python scalar in float32)."""
    return float(np.asarray(v, dtype=str(dtype).replace("torch.", "")))
