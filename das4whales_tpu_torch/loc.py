"""TDOA source localization: Gauss-Newton least squares in float64.

The port of ``das4whales_tpu.loc`` (the reference's localization layer):
from per-channel call arrival times and the cable geometry, iteratively
solve for the source ``[x, y, z, t0]``, then quantify the uncertainty
from the residual variance and the covariance of the linearised problem.

- Everything runs in float64. At 40 km positions with ``1/c0²`` columns,
  the float32 normal equations lose the solve.
- Batches are explicit leading axes: ``Ti [..., nch]`` and guesses
  ``[..., 4]`` solve together, each step one batched ``torch.linalg.solve``
  of the ``[..., 4, 4]`` normal equations — no per-event Python loop.
- ``fix_z`` zeroes the design matrix's z column and pins the update, so
  shapes stay the same in both modes.
- Channels whose arrival time is not finite (no pick) are zero-weighted.

Entry points take ``device=`` (default: the card, ``utils.device.
resolve_device``). Numpy inputs go to that device; tensor inputs stay on
their own. Geometry conventions are the reference's: cable positions
``[channel, 3]`` (x, y, z in metres, z negative below the sea surface),
a constant sound speed ``c0`` in m/s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .utils.device import resolve_device

#: Tikhonov regularisation weight of the normal equations.
LAMBDA_REG = 1e-5

#: The reference solver's initial guess; t0 is min(Ti) at call time.
DEFAULT_GUESS_XYZ = (40000.0, 23000.0, -60.0)

_F64 = torch.float64


def _device_of(args, device) -> torch.device:
    """The device of the first tensor among ``args``, else ``device``
    resolved (``None``: the card)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(device)


def _f64(a, dev: torch.device) -> torch.Tensor:
    """``a`` as a float64 tensor: a tensor keeps its device, anything else
    goes to ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(_F64)
    return torch.tensor(np.array(a, dtype=np.float64), device=dev)


def calc_arrival_times(t0, cable_pos, pos, c0, *, device=None) -> torch.Tensor:
    """Theoretical arrival time at every channel for a source at ``pos
    [..., >=3]`` emitting at ``t0`` (straight rays, constant ``c0``)."""
    dev = _device_of((t0, cable_pos, pos), device)
    cable_pos, pos, t0 = _f64(cable_pos, dev), _f64(pos, dev), _f64(t0, dev)
    dist = torch.sqrt(torch.sum((cable_pos - pos[..., None, :3]) ** 2, dim=-1))
    return t0[..., None] + dist / c0


def calc_distance_matrix(cable_pos, whale_pos, *, device=None) -> torch.Tensor:
    """3-D channel-to-source distances."""
    dev = _device_of((cable_pos, whale_pos), device)
    cable_pos, whale_pos = _f64(cable_pos, dev), _f64(whale_pos, dev)
    return torch.sqrt(torch.sum((cable_pos - whale_pos[..., None, :3]) ** 2, dim=-1))


def calc_radii_matrix(cable_pos, whale_pos, *, device=None) -> torch.Tensor:
    """Horizontal (x, y) channel-to-source ranges."""
    dev = _device_of((cable_pos, whale_pos), device)
    cable_pos, whale_pos = _f64(cable_pos, dev), _f64(whale_pos, dev)
    return torch.sqrt(torch.sum((cable_pos[:, :2] - whale_pos[..., None, :2]) ** 2, dim=-1))


def calc_theta_vector(cable_pos, whale_pos, *, device=None) -> torch.Tensor:
    """Per-channel elevation angle to the source."""
    dev = _device_of((cable_pos, whale_pos), device)
    cable_pos, whale_pos = _f64(cable_pos, dev), _f64(whale_pos, dev)
    rj = calc_radii_matrix(cable_pos, whale_pos)
    return torch.atan2(torch.abs(whale_pos[..., None, 2] - cable_pos[:, 2]), rj)


def calc_phi_vector(cable_pos, whale_pos, *, device=None) -> torch.Tensor:
    """Per-channel azimuth angle to the source."""
    dev = _device_of((cable_pos, whale_pos), device)
    cable_pos, whale_pos = _f64(cable_pos, dev), _f64(whale_pos, dev)
    return torch.atan2(whale_pos[..., None, 1] - cable_pos[:, 1],
                       whale_pos[..., None, 0] - cable_pos[:, 0])


def _design_matrix(cable_pos: torch.Tensor, n: torch.Tensor, c0, fix_z: bool) -> torch.Tensor:
    """Direction-cosine design matrix ``G [..., nch, 4]`` of the
    linearised TDOA problem: d(arrival)/d(x, y, z, t0) at the estimate
    ``n [..., 4]``; with ``fix_z`` the z column is zero."""
    thj = calc_theta_vector(cable_pos, n)
    phij = calc_phi_vector(cable_pos, n)
    gz = torch.zeros_like(thj) if fix_z else torch.sin(thj) / c0
    return torch.stack([torch.cos(thj) * torch.cos(phij) / c0,
                        torch.cos(thj) * torch.sin(phij) / c0,
                        gz, torch.ones_like(thj)], dim=-1)


def _default_guess(Ti: torch.Tensor) -> torch.Tensor:
    """The reference's start ``[40000, 23000, -60, min finite Ti]``, one a
    batch entry."""
    inf = torch.full_like(Ti, float("inf"))
    t_min = torch.where(torch.isfinite(Ti), Ti, inf).amin(dim=-1)
    xyz = torch.tensor(DEFAULT_GUESS_XYZ, dtype=_F64, device=Ti.device)
    return torch.cat([xyz.expand(t_min.shape + (3,)), t_min[..., None]], dim=-1)


def solve_lq(Ti, cable_pos, c0, n_iter: int = 10, fix_z: bool = False,
             initial_guess=None, *, device=None) -> torch.Tensor:
    """Gauss-Newton estimate of ``[x, y, z, t0]`` from arrival times
    ``Ti [..., nch]``: Tikhonov-regularised normal equations, a step
    damped by 0.7 in the first four iterations then full steps, and
    ``fix_z`` to freeze the depth at the guess. ``initial_guess [..., 4]``
    defaults to ``[40000, 23000, -60, min(Ti)]``. Leading axes of ``Ti``
    (and of the guess) are a batch. Returns ``[..., 4]``."""
    dev = _device_of((Ti, cable_pos, initial_guess), device)
    Ti, cable_pos = _f64(Ti, dev), _f64(cable_pos, dev)
    finite = torch.isfinite(Ti)
    w = finite.to(_F64)
    Ti_f = torch.where(finite, Ti, torch.zeros_like(Ti))
    n = _default_guess(Ti) if initial_guess is None else _f64(initial_guess, dev)
    n = n.expand(Ti.shape[:-1] + (4,)).clone()
    eye = LAMBDA_REG * torch.eye(4, dtype=_F64, device=dev)
    # with the z column zero, the z-z entry of G^T G is the regularisation
    # weight alone, so dn[2] == 0 and the mask only makes it explicit
    update_mask = torch.tensor([1.0, 1.0, 0.0 if fix_z else 1.0, 1.0], dtype=_F64, device=dev)
    for j in range(n_iter):
        G = _design_matrix(cable_pos, n, c0, fix_z) * w[..., None]
        dt = (Ti_f - calc_arrival_times(n[..., 3], cable_pos, n, c0)) * w
        Gt = G.transpose(-1, -2)
        dn = torch.linalg.solve(Gt @ G + eye, (Gt @ dt[..., None])[..., 0])
        step = 0.7 if j < 4 else 1.0
        n = n + step * dn * update_mask
    return n


def solve_lq_batch(Ti_batch, cable_pos, c0, n_iter: int = 10, fix_z: bool = False, *,
                   device=None) -> torch.Tensor:
    """:func:`solve_lq` over a leading event axis of ``Ti_batch
    [events, nch]`` in one batched solve."""
    return solve_lq(Ti_batch, cable_pos, c0, n_iter=n_iter, fix_z=fix_z, device=device)


def _rms_residual(Ti: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    finite = torch.isfinite(Ti)
    sq = torch.where(finite, (preds - Ti) ** 2, torch.zeros_like(preds))
    return torch.sqrt(sq.sum(dim=-1) / torch.clamp_min(finite.sum(dim=-1), 1))


def solve_lq_multistart(Ti, cable_pos, c0, initial_guesses, n_iter: int = 10,
                        fix_z: bool = False, *, device=None) -> torch.Tensor:
    """Solve from every row of ``initial_guesses [K, 4]`` at once and keep
    the lowest-RMS-residual solution (the start that lands in the right
    basin of the cable's left/right mirror ambiguity). Returns ``[4]``."""
    dev = _device_of((Ti, cable_pos, initial_guesses), device)
    Ti, cable_pos = _f64(Ti, dev), _f64(cable_pos, dev)
    guesses = _f64(initial_guesses, dev)
    Tk = Ti.expand((guesses.shape[0],) + tuple(Ti.shape))
    sols = solve_lq(Tk, cable_pos, c0, n_iter=n_iter, fix_z=fix_z, initial_guess=guesses)
    preds = calc_arrival_times(sols[..., 3], cable_pos, sols, c0)
    return sols[torch.argmin(_rms_residual(Ti, preds))]


def mirror_guesses(cable_pos, Ti, c0, offsets=(500.0, 2000.0, 6000.0), z0=-60.0) -> np.ndarray:
    """A ``[2K+1, 4]`` multi-start guess set straddling the cable: the
    earliest-arrival channel, then that point offset perpendicular to the
    local cable direction on both sides at each range in ``offsets``
    (host numpy)."""
    cable_pos = _host(cable_pos)
    Ti = _host(Ti)
    i0 = int(np.nanargmin(Ti))
    p0 = cable_pos[i0]
    i1 = min(i0 + 1, len(cable_pos) - 1)
    i_prev = max(i0 - 1, 0)
    tang = cable_pos[i1, :2] - cable_pos[i_prev, :2]
    norm = np.array([-tang[1], tang[0]])
    norm /= max(np.linalg.norm(norm), 1e-12)
    t0 = float(np.nanmin(Ti))
    guesses = [np.array([p0[0], p0[1], z0, t0])]
    for d in offsets:
        for sgn in (+1.0, -1.0):
            xy = p0[:2] + sgn * d * norm
            # a source at range d emits about d/c0 before the earliest arrival
            guesses.append(np.array([xy[0], xy[1], z0, t0 - d / c0]))
    return np.stack(guesses)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def cal_variance_residuals(arrtimes, predic_arrtimes, fix_z: bool = False, *,
                           device=None) -> torch.Tensor:
    """Residual variance over the last axis with ``nch - 3`` (``fix_z``)
    or ``nch - 4`` degrees of freedom, counting finite residuals only
    and never fewer than 1."""
    dev = _device_of((arrtimes, predic_arrtimes), device)
    residuals = _f64(arrtimes, dev) - _f64(predic_arrtimes, dev)
    finite = torch.isfinite(residuals)
    n_par = 3 if fix_z else 4
    dof = torch.clamp_min(finite.sum(dim=-1) - n_par, 1)
    return torch.where(finite, residuals ** 2, torch.zeros_like(residuals)).sum(dim=-1) / dof


def calc_covariance_matrix(cable_pos, whale_pos, c0, var, fix_z: bool = False,
                           weights=None, *, device=None) -> torch.Tensor:
    """Covariance of the estimated position, ``var * (G^T G)^{-1}``; the
    Tikhonov term joins only when the normal matrix's condition number
    (from ``eigvalsh``) exceeds ``1/eps``. ``fix_z`` drops the z row and
    column (a ``[..., 3, 3]`` covariance over x, y, t0)."""
    dev = _device_of((cable_pos, whale_pos, var, weights), device)
    cable_pos, whale_pos, var = _f64(cable_pos, dev), _f64(whale_pos, dev), _f64(var, dev)
    G = _design_matrix(cable_pos, whale_pos, c0, fix_z=False)
    if fix_z:
        G = torch.cat([G[..., :2], G[..., 3:]], dim=-1)
    if weights is not None:
        G = G * _f64(weights, dev)[..., None]
    gtg = G.transpose(-1, -2) @ G
    eye = torch.eye(gtg.shape[-1], dtype=_F64, device=dev)
    ev = torch.linalg.eigvalsh(gtg)
    finfo = torch.finfo(_F64)
    cond = torch.abs(ev[..., -1]) / torch.clamp_min(torch.abs(ev[..., 0]), finfo.tiny)
    lam = torch.where(cond > 1.0 / finfo.eps, torch.full_like(cond, LAMBDA_REG),
                      torch.zeros_like(cond))
    return var[..., None, None] * torch.linalg.inv(gtg + lam[..., None, None] * eye)


def calc_uncertainty_position(cable_pos, whale_pos, c0, var, fix_z: bool = False,
                              weights=None, *, device=None) -> torch.Tensor:
    """1-sigma uncertainties: the square root of the covariance's
    diagonal."""
    cov = calc_covariance_matrix(cable_pos, whale_pos, c0, var, fix_z, weights=weights,
                                 device=device)
    return torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))


class LocalizationResult(NamedTuple):
    """Solved position and its uncertainty, one event (or a batch along
    leading axes)."""

    position: torch.Tensor     # [..., 4] (x, y, z, t0)
    uncertainty: torch.Tensor  # [..., 4], or [..., 3] with fix_z
    variance: torch.Tensor     # [...] residual variance
    residuals: torch.Tensor    # [..., nch] arrival-time residuals (s)


def localize(Ti, cable_pos, c0, n_iter: int = 10, fix_z: bool = False,
             initial_guess=None, *, device=None) -> LocalizationResult:
    """One event end to end: :func:`solve_lq`, the residual variance and
    the uncertainty (finite channels weighted 1, the rest 0). Leading
    axes of ``Ti`` localize a batch."""
    dev = _device_of((Ti, cable_pos, initial_guess), device)
    Ti, cable_pos = _f64(Ti, dev), _f64(cable_pos, dev)
    n = solve_lq(Ti, cable_pos, c0, n_iter=n_iter, fix_z=fix_z, initial_guess=initial_guess)
    pred = calc_arrival_times(n[..., 3], cable_pos, n, c0)
    var = cal_variance_residuals(Ti, pred, fix_z=fix_z)
    w = torch.isfinite(Ti).to(_F64)
    unc = calc_uncertainty_position(cable_pos, n, c0, var, fix_z=fix_z, weights=w)
    return LocalizationResult(position=n, uncertainty=unc, variance=var, residuals=Ti - pred)


def localize_batch(Ti_batch, cable_pos, c0, n_iter: int = 10, fix_z: bool = False, *,
                   device=None) -> LocalizationResult:
    """:func:`localize` over a leading event axis of ``Ti_batch [events,
    nch]``, in one batched pass."""
    return localize(Ti_batch, cable_pos, c0, n_iter=n_iter, fix_z=fix_z, device=device)


def picks_to_arrival_times(pick_channels, pick_times, n_channels: int, fill=np.nan) -> np.ndarray:
    """Scatter ragged detector picks into a dense per-channel arrival-time
    vector (host float64); later picks on a channel overwrite earlier
    ones, channels with no pick get ``fill``."""
    ti = np.full(n_channels, fill, dtype=np.float64)
    ti[np.asarray(pick_channels, dtype=np.int64)] = np.asarray(pick_times, dtype=np.float64)
    return ti
