"""Whale-call template synthesis (chirps) and template banks.

The port's copy of ``das4whales_tpu.models.templates``: the reference
chirp laws (``scipy.signal.chirp`` linear and hyperbolic, in closed
form), the Hann-windowed fin-call template zero-padded to the record
length, and :class:`TemplateBank`, the ordered named template set whose
``compile`` gives the detector's ``[T, time]`` stack. Templates are host
numpy, computed in float64 and cast to float32 by ``compile``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Tuple

import numpy as np
import torch

from ..config import FIN_HF_NOTE, FIN_LF_NOTE, CallTemplateConfig
from ..ops.spectral import hann_window


def _time_vector(duration: float, fs: float) -> np.ndarray:
    """``np.arange(0, duration, 1/fs)`` — the reference's sample grid."""
    return np.arange(0, duration, 1.0 / fs)


def gen_linear_chirp(fmin: float, fmax: float, duration: float, fs: float) -> np.ndarray:
    """Linear down-swept chirp from fmax to fmin
    (``scipy.signal.chirp(method='linear')``)."""
    t = _time_vector(duration, fs)
    f0, f1, t1 = fmax, fmin, duration
    return np.cos(2.0 * np.pi * (f0 * t + 0.5 * (f1 - f0) / t1 * t * t))


def gen_hyperbolic_chirp(fmin: float, fmax: float, duration: float, fs: float) -> np.ndarray:
    """Hyperbolic down-swept chirp from fmax to fmin
    (``scipy.signal.chirp(method='hyperbolic')``)."""
    t = _time_vector(duration, fs)
    f0, f1, t1 = fmax, fmin, duration
    if f0 == f1:
        return np.cos(2 * np.pi * f0 * t)
    sing = -f1 * t1 / (f0 - f1)
    return np.cos(2.0 * np.pi * (-sing * f0) * np.log(np.abs(1.0 - t / sing)))


def gen_template_fincall(
    time: np.ndarray,
    fs: float,
    fmin: float = 15.0,
    fmax: float = 25.0,
    duration: float = 1.0,
    window: bool = True,
    method: str = "hyperbolic",
) -> np.ndarray:
    """Fin-whale call template: Hann-windowed down-swept chirp zero-padded
    to the length of ``time`` (a call longer than the record truncates)."""
    if method == "hyperbolic":
        chirp = gen_hyperbolic_chirp(fmin, fmax, duration, fs)
    elif method == "linear":
        chirp = gen_linear_chirp(fmin, fmax, duration, fs)
    else:
        raise ValueError(
            f"unknown chirp method {method!r}; expected 'hyperbolic' or 'linear'"
        )
    if window:
        chirp = chirp * hann_window(chirp.shape[0], dtype=torch.float64).numpy()
    template = np.zeros(np.shape(time))
    chirp = chirp[: int(np.shape(time)[-1])]
    template[: chirp.shape[0]] = chirp
    return template


@dataclass(frozen=True)
class TemplateBank:
    """An ordered, named set of call templates (the order IS the stack
    order). ``threshold_scope``: ``"global"`` bases every template's
    threshold on one max over all correlograms (the reference policy);
    ``"per_template"`` on each template's own max."""

    name: str
    entries: Tuple[Tuple[str, CallTemplateConfig], ...]
    threshold_scope: str = "per_template"

    def __post_init__(self):
        if self.threshold_scope not in ("global", "per_template"):
            raise ValueError(
                f"unknown threshold_scope {self.threshold_scope!r}; "
                "expected 'global' or 'per_template'"
            )
        if not self.entries:
            raise ValueError(f"template bank {self.name!r} is empty")
        names = [n for n, _ in self.entries]
        if len(set(names)) != len(names):
            raise ValueError(f"template bank {self.name!r} has duplicate entry names")

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.entries)

    def threshold_factors(self, dtype=np.float32) -> np.ndarray:
        """The per-template threshold-factor vector, in stack order."""
        return np.asarray([c.threshold_factor for _, c in self.entries], dtype)

    def compile(self, n_time: int, fs: float, dtype=np.float32) -> np.ndarray:
        """The bank as one ``[T, n_time]`` template stack (host numpy)."""
        time = np.arange(int(n_time)) / float(fs)
        return np.stack([
            gen_template_fincall(time, fs, c.fmin, c.fmax, c.duration,
                                 c.window, method=c.method)
            for _, c in self.entries
        ]).astype(dtype)


#: The reference default: the HF/LF fin-note pair under the global
#: threshold policy.
FIN_BANK = TemplateBank(
    name="fin", entries=(("HF", FIN_HF_NOTE), ("LF", FIN_LF_NOTE)),
    threshold_scope="global",
)


def resolve_bank(templates=None) -> TemplateBank:
    """Accept a :class:`TemplateBank` (as is), ``None`` or ``"fin"`` (the
    fin bank), or a ``{name: CallTemplateConfig}`` mapping (an anonymous
    global-scope bank with each config's own threshold factor)."""
    if isinstance(templates, TemplateBank):
        return templates
    if templates is None or templates == "fin":
        return FIN_BANK
    if isinstance(templates, str):
        raise NotImplementedError(
            f"template bank {templates!r}: this slice of the port carries the "
            "'fin' bank, explicit TemplateBanks and config mappings; named banks "
            "and chirp-grid specs come with the ROADMAP item 'Template banks "
            "beyond fin' (ROADMAP.md, 'Open items', 1)"
        )
    if isinstance(templates, Mapping):
        return TemplateBank(
            name="custom", entries=tuple(templates.items()),
            threshold_scope="global",
        )
    raise TypeError(
        f"templates must be a TemplateBank, 'fin', a mapping or None — "
        f"got {type(templates).__name__}"
    )
