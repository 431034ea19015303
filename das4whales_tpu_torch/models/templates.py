"""Whale-call template synthesis (chirps) and template banks.

The port's copy of ``das4whales_tpu.models.templates``: the reference
chirp laws (``scipy.signal.chirp`` linear and hyperbolic, in closed
form), the Hann-windowed fin-call template zero-padded to the record
length, :class:`TemplateBank`, the ordered named template set whose
``compile`` gives the detector's ``[T, time]`` stack, and the bank
registry: the built-in ``fin``, ``fin-variants`` and ``blue`` banks,
configurable chirp grids (``chirp-grid:T[:fmin-fmax[:durs]]`` specs) and
the ``DAS_TEMPLATE_BANK`` default. Templates are host numpy, computed in
float64 and cast to float32 by ``compile`` (the JAX package synthesizes
them in its own float width, so its float32 stacks sit about 1e-5 off).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Mapping, Tuple

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

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.entries)

    @property
    def configs(self) -> Dict[str, CallTemplateConfig]:
        """name -> config mapping, in stack order."""
        return dict(self.entries)

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

    def subset(self, lo: int, hi: int) -> "TemplateBank":
        """The contiguous sub-bank ``entries[lo:hi]`` (stack order kept):
        the unit of the downshift ladder's bank-split rung."""
        if not 0 <= lo < hi <= len(self.entries):
            raise ValueError(
                f"sub-bank [{lo}:{hi}] out of range for T={len(self.entries)}"
            )
        return replace(self, name=f"{self.name}[{lo}:{hi}]", entries=self.entries[lo:hi])

    def split(self) -> Tuple["TemplateBank", "TemplateBank"]:
        """Halve the bank: ``(entries[:ceil(T/2)], entries[ceil(T/2):])``."""
        if len(self.entries) < 2:
            raise ValueError(f"cannot split a T={len(self.entries)} bank")
        mid = (len(self.entries) + 1) // 2
        return self.subset(0, mid), self.subset(mid, len(self.entries))

    @property
    def splittable(self) -> bool:
        """True when sub-bank runs give the one-dispatch bank's picks bit
        for bit: decoupled per-template thresholds and T >= 2."""
        return self.threshold_scope == "per_template" and len(self) >= 2


#: Fin B-call note variants around the canonical HF/LF pair.
_FIN_VARIANTS = (
    ("HF", FIN_HF_NOTE),
    ("LF", FIN_LF_NOTE),
    ("HF-short", CallTemplateConfig(fmin=18.5, fmax=28.0, duration=0.55,
                                    threshold_factor=0.9)),
    ("LF-long", CallTemplateConfig(fmin=14.0, fmax=20.5, duration=0.95)),
)

#: Blue-whale northeast-Pacific call components near the fin passband:
#: the B-call's 15-16 Hz fundamental and the D-call downsweeps.
_BLUE_ENTRIES = (
    ("B-fund", CallTemplateConfig(fmin=14.5, fmax=16.2, duration=5.0)),
    ("D-call", CallTemplateConfig(fmin=22.0, fmax=28.0, duration=1.8,
                                  method="linear")),
    ("D-low", CallTemplateConfig(fmin=15.0, fmax=22.0, duration=2.5,
                                 method="linear")),
)


def chirp_grid(n: int, band=(14.0, 30.0), durations=(0.7,), method: str = "hyperbolic",
               width_hz: float = 8.0, threshold_factor: float = 1.0,
               name: str | None = None) -> TemplateBank:
    """A T-template chirp grid: ``n`` down-swept chirps whose
    ``width_hz``-wide sub-bands tile ``band``, crossed with ``durations``
    (cycled when ``n`` exceeds the sweep count). Entry names are
    deterministic, ``chirp-<method>-<fmin>-<fmax>-<duration>s``; every grid
    bank has the splittable ``per_template`` scope."""
    if n < 1:
        raise ValueError(f"chirp grid needs n >= 1, got {n}")
    lo, hi = float(band[0]), float(band[1])
    width = min(float(width_hz), hi - lo)
    durs = tuple(float(d) for d in durations) or (0.7,)
    n_sweeps = max(1, -(-n // len(durs)))
    entries = []
    for k in range(n):
        s, d = k % n_sweeps, durs[(k // n_sweeps) % len(durs)]
        f0 = lo + (hi - lo - width) * (s / max(1, n_sweeps - 1) if n_sweeps > 1 else 0.0)
        cfg = CallTemplateConfig(fmin=round(f0, 2), fmax=round(f0 + width, 2), duration=d,
                                 method=method, threshold_factor=threshold_factor)
        entries.append((f"chirp-{method[:3]}-{cfg.fmin:g}-{cfg.fmax:g}-{d:g}s", cfg))
    # distinct (sweep, duration) pairs by construction; a degenerate grid
    # (n > sweeps * durations) repeats a name, which gets a suffix
    seen, uniq = set(), []
    for nm, cfg in entries:
        if nm in seen:
            nm = f"{nm}#{len(uniq)}"
        seen.add(nm)
        uniq.append((nm, cfg))
    return TemplateBank(name=name or f"chirp-grid-{n}", entries=tuple(uniq),
                        threshold_scope="per_template")


_REGISTRY: Dict[str, TemplateBank] = {}


def register_bank(bank: TemplateBank) -> TemplateBank:
    """Register ``bank`` under its name (the last registration wins) and
    return it; ``templates="<name>"`` and ``DAS_TEMPLATE_BANK`` select it."""
    _REGISTRY[bank.name] = bank
    return bank


def bank_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_bank(name: str) -> TemplateBank:
    """A registered bank, or a parsed chirp-grid spec (``chirp-grid:T``,
    ``chirp-grid:T:fmin-fmax`` or ``chirp-grid:T:fmin-fmax:d0,d1,...``)."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith("chirp-grid:"):
        parts = name.split(":")[1:]
        n = int(parts[0])
        band = (14.0, 30.0)
        if len(parts) > 1 and parts[1]:
            b0, b1 = parts[1].split("-")
            band = (float(b0), float(b1))
        durs = (0.7,)
        if len(parts) > 2 and parts[2]:
            durs = tuple(float(d) for d in parts[2].split(","))
        return chirp_grid(n, band=band, durations=durs, name=name)
    raise KeyError(
        f"unknown template bank {name!r}; registered: {bank_names()} "
        "(or a 'chirp-grid:T[:fmin-fmax[:durs]]' spec)"
    )


#: The reference default: the HF/LF fin-note pair under the global
#: threshold policy.
FIN_BANK = register_bank(TemplateBank(
    name="fin", entries=(("HF", FIN_HF_NOTE), ("LF", FIN_LF_NOTE)),
    threshold_scope="global",
))

FIN_VARIANTS_BANK = register_bank(TemplateBank(
    name="fin-variants", entries=_FIN_VARIANTS, threshold_scope="per_template",
))

BLUE_BANK = register_bank(TemplateBank(
    name="blue", entries=_BLUE_ENTRIES, threshold_scope="per_template",
))


def resolve_bank(templates=None) -> TemplateBank:
    """Accept a :class:`TemplateBank` (as is), a registered bank name or
    chirp-grid spec, a ``{name: CallTemplateConfig}`` mapping (an
    anonymous global-scope bank with each config's own threshold factor)
    or ``None``: the ``DAS_TEMPLATE_BANK`` default (``config.
    template_bank_default``, ``"fin"`` unless set)."""
    if isinstance(templates, TemplateBank):
        return templates
    if templates is None:
        from ..config import template_bank_default

        return get_bank(template_bank_default())
    if isinstance(templates, str):
        return get_bank(templates)
    if isinstance(templates, Mapping):
        return TemplateBank(
            name="custom", entries=tuple(templates.items()),
            threshold_scope="global",
        )
    raise TypeError(
        f"templates must be a TemplateBank, bank name, mapping or None — "
        f"got {type(templates).__name__}"
    )
