"""f-k filter comparison workflow (the port's copy of
``das4whales_tpu.workflows.fkcomp``, reference
``scripts/main_fkcomp.py:64-125``): design all four hybrid filter
variants on the same block (host numpy), apply each on the block's
device, and compare the resulting SNR matrices."""

from __future__ import annotations

from ..config import SCRIPT_FK
from ..ops import fk as fk_ops
from ..ops.spectral import snr_tr_array
from ..utils.device import resolve_device
from .common import acquire, maybe_savefig

_DESIGNERS = {
    "hybrid": lambda shape, sel, dx, fs, c: fk_ops.hybrid_filter_design(
        shape, sel, dx, fs, c.cs_min, c.cp_min, c.fmin, c.fmax),
    "hybrid_ninf": lambda shape, sel, dx, fs, c: fk_ops.hybrid_ninf_filter_design(
        shape, sel, dx, fs, c.cs_min, c.cp_min, c.cp_max, c.cs_max, c.fmin, c.fmax),
    "hybrid_gs": lambda shape, sel, dx, fs, c: fk_ops.hybrid_gs_filter_design(
        shape, sel, dx, fs, c.cs_min, c.cp_min, c.fmin, c.fmax),
    "hybrid_ninf_gs": lambda shape, sel, dx, fs, c: fk_ops.hybrid_ninf_gs_filter_design(
        shape, sel, dx, fs, c.cs_min, c.cp_min, c.cp_max, c.cs_max, c.fmin, c.fmax),
}


def main(url: str | None = None, outdir: str | None = None, show: bool = False,
         selected_channels_m=None, fk_config=SCRIPT_FK, interrogator: str = "optasense",
         device=None):
    """Design, apply and score the four hybrid f-k filters on ``url``
    (None: the offline synthetic scene) on ``device`` (None: the card).
    Returns ``filtered`` and ``snr`` (tensors on the device), the
    ``compression`` report of each mask, the block and the figures
    (``fkcomp_snr_<variant>.png`` with ``outdir`` or ``show``; matplotlib
    is checked for before the file is read)."""
    if outdir is not None or show:
        from ..viz.plot import require_matplotlib

        require_matplotlib("fkcomp with outdir or show")
    device = resolve_device(device)
    block, meta, sel = acquire(url, selected_channels_m=selected_channels_m,
                               interrogator=interrogator, device=device)
    shape = tuple(block.trace.shape)

    filtered, snr, reports, figures = {}, {}, {}, {}
    for name, designer in _DESIGNERS.items():
        mask = designer(shape, sel, meta.dx, meta.fs, fk_config)
        reports[name] = fk_ops.compression_report(mask, verbose=False)
        trf = fk_ops.fk_filter_apply_rfft(block.trace, mask)
        filtered[name] = trf
        snr[name] = snr_tr_array(trf, env=True)
        if outdir is not None or show:
            from .. import viz

            fig = viz.snr_matrix(snr[name], block.tx, block.dist, vmax=30, title=name,
                                 show=show)
            figures[name] = maybe_savefig(fig, outdir, f"fkcomp_snr_{name}.png")

    return {
        "filtered": filtered,
        "snr": snr,
        "compression": reports,
        "block": block,
        "figures": figures,
    }


if __name__ == "__main__":
    import sys

    main(sys.argv[1] if len(sys.argv) > 1 else None, outdir="out_fkcomp")
