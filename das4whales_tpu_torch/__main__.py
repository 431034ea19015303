"""Unified command line of the port: ``python -m das4whales_tpu_torch <verb> [options]``.

The JAX package's verbs with its flags, help texts and exit codes: the
six workflows, ``list``, ``fsck``, ``evaluate``, ``campaign``,
``longrecord`` and ``serve``. Every workflow runs offline on a synthetic
OOI-like scene when no URL/file is given (an OptaSense HDF5 file, which
needs ``h5py``), or on a real OptaSense/Silixa file when one is.

Three differences from the JAX package's command line:

* ``--device {cuda,cpu}`` on every verb that computes (default: the
  card; never a fallback to the CPU) takes the place of
  ``JAX_PLATFORMS``; ``serve`` reads its device from the registry;
* the six workflow verbs take ``--interrogator`` (default
  ``optasense``), as ``campaign`` and ``longrecord`` do;
* a verb that renders (the workflows, whose ``--outdir`` defaults to
  ``out_<name>``; ``campaign``'s ``density.png``; ``evaluate
  --figure``) checks for matplotlib before it reads a file and exits 2
  naming it where it is missing.

Not in this slice: ``fleet`` (exit 2, naming the ROADMAP item 'Service
and fleet') and ``campaign --sharded`` / ``--multihost`` (exit 2,
'Multi-GPU').

Examples::

    python -m das4whales_tpu_torch mfdetect --device cpu --outdir out
    python -m das4whales_tpu_torch mfdetect file.tdms --interrogator silixa
    python -m das4whales_tpu_torch longrecord seg0.h5 seg1.h5
    python -m das4whales_tpu_torch campaign *.h5 --outdir out_camp
    python -m das4whales_tpu_torch list
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

from .config import not_in_slice

WORKFLOWS = {
    "mfdetect": "matched-filter detection (flagship: bandpass -> f-k -> "
                "HF/LF correlograms -> envelope peak picks)",
    "spectrodetect": "spectrogram-correlation detection (hat kernels)",
    "gabordetect": "Gabor / image-processing detection",
    "fkcomp": "f-k filter design comparison figures",
    "plots": "exploratory t-x / f-x / spectrogram plots",
    "bathynoise": "bathymetry-referenced noise maps",
}


def _add_route_flags(p, default, extra=""):
    """The one filter-route knob, spelled once: --fused (library default)
    vs --staged (the golden-validation baseline route)."""
    p.add_argument("--fused", dest="fused", action="store_true", default=default,
                   help="fused bandpass∘f-k route" + extra)
    p.add_argument("--staged", dest="fused", action="store_false",
                   help="opt back to the staged bandpass->f-k route")


def _add_device_flag(p):
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where to compute (default: the CUDA card; no fallback to the CPU)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="das4whales_tpu_torch",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="workflow", required=True)
    sub.add_parser("list", help="list available workflows")
    pf = sub.add_parser(
        "fsck",
        help="verify (and with --repair fix) campaign/service artifact state after an "
             "unclean death: orphan tmps, torn or checksum-failed manifest records, "
             "truncated JSON exports, manifest<->picks mismatches",
    )
    pf.add_argument("outdir", help="campaign outdir or service root")
    pf.add_argument("--repair", action="store_true",
                    help="fix what was found: truncate torn tails, quarantine corrupt "
                         "lines into manifest.corrupt.jsonl, remove orphans")
    pf.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    pe = sub.add_parser(
        "evaluate",
        help="detection-quality sweep: injection recall/precision vs SNR on the "
             "production matched-filter detector (das4whales_tpu_torch.eval)",
    )
    pe.add_argument("--amplitudes", default="0.02,0.05,0.15,0.5,1.0",
                    help="comma-separated call amplitudes (noise RMS 0.05)")
    pe.add_argument("--seeds", default="0", help="comma-separated noise seeds")
    pe.add_argument("--nx", type=int, default=256)
    pe.add_argument("--ns", type=int, default=6000)
    pe.add_argument("--family", default="mf",
                    choices=("mf", "spectro", "gabor", "learned", "all"),
                    help="detector family to score (all: cross-family table; learned "
                         "trains its CNN on synthetic scenes first)")
    pe.add_argument("--time-tol", type=float, default=0.5,
                    help="pick-to-arrival match tolerance [s]")
    pe.add_argument("--out", default=None, help="also write the sweep JSON here")
    pe.add_argument("--figure", default=None,
                    help="also render recall/precision curves (PNG; per-family suffix "
                         "with --family all)")
    _add_route_flags(pe, default=True, extra=" (the library default)")
    _add_device_flag(pe)
    pc = sub.add_parser(
        "campaign",
        help="fault-tolerant resumable detection over many files "
             "(workflows.campaign: manifest + per-file picks artifacts)",
    )
    pc.add_argument("files", nargs="+", help="HDF5/TDMS file paths, in order")
    pc.add_argument("--outdir", default="out_campaign")
    pc.add_argument("--channels", default=None,
                    help="start,stop,step channel selection (default: all of file 0)")
    pc.add_argument("--max-failures", type=int, default=None)
    pc.add_argument("--trace", action="store_true", default=None,
                    help="arm the flight recorder: span-trace the campaign and export "
                         "<outdir>/trace.json (Perfetto/Chrome-trace; same as DAS_TRACE=1)")
    pc.add_argument("--no-resume", action="store_true",
                    help="reprocess files already recorded done in the manifest")
    pc.add_argument("--interrogator", default="optasense")
    pc.add_argument("--sharded", action="store_true",
                    help="detect batches on a (file x channel) device mesh (not in this "
                         "slice of the port: 'Multi-GPU')")
    pc.add_argument("--multihost", action="store_true",
                    help="one SPMD campaign across all processes of a multi-process "
                         "runtime (not in this slice of the port: 'Multi-GPU')")
    pc.add_argument("--bank", default=None,
                    help="mf-family TEMPLATE BANK: a registered name (fin, fin-variants, "
                         "blue) or a 'chirp-grid:T[:fmin-fmax[:durs]]' spec — all T "
                         "templates detect in ONE dispatch per file (models/templates.py; "
                         "default: DAS_TEMPLATE_BANK, else the reference fin pair)")
    pc.add_argument("--family", default="mf",
                    choices=("mf", "spectro", "gabor", "learned"),
                    help="detector family (spectro/gabor run through the shared "
                         "bandpass+f-k front end; learned needs --model)")
    pc.add_argument("--model", default=None,
                    help="trained learned-family model (.npz from models.learned."
                         "save_params of either package; required for --family learned)")
    _add_route_flags(pc, default=True,
                     extra=" (library default; also governs the spectro/gabor families' "
                           "shared bandpass+f-k front end)")
    _add_device_flag(pc)
    ps = sub.add_parser(
        "serve",
        help="run the streaming multi-tenant detection service: continuous ingest, fair "
             "multi-stream scheduling, and the picks/health HTTP API",
    )
    ps.add_argument("config", help="JSON tenant registry (tenants, outdir, port, device)")
    ps.add_argument("--port", type=int, default=None,
                    help="override the registry's API port (0: ephemeral)")
    ps.add_argument("--outdir", default=None, help="override the registry's output root")
    ps.add_argument("--until-idle", action="store_true",
                    help="exit once every replay source is exhausted and resolved "
                         "(backfill mode) instead of serving until SIGTERM")
    ps.add_argument("--no-resume", action="store_true",
                    help="reprocess files already settled in the tenant manifests")
    ps.add_argument("--trace", action="store_true", default=None,
                    help="arm the flight recorder for the whole service run "
                         "(exports <outdir>/trace.json at drain)")
    pfl = sub.add_parser(
        "fleet",
        help="run a supervised multi-worker fleet (not in this slice of the port: "
             "'Service and fleet')",
    )
    pfl.add_argument("config", help="JSON fleet registry (tenants, workers, root)")
    pfl.add_argument("--port", type=int, default=None,
                     help="override the router port (0: ephemeral)")
    pfl.add_argument("--root", default=None, help="override the fleet root directory")
    pfl.add_argument("--workers", type=int, default=None, help="override the worker count")
    pfl.add_argument("--until-settled", action="store_true",
                     help="exit once every tenant's file list is manifest-settled "
                          "fleet-wide (backfill mode) instead of serving until SIGTERM")
    pfl.add_argument("--settle-timeout", type=float, default=600.0,
                     help="--until-settled deadline in seconds")
    pl = sub.add_parser(
        "longrecord",
        help="continuous detection across file boundaries: consecutive files become ONE "
             "record (workflows.longrecord; boundary-straddling calls the per-file "
             "reference mode loses)",
    )
    pl.add_argument("files", nargs="+",
                    help="consecutive segments of one recording, in order")
    pl.add_argument("--outdir", default="out_longrecord")
    pl.add_argument("--channels", default=None,
                    help="start,stop,step channel selection (default: all of file 0)")
    pl.add_argument("--family", default="mf", choices=("mf", "spectro", "gabor", "learned"))
    pl.add_argument("--model", default=None,
                    help="trained learned-family model (.npz; required for --family "
                         "learned)")
    pl.add_argument("--halo", type=int, default=512,
                    help="time-shard halo samples for the STAGED bandpass (all families; "
                         "the mf fused default has no halo-exchange bandpass and ignores "
                         "it — pass --staged to make --halo effective)")
    _add_route_flags(pl, default=None,
                     extra=" (mf-family default; spectro/gabor design their own bandpass)")
    pl.add_argument("--max-peaks", type=int, default=512, help="pick capacity per channel")
    pl.add_argument("--interrogator", default="optasense")
    _add_device_flag(pl)
    for name, help_text in WORKFLOWS.items():
        p = sub.add_parser(name, help=help_text)
        p.add_argument("url", nargs="?", default=None,
                       help="HDF5/TDMS file path or URL (omit: offline synthetic scene)")
        p.add_argument("--outdir", default=f"out_{name}",
                       help="directory for figures/artifacts (default: out_<workflow>)")
        p.add_argument("--show", action="store_true", help="show figures interactively")
        p.add_argument("--interrogator", default="optasense",
                       help="the file's interrogator (optasense HDF5, silixa TDMS, ...)")
        if name in ("mfdetect",):
            p.add_argument("--no-snr", action="store_true", help="skip SNR matrices")
        _add_device_flag(p)
    return ap


def _no_matplotlib(what: str) -> bool:
    """Print why ``what`` cannot run and return True when matplotlib is
    missing (the verb then exits 2, before it reads a file)."""
    from .viz.plot import require_matplotlib

    try:
        require_matplotlib(what)
    except ImportError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return True
    return False


def _no_nan(v):
    """Zero-pick sweep points carry precision=NaN; strict-JSON consumers
    (jq, json.load) reject bare NaN tokens."""
    if isinstance(v, dict):
        return {k: _no_nan(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_no_nan(x) for x in v]
    if isinstance(v, float) and v != v:
        return None
    return v


def _evaluate(args) -> int:
    import json

    from .eval import GaborEvalAdapter, SpectroEvalAdapter, amplitude_sweep, default_eval_scene
    from .models.matched_filter import MatchedFilterDetector
    from .utils.device import resolve_device

    if args.figure and _no_matplotlib("evaluate --figure"):
        return 2
    dev = resolve_device(args.device)
    scene = default_eval_scene(nx=args.nx, ns=args.ns)
    mf = MatchedFilterDetector(scene.metadata, [0, scene.nx, 1], (scene.nx, scene.ns),
                               fused_bandpass=args.fused, device=dev)
    detectors = {"mf": mf}
    if args.family in ("spectro", "all"):
        from .models.spectro import SpectroCorrDetector

        detectors["spectro"] = SpectroEvalAdapter(
            mf, SpectroCorrDetector(scene.metadata, device=dev))
    if args.family in ("gabor", "all"):
        from .models.gabor import GaborDetector

        detectors["gabor"] = GaborEvalAdapter(
            mf, GaborDetector(scene.metadata, [0, scene.nx, 1], device=dev))
    if args.family in ("learned", "all"):
        # trained on the fly: synthetic scenes disjoint from the eval scene
        # (different seeds and geometry)
        from .io.synth import SyntheticCall, SyntheticScene
        from .models import learned

        cfg = learned.LearnedConfig()
        train_scenes = [
            SyntheticScene(
                nx=min(64, scene.nx), ns=min(4000, scene.ns),
                dx=scene.dx, noise_rms=scene.noise_rms or 0.08,
                seed=1000 + s,
                # amplitude curriculum reaching into the low-SNR regime the
                # sweep scores (0.12 ~ 8 dB here)
                calls=[
                    SyntheticCall(t0=2.5 + 3.5 * k,
                                  x0_m=(0.15 + 0.18 * k) * min(64, scene.nx) * scene.dx,
                                  amplitude=0.12 + 0.22 * k + 0.04 * s)
                    for k in range(4)
                ],
            )
            for s in range(3)
        ]
        model, _ = learned.fit(cfg, train_scenes, epochs=25, batch=512, device=dev)
        detectors["learned"] = learned.LearnedDetector(model, cfg, device=dev)
    if args.family != "all":
        detectors = {args.family: detectors[args.family]}
    amps = [float(a) for a in args.amplitudes.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    out = {fam: amplitude_sweep(det, scene, amps, seeds=seeds, time_tol_s=args.time_tol)
           for fam, det in detectors.items()}
    payload = _no_nan(out if args.family == "all" else out[args.family])
    if args.out:
        from .utils.artifacts import atomic_json

        atomic_json(args.out, payload, indent=1)
        print("wrote", args.out, file=sys.stderr)
    if args.figure:
        import matplotlib

        matplotlib.use("Agg")
        from .viz.plot import plot_eval_curves

        stem, ext = os.path.splitext(args.figure)
        for fam, rows in out.items():
            fig = plot_eval_curves(rows, show=False)
            path = (args.figure if args.family != "all" else f"{stem}_{fam}{ext or '.png'}")
            fig.savefig(path, dpi=90)
            print("wrote", path, file=sys.stderr)
    print(json.dumps(payload, indent=1))
    return 0


def _serve(args) -> int:
    from .service import load_service_config
    from .service.runner import serve

    cfg = load_service_config(args.config)
    if args.port is not None:
        cfg.port = args.port
    if args.outdir is not None:
        cfg.outdir = args.outdir
    if args.no_resume:
        cfg.resume = False
    if args.trace:
        cfg.trace = True
    results = serve(cfg, until_idle=args.until_idle)
    n_failed = 0
    for name, res in results.items():
        n_failed += res.n_failed
        print(f"serve: tenant {name}: {res.n_done} done, {res.n_failed} failed, "
              f"{res.n_skipped} skipped, {res.n_quarantined} quarantined, "
              f"{res.n_timeout} timeout -> {res.outdir}")
    return 0 if n_failed == 0 else 3


def _longrecord(args) -> int:
    import numpy as np

    from .io.interrogators import get_acquisition_parameters
    from .utils.artifacts import atomic_file, atomic_json
    from .utils.device import resolve_device
    from .workflows.longrecord import detect_long_record

    dev = resolve_device(args.device)
    meta = get_acquisition_parameters(args.files[0], args.interrogator)
    sel = ([int(v) for v in args.channels.split(",")] if args.channels else [0, meta.nx, 1])
    # --fused goes through unconditionally: the workflow itself rejects it
    # where it does not apply, so the flag is never dropped silently
    fam_kw = None
    if args.family == "learned":
        if not args.model:
            print("longrecord: --family learned requires --model")
            return 2
        fam_kw = {"model": args.model}
    try:
        res = detect_long_record(
            args.files, sel, meta, family=args.family, halo=args.halo,
            fused_bandpass=args.fused, max_peaks_per_channel=args.max_peaks,
            interrogator=args.interrogator, family_kwargs=fam_kw, device=dev,
        )
    except NotImplementedError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    os.makedirs(args.outdir, exist_ok=True)
    with atomic_file(os.path.join(args.outdir, "picks.npz"), "wb") as fh:
        np.savez(fh, **{f"picks_{k}": v for k, v in res.picks.items()},
                 **{f"times_s_{k}": v for k, v in res.pick_times_s.items()})
    summary = {
        "files": list(args.files), "family": args.family,
        "n_files": res.n_files, "n_samples": res.n_samples,
        "t0_utc": str(res.t0_utc),
        "thresholds": res.thresholds,
        "n_picks": {k: int(v.shape[1]) for k, v in res.picks.items()},
    }
    atomic_json(os.path.join(args.outdir, "summary.json"), summary, indent=1)
    for name, pk in res.picks.items():
        span = (f" [{res.pick_times_s[name].min():.1f}, "
                f"{res.pick_times_s[name].max():.1f}] s" if pk.shape[1] else "")
        print(f"longrecord: {name}: {pk.shape[1]} picks{span}")
    print(f"longrecord: {res.n_files} files as one "
          f"{res.n_samples / meta.fs:.0f} s record -> {args.outdir}")
    return 0


def _campaign(args) -> int:
    from .io.interrogators import get_acquisition_parameters
    from .utils.device import resolve_device
    from .workflows.campaign import CampaignAborted, run_campaign

    if args.sharded or args.multihost:
        flag = "--sharded" if args.sharded else "--multihost"
        print(f"error: {not_in_slice(f'campaign {flag}', 'Multi-GPU')}", file=sys.stderr)
        return 2
    if _no_matplotlib("campaign (its density.png)"):
        return 2
    dev = resolve_device(args.device)
    # ONE probe pass: the first probeable file supplies the default channel
    # selection; a corrupt head of the list must not crash the
    # fault-tolerant runner before it starts
    meta0 = None
    for path in args.files:
        try:
            meta0 = get_acquisition_parameters(path, args.interrogator)
            break
        except Exception:  # noqa: BLE001 — run_campaign records it
            continue
    if args.channels:
        sel = [int(v) for v in args.channels.split(",")]
    elif meta0 is not None:
        sel = [0, meta0.nx, 1]
    else:
        print("campaign: no file in the list is probeable; nothing to do")
        return 3
    if args.bank and args.family != "mf":
        print("campaign: --bank applies to the single-chip/batched mf family (the bank "
              "axis rides the one-program route)")
        return 2
    kwargs = {"fused_bandpass": args.fused}
    if args.family == "learned":
        if not args.model:
            print("campaign: --family learned requires --model "
                  "(train with models.learned.fit + save_params)")
            return 2
        from .models import learned as _learned

        params, lcfg = _learned.load_params(args.model)
        kwargs = {"params": params, "cfg": lcfg}
    elif args.family != "mf" and meta0 is None:
        print("campaign: no file in the list is probeable; nothing to do")
        return 3
    if args.bank:
        kwargs["templates"] = args.bank
    try:
        res = run_campaign(
            args.files, sel, args.outdir, family=args.family,
            resume=not args.no_resume, max_failures=args.max_failures,
            interrogator=args.interrogator, trace=args.trace, device=dev, **kwargs,
        )
    except CampaignAborted as exc:
        print(f"campaign aborted: {exc} (progress kept in {args.outdir})")
        return 4
    print(f"campaign: {res.n_done} done, {res.n_failed} failed, "
          f"{res.n_skipped} skipped -> {res.outdir}")
    if res.n_done:
        from .utils.artifacts import atomic_json
        from .workflows.campaign import plot_campaign_density, summarize_campaign

        summary = summarize_campaign(args.outdir)
        fig = plot_campaign_density(summary)
        fig.savefig(os.path.join(args.outdir, "density.png"), dpi=120)
        slim = {k: v for k, v in summary.items() if k != "density"}
        atomic_json(os.path.join(args.outdir, "summary.json"), slim, indent=1)
        print(f"campaign: report -> {args.outdir}/summary.json, density.png")
    return 0 if res.n_failed == 0 else 3


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.workflow == "list":
        for name, help_text in WORKFLOWS.items():
            print(f"{name:15s} {help_text}")
        return 0
    if args.workflow == "fsck":
        # host-only verify/repair: no device, so a corrupt outdir can be
        # inspected from anywhere
        import json

        from .fsck import fsck_outdir, render_findings

        findings = fsck_outdir(args.outdir, repair=args.repair)
        if args.as_json:
            print(json.dumps([f.as_dict() for f in findings], indent=1))
        else:
            print(render_findings(findings))
        return 1 if any(not f.repaired for f in findings) else 0
    if args.workflow == "fleet":
        print(f"error: {not_in_slice('the fleet verb', 'Service and fleet')}",
              file=sys.stderr)
        return 2
    if args.workflow == "evaluate":
        return _evaluate(args)
    if args.workflow == "serve":
        return _serve(args)
    if args.workflow == "longrecord":
        return _longrecord(args)
    if args.workflow == "campaign":
        return _campaign(args)
    if _no_matplotlib(f"{args.workflow} (its figures in --outdir)"):
        return 2
    mod = importlib.import_module(f"das4whales_tpu_torch.workflows.{args.workflow}")
    kwargs = dict(url=args.url, outdir=args.outdir, show=args.show,
                  interrogator=args.interrogator, device=args.device)
    if getattr(args, "no_snr", False):
        kwargs["with_snr"] = False
    result = mod.main(**kwargs)
    if isinstance(result, dict) and "picks" in result:
        for name, pk in result["picks"].items():
            print(f"{args.workflow}: template {name}: {pk.shape[1]} picks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
