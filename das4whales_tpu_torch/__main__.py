"""Command line of the port: ``python -m das4whales_tpu_torch serve
<registry.json>``.

``serve`` runs the streaming multi-tenant detection service
(``das4whales_tpu_torch.service``) with the JAX package's flags and exit
codes: 0, or 3 when a file failed. The registry's ``device`` key (None
or absent: the card) says where the tenants detect.

The JAX package's other verbs (``list``, ``fsck``, ``evaluate``,
``campaign``, ``fleet``, ``longrecord`` and the workflow mains) are not
in this slice: each exits non-zero naming the ROADMAP item 'CLI'.
"""

from __future__ import annotations

import argparse
import sys

from .config import not_in_slice

#: the JAX package's verbs the port's command line does not take yet
OTHER_VERBS = ("list", "fsck", "evaluate", "campaign", "longrecord", "fleet", "mfdetect",
               "spectrodetect", "gabordetect", "fkcomp", "plots", "bathynoise")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="das4whales_tpu_torch",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="workflow", required=True)
    ps = sub.add_parser(
        "serve",
        help="run the streaming multi-tenant detection service: continuous "
             "ingest, fair multi-stream scheduling, and the picks/health HTTP API",
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
    for verb in OTHER_VERBS:
        sub.add_parser(verb, help="not in this slice of the port", add_help=False)
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in OTHER_VERBS:
        print(f"error: {not_in_slice(f'the {argv[0]!r} verb', 'CLI')}", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
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


if __name__ == "__main__":
    sys.exit(main())
