"""Subprocess fleet driver for the port's kill matrix (tests/test_torch_fleet.py).

Runs a whole fleet — supervisor + router + N ``python -m
das4whales_tpu_torch serve`` worker subprocesses — from a JSON fleet
registry, prints one JSON status line (router URL) to stdout once the
fleet is up, then blocks until every tenant's file list is
manifest-settled fleet-wide.

The parent kills THIS process with SIGKILL to exercise supervisor death:
the worker subprocesses survive as orphans, and the next driver run over
the same root must fence them through the replayed ledger before
respawning (the crash-only supervisor contract).

It imports only das4whales_tpu_torch; the worker subprocesses inherit
the environment (the parent pins them to one intra-op thread) and read
their device from the registry's ``device`` key.

Usage::

    python torch_fleet_worker.py <fleet-config.json> [settle_timeout_s]
"""

import json
import sys


def main(argv):
    from das4whales_tpu_torch.fleet import FleetRouter, FleetSupervisor, load_fleet_config

    cfg = load_fleet_config(argv[0])
    timeout_s = float(argv[1]) if len(argv) > 1 else 600.0
    sup = FleetSupervisor(cfg).start()
    router = FleetRouter(sup, host=cfg.host, port=cfg.port).start()
    print(json.dumps({"router": router.url, "status": sup.status()}), flush=True)
    try:
        ok = sup.wait_until_settled(timeout_s=timeout_s)
    finally:
        router.stop()
        sup.stop()
    print(json.dumps({"settled": ok}), flush=True)
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
