"""Rank processes for the port's mesh tests (``tests/test_torch_mesh.py``,
``test_torch_parallel_mf.py``, ``test_torch_timeshard.py``,
``test_torch_campaign_sharded.py``, ``test_torch_spectro_sharded.py``,
``test_torch_gabor_sharded.py``, ``test_torch_learned_sharded.py``,
``test_torch_longrecord_families.py``).

:func:`run_pool` starts ``world`` fresh interpreters (``python
torch_mesh_worker.py <spec> <rank>``: a spawn, never a fork of the test
process, whose JAX threads would deadlock a fork). Each rank forms a gloo
process group through a file rendezvous under the test's temporary
directory (TCP ports would collide across pytest-xdist workers), pins
one intra-op thread, runs every case of the spec in order on CPU meshes
and pickles ``{case name: result}``. A case returns host numpy: the
global arrays gathered from every rank's slice (``parallel.mesh``). The
worker imports only the port; the tests hold its results against the
JAX package's on a mesh of the same shape.

Usage::

    python torch_mesh_worker.py <spec.pkl> <rank>
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_pool(cases: list, world: int, tmp, timeout_s: float = 60.0,
             wait_s: float = 240.0, expect_rc=None) -> list:
    """Run ``cases`` on ``world`` ranks; returns each rank's ``{name:
    result}``. A rank that fails (or exceeds ``wait_s``) raises with its
    log, unless ``expect_rc`` names its exit code."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    spec = os.path.join(tmp, "spec.pkl")
    with open(spec, "wb") as fh:
        pickle.dump({"world": world, "init": f"file://{tmp}/rendezvous",
                     "timeout_s": timeout_s, "cases": cases, "out": tmp}, fh)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), spec, str(r)],
                                      stdout=log, stderr=subprocess.STDOUT, env=env, cwd=tmp))
    deadline = time.monotonic() + wait_s
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = []
    for r, rc in enumerate(rcs):
        want = (expect_rc or {}).get(r, 0)
        if rc != want:
            text = open(os.path.join(tmp, f"rank{r}.log")).read()[-6000:]
            raise RuntimeError(f"rank {r} exited {rc} (expected {want}); its log "
                               f"{tmp}/rank{r}.log:\n{text}")
        path = os.path.join(tmp, f"rank{r}.pkl")
        out.append(pickle.load(open(path, "rb")) if os.path.exists(path) else {})
    return out


# ---------------------------------------------------------------------------
# cases (run in the rank processes)
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _gather(x, mesh, spec):
    from das4whales_tpu_torch.parallel.mesh import Sharding

    return _np(Sharding(mesh, tuple(spec)).gather(x))


def _gather_picks(sp, mesh, row_spec):
    """A ``SparsePicks``' fields gathered: slots ``row_spec + (None,)``,
    ``saturated`` ``row_spec``."""
    out = {f: _gather(getattr(sp, f).contiguous(), mesh, tuple(row_spec) + (None,))
           for f in ("positions", "heights", "prominences", "selected")}
    out["saturated"] = _gather(sp.saturated.contiguous(), mesh, tuple(row_spec))
    return out


def case_collectives(mesh, x, combos):
    import torch

    from das4whales_tpu_torch.parallel import collectives as coll
    from das4whales_tpu_torch.parallel.mesh import Sharding

    sh = Sharding(mesh, ("channel", None, None))
    local = sh.place(x)
    p = mesh.axis_size("channel")
    out = {}
    for s, c in combos:
        out[f"a2a_{s}_{c}"] = _gather(coll.all_to_all(local, mesh, "channel", s, c), mesh,
                                      ("channel", None, None))
    z = torch.complex(local, 2.0 * local)
    out["a2a_complex"] = _gather(coll.all_to_all(z, mesh, "channel", 2, 1), mesh,
                                 ("channel", None, None))
    shift = [(i, (i + 1) % p) for i in range(p)]
    out["ppermute"] = _gather(coll.ppermute(local, mesh, "channel", shift), mesh,
                              ("channel", None, None))
    out["ppermute_open"] = _gather(
        coll.ppermute(local, mesh, "channel", [(i, i + 1) for i in range(p - 1)]), mesh,
        ("channel", None, None))
    out["psum"] = _np(coll.psum(local, mesh, "channel"))
    out["pmax"] = _np(coll.pmax(local, mesh, "channel"))
    out["pmin"] = _np(coll.pmin(local, mesh, "channel"))
    out["axis_index"] = coll.axis_index(mesh, "channel")
    out["stats"] = coll.read_stats()
    return out


def case_fk(mesh, trace, mask):
    from das4whales_tpu_torch.parallel import fft as pfft
    from das4whales_tpu_torch.parallel.mesh import gather_block, shard_block

    local = shard_block(trace, mesh)
    out = {"fk": _np(gather_block(pfft.sharded_fk_apply(local, mask, mesh), mesh))}
    out["pfft2"] = _gather(pfft.pfft2(local, mesh), mesh, (None, "channel"))
    return out


def _design(d):
    from das4whales_tpu_torch.convert import design_from_arrays

    return design_from_arrays(d)


def case_mf_step(mesh, design, batch, kw):
    from das4whales_tpu_torch.parallel.pipeline import input_sharding, make_sharded_mf_step

    step = make_sharded_mf_step(_design(design), mesh, **kw)
    res = step(input_sharding(mesh).place(batch))
    scope = step.threshold_scope
    thr_spec = (None, "file") if scope == "per_template" else ("file",)
    picks, thres = res[-2:]
    out = {"thres": _gather(thres.contiguous(), mesh, thr_spec)}
    if kw.get("pick_mode", "sparse") == "sparse":
        out["picks"] = _gather_picks(picks, mesh, (None, "file", "channel"))
    else:
        out["mask"] = _gather(picks.contiguous(), mesh, (None, "file", "channel", None))
    if kw.get("outputs", "full") == "full":
        out["trf_fk"] = _gather(res[0], mesh, ("file", "channel", None))
        out["corr"] = _gather(res[1], mesh, (None, "file", "channel", None))
        out["env"] = _gather(res[2], mesh, (None, "file", "channel", None))
    return out


def case_adaptive(mesh, design, batch, kw, saturate_rank=None):
    """The campaigns' adaptive pair; ``saturate_rank`` flags every row of
    that rank's K0 result saturated (the others keep theirs)."""
    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel.pipeline import input_sharding, make_sharded_mf_step
    from das4whales_tpu_torch.workflows import campaign

    calls = {"full": 0}

    def factory(*a, **k):
        step = make_sharded_mf_step(*a, **k)
        if k.get("pick_method") != "topk":
            if saturate_rank is None or mesh.rank != saturate_rank:
                return step

            def flagged(x):
                sp, thres = step(x)
                return sp._replace(saturated=sp.saturated | True), thres
            return flagged

        def counted(x):
            calls["full"] += 1
            return step(x)
        return counted

    k0, full = campaign._adaptive_sharded_steps(factory, _design(design), mesh, **kw)
    x = input_sharding(mesh).place(batch)
    sat_k0 = bool(k0(x)[0].saturated.any())
    sp, thres, esc = campaign._run_adaptive(k0, full, x, mesh)
    return {"sat_k0": sat_k0, "escalated": esc, "full_calls": calls["full"],
            "picks": _gather_picks(sp, mesh, (None, "file", "channel")),
            "thres": _gather(thres.contiguous(), mesh, ("file",)),
            "launches": int(getattr(fused_picks, "launches", 0))}


def case_halo(mesh, x, fs, band, halo):
    from das4whales_tpu_torch.parallel import timeshard

    sh = timeshard.time_sharding(mesh)
    y = timeshard.sharded_bp_filt_time(sh.place(x), mesh, fs, band[0], band[1], halo=halo)
    return {"bp": _gather(y, mesh, (None, "time"))}


def case_fk_time(mesh, trace, mask):
    from das4whales_tpu_torch.parallel import timeshard

    sh = timeshard.time_sharding(mesh)
    return {"fk": _gather(timeshard.sharded_fk_apply_time(sh.place(trace), mask, mesh), mesh,
                          (None, "time"))}


def case_mf_step_time(mesh, design, record, kw):
    from das4whales_tpu_torch.parallel import timeshard

    step = timeshard.make_sharded_mf_step_time(_design(design), mesh, **kw)
    res = step(timeshard.time_sharding(mesh).place(record))
    picks, thres = res[-2:]
    out = {"thres": _np(thres), "picks": _gather_picks(picks, mesh, (None, "time"))}
    if kw.get("outputs", "full") == "full":
        out["trf_fk"] = _gather(res[0], mesh, (None, "time"))
        out["corr"] = _gather(res[1], mesh, (None, "time", None))
        out["env"] = _gather(res[2], mesh, (None, "time", None))
    return out


def case_longrecord(mesh, files, sel, kw):
    from das4whales_tpu_torch.workflows.longrecord import detect_long_record

    if "design" in kw:
        kw = dict(kw, design=_design(kw["design"]))
    if "model" in kw:       # the learned family: JAX's parameter pytree
        from das4whales_tpu_torch.models import learned

        kw = dict(kw, family_kwargs={"params": kw.pop("model"), "cfg": learned.LearnedConfig()})
    res = detect_long_record(files, sel, mesh=mesh, **kw)
    return {"picks": res.picks, "thresholds": res.thresholds, "n_samples": res.n_samples,
            "t0": str(res.t0_utc)}


def _records(res):
    import dataclasses

    return [dataclasses.asdict(r) for r in res.records]


def case_campaign_sharded(mesh, files, sel, outdir, kw):
    """``kw["design"]``: a checkpoint path, as ``design=`` takes it."""
    from das4whales_tpu_torch.workflows.campaign import run_campaign_sharded

    first = run_campaign_sharded(files, sel, outdir, mesh, **kw)
    again = run_campaign_sharded(files, sel, outdir, mesh, **kw)
    return {"records": _records(first), "resume": _records(again)}


def case_campaign_multiprocess(mesh, files, sel, outdir, kw):
    from das4whales_tpu_torch.workflows.campaign import run_campaign_multiprocess

    res = run_campaign_multiprocess(files, sel, outdir, device="cpu", **kw)
    return {"records": _records(res), "world_mesh": True}


def case_stream(mesh, files, sel, batch, tail):
    import warnings

    from das4whales_tpu_torch.io.stream import stream_file_batches

    out = []
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        for stack, blocks in stream_file_batches(files, sel, batch=batch, mesh=mesh,
                                                 tail=tail):
            out.append((_gather(stack, mesh, ("file", "channel", None)), len(blocks)))
    return {"batches": out}


def case_ladder(mesh, shape):
    from das4whales_tpu_torch.workflows.planner import DownshiftLadder

    lad = DownshiftLadder(None, "", batch=1, stages=("file", "tiled", "timeshard", "host"))
    return {"rungs": lad.rungs(trace_shape=shape)}


def case_cli(mesh, argv):
    from das4whales_tpu_torch.__main__ import main

    return {"rc": main(argv)}


def _meta(m):
    from das4whales_tpu_torch.config import AcquisitionMetadata

    return AcquisitionMetadata(**m)


def case_spectro_step(mesh, meta, batch, kw):
    """The channel-sharded spectro step on a (file, channel) mesh."""
    from das4whales_tpu_torch.parallel.pipeline import input_sharding
    from das4whales_tpu_torch.parallel.spectro import make_sharded_spectro_step

    step, names = make_sharded_spectro_step(_meta(meta), mesh, **kw)
    res = step(input_sharding(mesh).place(batch))
    picks = res if kw.get("outputs") == "picks" else res[1]
    out = {"names": names, "picks": _gather_picks(picks, mesh, (None, "file", "channel"))}
    if kw.get("outputs", "full") == "full":
        out["corr"] = _gather(res[0], mesh, (None, "file", "channel", None))
    return out


def case_spectro_step_time(mesh, meta, record, kw):
    from das4whales_tpu_torch.parallel.spectro import make_sharded_spectro_step_time
    from das4whales_tpu_torch.parallel.timeshard import time_sharding

    step, names = make_sharded_spectro_step_time(_meta(meta), mesh, **kw)
    res = step(time_sharding(mesh).place(record))
    picks = res if kw.get("outputs") == "picks" else res[1]
    out = {"names": names, "picks": _gather_picks(picks, mesh, (None, "time"))}
    if kw.get("outputs", "full") == "full":
        out["corr"] = _gather(res[0], mesh, (None, "time", None))
    return out


def _gabor_kw(kw):
    from das4whales_tpu_torch import convert

    kw = dict(kw)
    fields = kw.pop("fields", None)
    if fields is not None:
        kw.update(design=convert.gabor_design_from_arrays(fields), note_arrays=fields["notes"])
    return kw


def case_gabor_step(mesh, meta, sel, batch, kw):
    from das4whales_tpu_torch.parallel.gabor import gabor_input_sharding, make_sharded_gabor_step

    step, names = make_sharded_gabor_step(_meta(meta), sel, mesh, **_gabor_kw(kw))
    corr, picks, thres = step(gabor_input_sharding(mesh).place(batch))
    return {"names": names, "corr": _gather(corr, mesh, (None, "file", None, None)),
            "picks": _gather_picks(picks, mesh, (None, "file", None)),
            "thres": _gather(thres, mesh, ("file",))}


def case_gabor_step_time(mesh, meta, sel, record, kw):
    from das4whales_tpu_torch.parallel.gabor import make_sharded_gabor_step_time
    from das4whales_tpu_torch.parallel.timeshard import time_sharding

    step, names = make_sharded_gabor_step_time(_meta(meta), sel, mesh, **_gabor_kw(kw))
    res = step(time_sharding(mesh).place(record))
    out = {"names": names, "thres": _np(res[-1]),
           "picks": _gather_picks(res[-2], mesh, (None, "time"))}
    if kw.get("outputs", "full") == "full":
        out["corr"] = _gather(res[0], mesh, (None, "time", None))
    return out


def _params(model):
    from das4whales_tpu_torch import convert

    return convert.learned_params_to_arrays(model)


def case_learned_train(mesh, x, y, steps, rows, seed):
    """``steps`` data-parallel AdamW steps of ``rows`` windows each."""
    from das4whales_tpu_torch.models import learned

    cfg = learned.LearnedConfig()
    model, opt = learned.init_train_state(cfg, seed=seed, device="cpu")
    step, put = learned.make_sharded_train_step(mesh)
    losses = []
    for s in range(steps):
        wb, lb = put(x[rows * s:rows * (s + 1)], y[rows * s:rows * (s + 1)])
        model, opt, loss = step(model, opt, wb, lb)
        losses.append(float(loss))
    return {"losses": losses, "params": _params(model), "local_rows": int(wb.shape[0])}


def case_learned_fit(mesh, scenes, kw):
    from das4whales_tpu_torch.io.synth import SyntheticCall, SyntheticScene
    from das4whales_tpu_torch.models import learned

    sc = [SyntheticScene(**dict(d, calls=[SyntheticCall(**c) for c in d["calls"]]))
          for d in scenes]
    model, hist = learned.fit(learned.LearnedConfig(), sc, mesh=mesh, **kw)
    return {"history": hist, "params": _params(model)}


def case_learned_inference(mesh, params, block):
    from das4whales_tpu_torch.models import learned
    from das4whales_tpu_torch.parallel.mesh import gather_block

    score_fn, put = learned.make_sharded_inference(params, learned.LearnedConfig(), mesh)
    return {"scores": _np(gather_block(score_fn(put(block)), mesh))}


def case_campaign_elastic(mesh, files, sel, outdir, kw, fail_at, victim=None,
                          raiser=None, deadline_s=3.0):
    """``run_campaign_sharded(elastic=True)`` with a failure at batch
    ``fail_at`` (1-based): ``victim`` set, that rank dies there
    (``os._exit(3)``, results unwritten) and its peers' next collective
    fails; None, rank ``raiser`` (None: every rank) raises an injected
    non-loss ``RuntimeError`` there, and a peer that did not waits in its
    next collective until the group's timeout. The survivor check-in
    waits that timeout plus ``deadline_s``. Returns the records and
    manifest events, or the error a rank re-raised."""
    from das4whales_tpu_torch.workflows import campaign

    campaign._DEVICE_PROBE_DEADLINE_S = deadline_s
    orig = campaign._run_adaptive
    calls = {"n": 0}

    def injected(*a, **k):
        calls["n"] += 1
        if calls["n"] == fail_at:
            if victim is None and raiser in (None, mesh.rank):
                raise RuntimeError("injected step failure on a healthy mesh")
            if mesh.rank == victim:
                sys.stdout.flush()
                os._exit(3)
        return orig(*a, **k)

    campaign._run_adaptive = injected
    try:
        res = campaign.run_campaign_sharded(files, sel, outdir, mesh, **kw)
    except RuntimeError as exc:
        return {"error": str(exc)}
    finally:
        campaign._run_adaptive = orig
    return {"records": _records(res), "events": [
        r for r in _manifest_lines(outdir) if "event" in r and "path" not in r]}


def _manifest_lines(outdir):
    from das4whales_tpu_torch.utils import artifacts

    return artifacts.read_records(os.path.join(outdir, "manifest.jsonl"))


def case_kill(mesh, victim):
    """The last case of a pool: ``victim`` has exited (``main``, after
    writing its results); this rank's next collective must fail."""
    import torch

    from das4whales_tpu_torch.parallel import collectives as coll

    t0 = time.monotonic()
    try:
        coll.psum(torch.ones(4), mesh, None)
        err = ""
    except RuntimeError as exc:
        err = str(exc)
    return {"error": err, "seconds": time.monotonic() - t0}


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def main(argv) -> int:
    spec = pickle.load(open(argv[0], "rb"))
    rank = int(argv[1])
    import torch

    torch.set_num_threads(1)
    from das4whales_tpu_torch.parallel import distributed
    from das4whales_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(spec["init"], spec["world"], rank, backend="gloo",
                           timeout_s=spec["timeout_s"])
    meshes, results = {}, {}
    for case in spec["cases"]:
        if case.get("fresh_group"):
            # a case that may leave the group broken (a collective timed out)
            # gets one of its own, through a rendezvous of its own
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            distributed.initialize(f"{spec['init']}.{case['name']}", spec["world"], rank,
                                   backend="gloo", timeout_s=spec["timeout_s"])
            meshes.clear()
        key = (tuple(case.get("shape", (spec["world"],))),
               tuple(case.get("axis_names", ("channel",))))
        if key not in meshes:
            meshes[key] = make_mesh(key[0], key[1], devices=["cpu"] * spec["world"])
        if case["fn"] == "kill" and rank == case["args"]["victim"]:
            # the victim dies before the collective, its results kept
            _dump(spec, rank, results)
            os._exit(3)
        try:
            results[case["name"]] = CASES[case["fn"]](meshes[key], **case.get("args", {}))
        except Exception:  # noqa: BLE001 — the test reads the traceback from the log
            traceback.print_exc()
            sys.stdout.flush()
            os._exit(2)     # the peers fail on their next collective
        # kept case by case: a rank that dies in a later case (an elastic
        # drill's victim) keeps its earlier results
        _dump(spec, rank, results)
    import torch.distributed as dist

    # a killed peer leaves the group unusable; an elastic rebuild may have
    # replaced it by a mesh of one, with no group at all
    if not any(c["fn"] == "kill" for c in spec["cases"]) and dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _dump(spec, rank: int, results: dict) -> None:
    with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(results, fh)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
