"""Port parity, the durable-write layer: ``utils.artifacts``, ``fsck`` and
``utils.checkpoint`` of das4whales_tpu_torch against das4whales_tpu's.

What either package writes the other reads: ``atomic_json`` exports and
manifest lines (``append_record`` / ``format_record``, with and without
the CRC suffix) are byte-identical; both ledger scanners and both
``fsck_outdir`` agree on torn and corrupt ledgers (and repair them to
the same bytes); a design checkpoint round-trips between the packages
field for field.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from das4whales_tpu import crashpoints as jcrash
from das4whales_tpu import fsck as jfsck
from das4whales_tpu.io.synth import SyntheticScene
from das4whales_tpu.models.matched_filter import design_matched_filter as jdesign
from das4whales_tpu.utils import artifacts as jart
from das4whales_tpu.utils import checkpoint as jckpt
from das4whales_tpu_torch import crashpoints as tcrash
from das4whales_tpu_torch import fsck as tfsck
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDesign
from das4whales_tpu_torch.models.matched_filter import design_matched_filter as tdesign
from das4whales_tpu_torch.utils import artifacts as tart
from das4whales_tpu_torch.utils import checkpoint as tckpt
from tests.torch_threads import one_torch_thread  # noqa: F401

RECORDS = [
    {"path": "/data/a.h5", "status": "done", "n_picks": {"HF": 3, "LF": 0}, "wall_s": 0.125,
     "error": "", "picks_file": "/out/picks/a-0123abcd.npz", "attempts": 1,
     "health": {"rms": 1.5e-09, "nonfinite": 0, "bin_rms": [1e-9, 2.5e-9]},
     "family": "mf", "rung": "batched:4"},
    {"path": "/data/ü b.h5", "status": "failed", "error": "OSError: tab\there \"quoted\"",
     "attempts": 3, "family": "mf", "rung": ""},
    {"event": "downshift", "bucket": [64, 1024, "float32"], "from": "batched:4",
     "to": "batched:2", "sticky": True, "nan": float("nan")},
]


@pytest.mark.parametrize("crc", [False, True])
def test_ledger_lines_byte_identical(tmp_path, crc):
    for rec in RECORDS:
        assert tart.format_record(rec, crc=crc) == jart.format_record(rec, crc=crc)
        tart.append_record(str(tmp_path / "port.jsonl"), rec, crc=crc)
        jart.append_record(str(tmp_path / "jax.jsonl"), rec, crc=crc)
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    # each package's reader reads the other's ledger
    want = jart.read_records(str(tmp_path / "jax.jsonl"))
    got = tart.read_records(str(tmp_path / "jax.jsonl"))
    assert [r.get("path") for r in got] == [r.get("path") for r in want]
    assert len(got) == len(RECORDS)


@pytest.mark.parametrize("indent", [None, 2])
def test_atomic_json_byte_identical(tmp_path, indent):
    payload = {"traceEvents": [{"name": "slab", "ts": 1.5, "args": {"n": 2}}], "x": [1, 2.0]}
    tart.atomic_json(str(tmp_path / "port.json"), payload, indent=indent)
    jart.atomic_json(str(tmp_path / "jax.json"), payload, indent=indent)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert not [p for p in os.listdir(tmp_path) if tart.TMP_MARKER in p]


def _damaged_outdir(root, kind):
    """A campaign outdir whose manifest is torn, corrupt (a bad CRC and
    an unparseable interior line), or carries an orphan tmp, a missing
    and an unreferenced artifact."""
    d = root / kind
    (d / "picks").mkdir(parents=True)
    np.savez(d / "picks" / "a.npz", picks_HF=np.zeros((2, 0), np.int64),
             thresholds=np.zeros(1), template_names=np.asarray(["HF"]))
    man = d / "manifest.jsonl"
    recs = [dict(RECORDS[0], picks_file=str(d / "picks" / "a.npz")),
            dict(RECORDS[0], path="/data/c.h5", picks_file=str(d / "picks" / "gone.npz"))]
    for rec in recs:
        jart.append_record(str(man), rec, crc=True)
    if kind == "torn":
        with open(man, "ab") as fh:
            fh.write(b'{"path": "/data/d.h5", "sta')
    elif kind == "corrupt":
        lines = man.read_bytes().splitlines(keepends=True)
        lines.insert(1, b'{"path": "/data/x.h5", "status": "done"}\t#crc32:00000000\n')
        lines.insert(1, b"not json at all\n")
        man.write_bytes(b"".join(lines))
    else:
        (d / "picks" / "orphan.npz.tmp-4242").write_bytes(b"x")
        np.savez(d / "picks" / "stray.npz", a=np.zeros(1))
        (d / "trace.json").write_text('{"traceEvents": [')
    return d


@pytest.mark.parametrize("kind", ["torn", "corrupt", "residue"])
def test_scan_and_fsck_agree_with_jax(tmp_path, kind):
    d = _damaged_outdir(tmp_path / "src", kind)
    man = str(d / "manifest.jsonl")
    js, ts = jart.scan_ledger(man), tart.scan_ledger(man)
    assert (js.size, js.torn_tail, js.bad, [g[:2] for g in js.good]) == \
        (ts.size, ts.torn_tail, ts.bad, [g[:2] for g in ts.good])
    jfind = [f.as_dict() for f in jfsck.fsck_outdir(str(d))]
    tfind = [f.as_dict() for f in tfsck.fsck_outdir(str(d))]
    assert jfind == tfind and jfind
    assert tfsck.render_findings(tfsck.fsck_outdir(str(d))) == \
        jfsck.render_findings(jfsck.fsck_outdir(str(d)))
    # repair in two copies: the same bytes and the same findings after
    copies = {}
    for name, mod in (("jax", jfsck), ("port", tfsck)):
        c = tmp_path / name
        shutil.copytree(d, c)
        # the copied records name the source tree's artifacts: retarget
        text = (c / "manifest.jsonl").read_bytes().replace(str(d).encode(), str(c).encode())
        (c / "manifest.jsonl").write_bytes(text)
        mod.fsck_outdir(str(c), repair=True)
        copies[name] = c
    for rel in ("manifest.jsonl", "manifest.corrupt.jsonl"):
        a, b = copies["jax"] / rel, copies["port"] / rel
        assert a.exists() == b.exists()
        if a.exists():
            assert a.read_bytes().replace(str(copies["jax"]).encode(), b"") == \
                b.read_bytes().replace(str(copies["port"]).encode(), b"")
    assert sorted(os.listdir(copies["jax"] / "picks")) == sorted(os.listdir(copies["port"] / "picks"))
    assert [f.as_dict() for f in tfsck.fsck_outdir(str(copies["port"]))] == []


def test_startup_check_heals_a_torn_tail_and_refuses_corruption(tmp_path):
    torn = _damaged_outdir(tmp_path, "torn")
    assert tfsck.startup_check(str(torn))["torn_tail"] == 1
    assert jart.scan_ledger(str(torn / "manifest.jsonl")).torn_tail is None
    bad = _damaged_outdir(tmp_path, "corrupt")
    with pytest.raises(RuntimeError, match="corrupt manifest"):
        tfsck.startup_check(str(bad))
    assert tfsck.startup_check(str(bad), auto_repair=True)["corrupt_records"] == 2
    assert tart.scan_ledger(str(bad / "manifest.jsonl")).bad == []


def test_crash_points_match_jax(tmp_path):
    assert tcrash.POINTS == jcrash.POINTS and tcrash.MODES == jcrash.MODES
    tcrash.arm("post-tmp", "enospc")
    try:
        with pytest.raises(tcrash.InjectedDiskFull):
            tart.atomic_json(str(tmp_path / "x.json"), {"a": 1})
    finally:
        tcrash.disarm()
    assert not os.path.exists(tmp_path / "x.json")
    assert tart.sweep_orphan_tmps(str(tmp_path)) == []


def _fields_equal(a, b, names):
    for f in names:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype and np.array_equal(x, np.asarray(y)), f
        else:
            assert tuple(np.atleast_1d(x)) == tuple(np.atleast_1d(y)), f


DESIGN_NAMES = ("fk_mask", "bp_gain", "bp_padlen", "templates", "template_names",
                "trace_shape", "fs", "bp_band", "bp_order", "fk_channels",
                "threshold_factors", "threshold_scope")


def test_design_checkpoints_round_trip_between_packages(tmp_path):
    meta = SyntheticScene(nx=24, ns=900).metadata
    jd = jdesign((24, 900), [0, 24, 1], meta)
    td = tdesign((24, 900), [0, 24, 1], meta)
    # JAX's checkpoint, loaded by the port, is the port's design type
    loaded = tckpt.load_design(jckpt.save_design(str(tmp_path / "jax_design"), jd))
    assert isinstance(loaded, MatchedFilterDesign)
    _fields_equal(jd, loaded, DESIGN_NAMES)
    # the port's checkpoint, loaded by JAX
    back = jckpt.load_design(tckpt.save_design(str(tmp_path / "port_design.npz"), td))
    assert type(back).__name__ == "MatchedFilterDesign"
    _fields_equal(td, back, DESIGN_NAMES)
    # the checkpoint files themselves: the same members
    with np.load(tmp_path / "jax_design.npz") as a, np.load(tmp_path / "port_design.npz") as b:
        assert sorted(a.files) == sorted(b.files)
