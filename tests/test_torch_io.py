"""Port parity, ingest: the OptaSense HDF5 and Silixa TDMS readers and
writers, interrogator dispatch, the multi-file streams, slab assembly
and the native reader of das4whales_tpu_torch (on the CPU) against
das4whales_tpu's.

Contract: metadata equal; raw counts bitwise; conditioned strain within
rtol 1e-7 (an absolute floor of 1e-7 of the block's peak covers samples
that condition to near zero, where the two packages' float32 means
differ in their last bit); host stacks bitwise.
"""

from __future__ import annotations

import shutil

import jax
import numpy as np
import pytest
import torch

from das4whales_tpu.io import hdf5 as jhdf5
from das4whales_tpu.io import interrogators as jint
from das4whales_tpu.io import stream as jstream
from das4whales_tpu.io import synth as jsynth
from das4whales_tpu.io import tdms as jtdms
from das4whales_tpu_torch.io import hdf5, interrogators, native, stream, synth, tdms
from das4whales_tpu_torch.workflows import common
from tests.torch_threads import one_torch_thread  # noqa: F401

NX, NS = 32, 400
SEL = [2, 30, 2]


@pytest.fixture
def native_engine():
    """Skip where the native engine cannot be built (no g++), as the JAX
    package's native tests do; decided in the test, not at import."""
    if shutil.which("g++") is None or not native.available():
        pytest.skip("native engine unavailable (no g++)")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def file_set(tmp_path_factory):
    """Five OptaSense files, alternately written by the JAX package and by
    the port (int32 counts; the last one float32 with a NaN)."""
    d = tmp_path_factory.mktemp("optasense")
    rng = np.random.default_rng(21)
    paths, raws = [], []
    for k in range(5):
        raw = rng.integers(-20000, 20000, size=(NX, NS)).astype(np.int32)
        writer = jhdf5.write_optasense if k % 2 == 0 else hdf5.write_optasense
        kw = {}
        if k == 4:
            raw = raw.astype(np.float32)
            raw[3, 17] = np.nan
            kw = dict(raw_dtype=np.float32)
        paths.append(writer(str(d / f"file{k}.h5"), raw, fs=200.0, dx=2.0, **kw))
        raws.append(raw)
    return paths, raws


def test_optasense_metadata_both_ways(file_set):
    paths, _ = file_set
    for p in paths:
        a, b = jhdf5.get_metadata_optasense(p), hdf5.get_metadata_optasense(p)
        assert a.to_dict() == b.to_dict() and a.interrogator == b.interrogator
    with pytest.raises(FileNotFoundError):
        hdf5.get_metadata_optasense(paths[0] + ".missing")


@pytest.mark.parametrize("engine", ["h5py", "auto"])
@pytest.mark.parametrize("k", [0, 1])
def test_load_das_data_matches_jax(file_set, engine, k):
    """File 0 written by JAX, file 1 by the port, each read by both."""
    paths, _ = file_set
    meta = jhdf5.get_metadata_optasense(paths[k])
    for wire in ("conditioned", "raw"):
        with jax.enable_x64(False):
            jb = jhdf5.load_das_data(paths[k], SEL, meta, engine=engine, wire=wire)
            want = np.array(jb.trace)
        tb = hdf5.load_das_data(paths[k], SEL, meta, engine=engine, wire=wire, device="cpu")
        assert isinstance(tb.trace, torch.Tensor) and tb.trace.dtype == torch.float32
        _close(tb.trace.numpy(), want)
        np.testing.assert_array_equal(tb.tx, jb.tx)
        np.testing.assert_array_equal(tb.dist, jb.dist)
        assert tb.t0_utc == jb.t0_utc


def test_load_das_data_refusals(file_set):
    paths, _ = file_set
    meta = hdf5.get_metadata_optasense(paths[0])
    with pytest.raises(ValueError, match="unknown engine"):
        hdf5.load_das_data(paths[0], SEL, meta, engine="mmap", device="cpu")
    with pytest.raises(ValueError, match="unknown wire"):
        hdf5.load_das_data(paths[0], SEL, meta, wire="narrow", device="cpu")
    with pytest.raises(FileNotFoundError):
        hdf5.load_das_data(paths[0] + ".missing", SEL, meta, device="cpu")


def test_raw2strain_matches_jax(file_set):
    _, raws = file_set
    with jax.enable_x64(False):
        want = np.array(jhdf5.raw2strain(raws[0], 1e-9))
    got = hdf5.raw2strain(torch.from_numpy(raws[0]), 1e-9)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("engine", ["h5py", "auto"])
@pytest.mark.parametrize("wire", ["conditioned", "raw"])
def test_stream_strain_blocks_matches_jax(file_set, engine, wire):
    paths, raws = file_set
    meta = jint.get_acquisition_parameters(paths[0], "optasense")
    with jax.enable_x64(False):
        want = [(np.array(b.trace), b.wire) for b in jstream.stream_strain_blocks(
            paths[:4], SEL, meta, prefetch=2, engine=engine, wire=wire)]
    got = list(stream.stream_strain_blocks(paths[:4], SEL, meta, prefetch=2, engine=engine,
                                           wire=wire, device="cpu"))
    assert [b.wire for b in got] == [w for _, w in want] == [wire] * 4
    for blk, (w, _), raw in zip(got, want, raws):
        assert isinstance(blk.trace, torch.Tensor)
        if wire == "raw":
            np.testing.assert_array_equal(blk.trace.numpy(), w)       # the stored counts
            np.testing.assert_array_equal(blk.trace.numpy(), raw[SEL[0]:SEL[1]:SEL[2]])
        else:
            _close(blk.trace.numpy(), w)
        assert blk.read_s > 0 and blk.condition_s >= 0


def test_stream_probes_per_file_and_keeps_order(file_set):
    paths, raws = file_set
    got = list(stream.stream_strain_blocks(paths[:4][::-1], [0, NX, 1], None, prefetch=1,
                                           wire="raw", as_numpy=True))
    for blk, raw in zip(got, raws[:4][::-1]):
        np.testing.assert_array_equal(blk.trace, raw)
        assert blk.metadata.fs == 200.0
    assert list(stream.stream_strain_blocks([], [0, 8, 1], as_numpy=True)) == []
    with pytest.raises(ValueError, match="metadata entries"):
        list(stream.stream_strain_blocks(paths, [0, NX, 1], [got[0].metadata] * 2,
                                         as_numpy=True))


def test_stream_refusals(file_set):
    paths, _ = file_set
    # a sharded stream places blocks on its mesh's device: no host arrays
    with pytest.raises(ValueError, match="mesh's device"):
        list(stream.stream_strain_blocks(paths, SEL, as_numpy=True, sharding=object()))
    with pytest.raises(ValueError, match="mesh's device"):
        list(stream.stream_batched_slabs(paths, SEL, batch=2, as_numpy=True, sharding=object()))
    # the reader deadline and the chaos hooks need the threaded reader
    for kw in (dict(read_deadline_s=1.0), dict(fault_plan=object())):
        with pytest.raises(ValueError, match="threaded reader"):
            list(stream.stream_strain_blocks(paths, SEL, as_numpy=True, engine="native", **kw))
    with pytest.raises(ValueError, match="tail='error'"):
        stream.stream_file_batches(paths[:1], SEL, batch=2, tail="error")
    with pytest.raises(ValueError, match="as_numpy"):
        list(stream.stream_batched_slabs(paths, SEL, batch=2, as_numpy=True, device="cpu"))
    with pytest.raises(ValueError):
        list(stream.stream_batched_slabs(paths, SEL, batch=0, as_numpy=True))


@pytest.mark.parametrize("wire", ["conditioned", "raw"])
def test_batched_slabs_match_jax_bitwise(file_set, wire):
    """Five files (the last float32: on the raw wire its dtype changes the
    slab key and flushes a partial slab) in slabs of 2 at pow2 buckets."""
    paths, _ = file_set
    with jax.enable_x64(False):
        want = list(jstream.stream_batched_slabs(paths, SEL, batch=2, bucket="pow2", wire=wire,
                                                 as_numpy=True))
    got = list(stream.stream_batched_slabs(paths, SEL, batch=2, bucket="pow2", wire=wire,
                                           as_numpy=True))
    on_cpu = list(stream.stream_batched_slabs(paths, SEL, batch=2, bucket="pow2", wire=wire,
                                              device="cpu"))
    assert [(s.index0, s.n_valid, s.n_real, s.bucket_ns, s.paths) for s in got] == \
           [(s.index0, s.n_valid, s.n_real, s.bucket_ns, s.paths) for s in want]
    assert [s.n_valid for s in got] == [2, 2, 1]
    for g, w, c in zip(got, want, on_cpu):
        assert g.stack.dtype == w.stack.dtype and g.stack.shape == (2, 14, 1024)
        np.testing.assert_array_equal(g.stack, w.stack)
        np.testing.assert_array_equal(c.stack.numpy(), g.stack)
    for rung in (1, 2):
        for g, w in zip([s for slab in got for s in stream.subdivide_slab(slab, rung)],
                        [s for slab in want for s in jstream.subdivide_slab(slab, rung)]):
            np.testing.assert_array_equal(g.stack, w.stack)
            assert (g.index0, g.paths, g.n_real) == (w.index0, w.paths, w.n_real)


def test_assemble_slab_pads_like_jax(file_set):
    paths, _ = file_set
    blocks = list(stream.stream_strain_blocks(paths[:3], SEL, as_numpy=True))
    jblocks = list(jstream.stream_strain_blocks(paths[:3], SEL, as_numpy=True))
    got = stream.assemble_slab(blocks, paths[:3], 5, 4, 512)
    want = jstream.assemble_slab(jblocks, paths[:3], 5, 4, 512)
    np.testing.assert_array_equal(got.stack, want.stack)
    assert got.n_valid == 3 and got.stack.shape == (4, 14, 512) and not got.stack[3].any()
    with pytest.raises(ValueError):
        stream.assemble_slab(blocks, paths[:3], 0, 2, 512)


@pytest.mark.parametrize("device", ["cpu", None])
def test_slab_read_error_after_the_partial_slab(file_set, tmp_path, device):
    paths, _ = file_set
    bad = list(paths[:4])
    bad[2] = str(tmp_path / "corrupt.h5")
    with open(bad[2], "wb") as fh:
        fh.write(b"not an hdf5 file")
    kw = dict(as_numpy=True) if device is None else dict(device=device)
    for batch, slab_paths in ((2, [(bad[0], bad[1])]), (4, [(bad[0], bad[1])])):
        got, err = [], None
        try:
            for slab in stream.stream_batched_slabs(bad, SEL, batch=batch, bucket="exact", **kw):
                got.append(slab)
        except stream.SlabReadError as exc:
            err = exc
        assert err is not None and err.index == 2 and err.path == bad[2]
        assert [s.paths for s in got] == slab_paths
        assert got[0].n_valid == 2 and got[0].stack.shape[0] == batch


@pytest.mark.parametrize("wire", ["conditioned", "raw"])
def test_stream_native_matches_h5py(file_set, wire, native_engine):
    paths, _ = file_set
    meta = interrogators.get_acquisition_parameters(paths[0], "optasense")
    nat = list(stream.stream_strain_blocks(paths[:4], SEL, meta, engine="native", wire=wire,
                                           device="cpu"))
    ref = list(stream.stream_strain_blocks(paths[:4], SEL, meta, engine="h5py", wire=wire,
                                           device="cpu"))
    for a, b in zip(nat, ref):
        if wire == "raw":
            np.testing.assert_array_equal(a.trace.numpy(), b.trace.numpy())
        else:
            np.testing.assert_allclose(a.trace.numpy(), b.trace.numpy(), rtol=1e-4, atol=1e-16)
    assert native.library_path().parent.name == "native"
    assert native.library_path().parent.parent.name == "build"


def test_native_reader_matches_jax(file_set, native_engine):
    from das4whales_tpu.io import native as jnative

    paths, raws = file_set
    import h5py

    with h5py.File(paths[1], "r") as fp:
        off, dt = native.contiguous_layout(fp["Acquisition/Raw[0]/RawData"])
    args = (paths[1], off, dt, NX, NS, 2, 30, 2)
    np.testing.assert_array_equal(native.read_strided_raw(*args), jnative.read_strided_raw(*args))
    got = native.read_strided(*args, fuse=True, scale=1e-9)
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.read_strided(*args, fuse=True, scale=1e-9))
    block = raws[1].astype(np.float32)
    np.testing.assert_array_equal(native.raw2strain_inplace(block.copy(), 1e-9)[SEL[0]:SEL[1]:SEL[2]],
                                  got)
    with native.Prefetcher(nworkers=2) as pf:
        t = pf.submit(*args, fuse=True, scale=1e-9)
        np.testing.assert_array_equal(pf.wait(t), got)
    chunked = _chunked(paths[1])
    with pytest.raises(ValueError, match="not natively readable"):
        hdf5.load_das_data(chunked, SEL, hdf5.get_metadata_optasense(paths[1]),
                           engine="native", device="cpu")
    with pytest.raises(ValueError, match="not natively readable"):
        list(stream.stream_strain_blocks([chunked], SEL, engine="native", as_numpy=True))


def _chunked(path):
    """A copy of ``path`` whose RawData is chunked (not natively readable)."""
    import h5py

    out = path.replace(".h5", "_chunked.h5")
    with h5py.File(path, "r") as src, h5py.File(out, "w") as dst:
        src.copy("Acquisition", dst)
        del dst["Acquisition/Raw[0]/RawData"]
        data = src["Acquisition/Raw[0]/RawData"][...]
        dst["Acquisition/Raw[0]"].create_dataset("RawData", data=data, chunks=(8, 100))
    return out


# --- TDMS and interrogators -------------------------------------------------

def _scene(nx=12, ns=300):
    return jsynth.SyntheticScene(nx=nx, ns=ns, seed=4, calls=[jsynth.SyntheticCall(t0=0.3, x0_m=6.0)])


def test_tdms_round_trip_both_ways(tmp_path):
    scene = _scene()
    a = jsynth.write_synthetic_tdms(str(tmp_path / "jax.tdms"), scene)
    b = synth.write_synthetic_tdms(str(tmp_path / "port.tdms"), synth.SyntheticScene(
        **{k: getattr(scene, k) for k in ("nx", "ns", "seed")}, calls=[
            synth.SyntheticCall(t0=0.3, x0_m=6.0)]))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()                      # the writers agree byte for byte
    for path in (a, b):
        jf, tf = jtdms.TdmsFile.read(path), tdms.TdmsFile.read(path)
        assert tf.properties == jf.properties
        assert list(tf["Measurement"]) == list(jf["Measurement"])
        for name, v in jf["Measurement"].items():
            np.testing.assert_array_equal(tf["Measurement"][name], v)
        assert tdms.contiguous_layout(path) == jtdms.contiguous_layout(path)
        x, t0 = tdms.read_measurement_block(path, 1, 11, 2)
        jx, jt0 = jtdms.read_measurement_block(path, 1, 11, 2)
        np.testing.assert_array_equal(x, jx)
        assert t0 == jt0
        assert interrogators.get_metadata_silixa(path).to_dict() == \
            jint.get_metadata_silixa(path).to_dict()


def test_silixa_channels_load_in_natural_order(tmp_path):
    rng = np.random.default_rng(5)
    chans = {f"ch{i}": rng.integers(-100, 100, 50).astype(np.int16) for i in (1, 10, 2, 0, 11)}
    path = tdms.write_tdms(str(tmp_path / "natural.tdms"), {
        "SamplingFrequency[Hz]": 200.0, "SpatialResolution[m]": 2.0, "FibreIndex": 1.4681,
        "GaugeLength": 10.0}, "Measurement", chans)
    got = interrogators.load_silixa_data(path)
    np.testing.assert_array_equal(got, jint.load_silixa_data(path))
    np.testing.assert_array_equal(got, np.stack([chans[f"ch{i}"] for i in (0, 1, 2, 10, 11)]))


def test_tdms_stream_matches_jax(tmp_path):
    scene = _scene()
    path = jsynth.write_synthetic_tdms(str(tmp_path / "s.tdms"), scene)
    for wire in ("conditioned", "raw"):
        with jax.enable_x64(False):
            (jb,) = list(jstream.stream_strain_blocks([path], [0, 12, 1], wire=wire,
                                                      as_numpy=True))
        (tb,) = list(stream.stream_strain_blocks([path], [0, 12, 1], wire=wire, as_numpy=True))
        assert tb.metadata.interrogator == "silixa" and tb.t0_utc == jb.t0_utc
        if wire == "raw":
            np.testing.assert_array_equal(tb.trace, np.asarray(jb.trace))
        else:
            _close(tb.trace, np.asarray(jb.trace))


def test_interrogator_dispatch_and_errors(file_set, tmp_path):
    paths, _ = file_set
    assert interrogators.INTERROGATORS == jint.INTERROGATORS
    assert interrogators.get_acquisition_parameters(paths[0]).to_dict() == \
        jint.get_acquisition_parameters(paths[0]).to_dict()
    with pytest.raises(ValueError, match="Interrogator name incorrect"):
        interrogators.get_acquisition_parameters(paths[0], "febus")
    for name in ("mars", "alcatel"):
        with pytest.raises(NotImplementedError, match="get_metadata_generic"):
            interrogators.get_acquisition_parameters(paths[0], name)
    with pytest.raises(FileNotFoundError):
        interrogators.get_metadata_silixa(str(tmp_path / "missing.tdms"))
    schema = {"fs": ("Acquisition/Raw[0]", "OutputDataRate"),
              "dx": ("Acquisition", "SpatialSamplingInterval"),
              "nx": ("Acquisition/Raw[0]", "NumberOfLoci"),
              "ns": 400, "scale_factor": 1e-9}
    assert interrogators.get_metadata_generic(paths[0], schema).to_dict() == \
        jint.get_metadata_generic(paths[0], schema).to_dict()
    assert interrogators.silixa_scale_factor(1000.0, 10.0) == jint.silixa_scale_factor(1000.0, 10.0)


# --- the workflow prologue ---------------------------------------------------

def test_acquire_a_local_file_like_jax(tmp_path):
    scene = jsynth.SyntheticScene(nx=40, ns=600, seed=9, calls=[
        jsynth.SyntheticCall(t0=1.0, x0_m=20.0)])
    path = jsynth.write_synthetic_file(str(tmp_path / "local.h5"), scene)
    from das4whales_tpu.workflows import common as jcommon

    with jax.enable_x64(False):
        jblock, jmeta, jsel = jcommon.acquire(path)
        want = np.array(jblock.trace)
    block, meta, sel = common.acquire(path, device="cpu")
    assert sel == jsel and meta.to_dict() == jmeta.to_dict()
    _close(block.trace.numpy(), want)
    assert common.channels_m_to_idx((20000.0, 65000.0, 5.0), 2.042) == \
        jcommon.channels_m_to_idx((20000.0, 65000.0, 5.0), 2.042)
    js, ts = jcommon.default_scene(), common.default_scene()
    assert (ts.nx, ts.ns, ts.seed, len(ts.calls)) == (js.nx, js.ns, js.seed, len(js.calls))


def test_synthetic_file_equals_jax_bitwise(tmp_path):
    import h5py

    scene = _scene(16, 500)
    a = jsynth.write_synthetic_file(str(tmp_path / "a.h5"), scene)
    b = synth.write_synthetic_file(str(tmp_path / "b.h5"), synth.SyntheticScene(
        nx=16, ns=500, seed=4, calls=[synth.SyntheticCall(t0=0.3, x0_m=6.0)]))
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        np.testing.assert_array_equal(fa["Acquisition/Raw[0]/RawData"][...],
                                      fb["Acquisition/Raw[0]/RawData"][...])
