"""Port parity, the mesh and its collectives: ``parallel.mesh``,
``parallel.collectives`` and the distributed f-k transform
(``parallel.fft``) on gloo CPU ranks against the JAX package's
``shard_map`` collectives and ``parallel.fft`` on a CPU mesh of the same
shape.

The port's side runs once, in a module-scoped pool of two spawned ranks
(``tests/torch_mesh_worker.py``); each test asserts one case of it.
Tolerances: the collectives move data, so they are bitwise; the f-k
output within 1e-5·max of JAX's (float32 FFTs of two libraries) and of
the port's one-device ``ops.fk.fk_filter_apply_rfft``; ``pfft2`` within
1e-5·max of numpy's float64 ``fft2``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from das4whales_tpu.parallel import fft as jfft
from das4whales_tpu.parallel.compat import shard_map
from das4whales_tpu.parallel.mesh import make_mesh as jmake_mesh
from das4whales_tpu_torch.ops import fk as tfk
from das4whales_tpu_torch.parallel import collectives as coll
from das4whales_tpu_torch.parallel import mesh as tmesh
from torch_mesh_worker import run_pool
from tests.torch_threads import one_torch_thread  # noqa: F401

P2 = 2
COMBOS = ((0, 1), (1, 0), (2, 1), (1, 2), (0, 0))
NX, NS = 32, 200
REL = 1e-5


def _inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((P2 * 4, 6, 8)).astype(np.float32)
    trace = rng.standard_normal((NX, NS)).astype(np.float32)
    mask = tfk.hybrid_ninf_filter_design((NX, NS), [0, NX, 1], 8.0, 200.0)
    return x, trace, mask.astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x, trace, mask = _inputs()
    cases = [dict(name="coll", fn="collectives", args=dict(x=x, combos=COMBOS)),
             dict(name="fk", fn="fk", args=dict(trace=trace, mask=mask)),
             dict(name="kill", fn="kill", args=dict(victim=1))]
    return run_pool(cases, P2, tmp_path_factory.mktemp("mesh_pool"), expect_rc={1: 3})


def _jmesh(p=P2):
    return jmake_mesh(shape=(p,), axis_names=("channel",), devices=jax.devices()[:p])


def _jax_body(fn, x, out_spec=P("channel")):
    with jax.enable_x64(False):
        f = jax.jit(shard_map(fn, mesh=_jmesh(), in_specs=(P("channel"),),
                              out_specs=out_spec, check_vma=False))
        return np.array(f(jnp.asarray(x)))


@pytest.mark.parametrize("combo", COMBOS)
def test_all_to_all_matches_jax(ranks, combo):
    x, _, _ = _inputs()
    s, c = combo
    want = _jax_body(lambda v: jax.lax.all_to_all(v, "channel", s, c, tiled=True), x)
    for r in range(P2):
        np.testing.assert_array_equal(ranks[r]["coll"][f"a2a_{s}_{c}"], want)


def test_all_to_all_complex_and_neighbour_exchange_match_jax(ranks):
    x, _, _ = _inputs()
    z = x + 2j * x
    with jax.enable_x64(False):
        want = _jax_body(lambda v: jax.lax.all_to_all(v, "channel", 2, 1, tiled=True),
                         z.astype(np.complex64))
    np.testing.assert_array_equal(ranks[0]["coll"]["a2a_complex"], want)
    shift = [(i, (i + 1) % P2) for i in range(P2)]
    np.testing.assert_array_equal(
        ranks[0]["coll"]["ppermute"], _jax_body(lambda v: jax.lax.ppermute(v, "channel", shift), x))
    opened = [(i, i + 1) for i in range(P2 - 1)]
    np.testing.assert_array_equal(
        ranks[1]["coll"]["ppermute_open"],
        _jax_body(lambda v: jax.lax.ppermute(v, "channel", opened), x))


@pytest.mark.parametrize("op", ["psum", "pmax", "pmin"])
def test_reductions_match_jax(ranks, op):
    x, _, _ = _inputs()
    fn = getattr(jax.lax, op)
    want = _jax_body(lambda v: fn(v, "channel"), x, out_spec=P())
    for r in range(P2):
        np.testing.assert_array_equal(ranks[r]["coll"][op], want)
        assert ranks[r]["coll"]["axis_index"] == r
    st = ranks[0]["coll"]["stats"]
    assert st["all_to_all"]["calls"] == len(COMBOS) + 1 and st["psum"]["bytes"] == 4 * x.size // P2
    assert st["psum"]["staged_bytes"] == 0        # CPU tensors are never staged


def test_sharded_fk_apply_matches_jax_and_one_device(ranks):
    _, trace, mask = _inputs()
    with jax.enable_x64(False):
        want = np.array(jfft.sharded_fk_apply(jnp.asarray(trace), mask, _jmesh()))
    got = ranks[0]["fk"]["fk"]
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    one = tfk.fk_filter_apply_rfft(torch.from_numpy(trace), mask).numpy()
    np.testing.assert_allclose(got, one, rtol=0, atol=REL * np.abs(one).max())
    np.testing.assert_array_equal(ranks[1]["fk"]["fk"], got)


def test_pfft2_matches_fft2_and_jax(ranks):
    _, trace, _ = _inputs()
    want = np.fft.fft2(trace.astype(np.float64))
    got = ranks[0]["fk"]["pfft2"]
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    with jax.enable_x64(False):
        jgot = np.array(jfft.pfft2(jnp.asarray(trace), _jmesh()))
    np.testing.assert_allclose(got, jgot, rtol=0, atol=REL * np.abs(want).max())


def test_make_mesh_validation():
    """JAX's rules, and the backend rule of a shared card; a process that
    was not launched as a rank gets a mesh of one with no process group."""
    with pytest.raises(ValueError, match=r"does not cover 8 devices"):
        tmesh.make_mesh(shape=(3, 3), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match=r"does not cover 8 devices"):
        jmake_mesh(shape=(3, 3), axis_names=("file", "channel"))
    with pytest.raises(ValueError, match="Duplicate GPU detected"):
        tmesh.make_mesh(shape=(1, 2), devices=["cuda:0", "cuda:0"], backend="nccl")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh(shape=(1, 2), devices=["cpu", "cpu"], backend="gloo")
    m = tmesh.make_mesh(devices=["cpu"])
    assert m.shape == {"file": 1, "channel": 1} and m.backend is None and m.group is None
    assert m.size == 1 and m.coords == {"file": 0, "channel": 0}
    x = torch.arange(12.0).reshape(3, 4)
    assert coll.all_to_all(x, m, "channel", 1, 0) is x
    assert coll.psum(x, m, "channel") is x and coll.pmax(x, m, None) is x
    np.testing.assert_array_equal(coll.ppermute(x, m, "channel", [(0, 0)]).numpy(), x.numpy())
    assert not coll.ppermute(x, m, "channel", []).any()
    assert coll.all_gather_object({"a": 1}, m) == [{"a": 1}]
    np.testing.assert_array_equal(tmesh.gather_block(tmesh.shard_block(x.numpy(), m), m).numpy(),
                                  x.numpy())
    sh = tmesh.file_channel_sharding(m)
    assert sh.slices((2, 6, 5)) == (slice(0, 2), slice(0, 6), slice(0, 5))


def test_a_mesh_of_one_defaults_to_the_card(monkeypatch):
    """Without ``devices`` a rank takes its card and never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.make_mesh()


@pytest.mark.parametrize("local_rank, per_host, backend, refused", [
    ("1", "2", "nccl", True),      # torchrun's second rank on a one-card host
    ("0", "2", "nccl", True),      # its first rank refuses too: no rank goes on to hang
    ("1", None, "nccl", True),     # LOCAL_RANK past the cards, no LOCAL_WORLD_SIZE
    ("1", "2", "gloo", False),     # gloo shares the card
    ("0", "1", "nccl", False),     # one rank a card
])
def test_default_devices_refuse_a_shared_card_off_gloo(monkeypatch, local_rank, per_host,
                                                      backend, refused):
    """Without ``devices`` a rank's card is ``LOCAL_RANK``'s; more ranks on
    a host than cards put two on one card, which only gloo takes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", local_rank)
    if per_host is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", per_host)
    if refused:
        with pytest.raises(ValueError, match="Duplicate GPU detected"):
            tmesh._default_device(int(local_rank), backend, 2)
        # make_mesh raises there, before it sets a device or forms a group
        monkeypatch.setattr(tmesh, "_world", lambda group: (True, 2, int(local_rank)))
        with pytest.raises(ValueError, match="backend 'gloo'"):
            tmesh.make_mesh((1, 2), backend=backend)
    else:
        assert tmesh._default_device(int(local_rank), backend, 2) == torch.device("cuda", 0)
    # a world of one never shares: a process not launched as a rank
    assert tmesh._default_device(int(local_rank), None, 1) == torch.device("cuda", 0)


def test_a_one_rank_group_sends_nothing():
    """On a group of one rank (e.g. a one-rank NCCL group) every
    collective is the identity: no process group is touched (none is
    formed in this process) and nothing is counted."""
    m = tmesh.Mesh(("file", "channel"), (1, 1), np.arange(1), 0, torch.device("cpu"),
                   "nccl", {"file": None, "channel": None})
    coll.reset_stats()
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert coll.all_to_all(x, m, "channel", 2, 1) is x
    assert coll.psum(x, m, "channel") is x and coll.pmax(x, m, None) is x
    assert coll.pmin(x, m, "file") is x
    assert coll.ppermute(x, m, "channel", [(0, 0)]) is x
    assert not coll.ppermute(x, m, "channel", []).any()
    assert coll.all_gather(x, m)[0] is x and coll.all_gather_object(5, m) == [5]
    coll.barrier(m)
    assert not coll.read_stats()


def test_initialize_from_env_rules(monkeypatch):
    from das4whales_tpu_torch.parallel import distributed

    for var in distributed.ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_from_env() is False          # no variables: a no-op
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize_from_env() is False          # a world of one
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK is not set"):
        distributed.initialize_from_env()
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.local_device_batch(4) == slice(0, 4)
    assert distributed.global_mesh(devices=["cpu"]).shape == {"file": 1, "channel": 1}


def test_a_killed_rank_fails_its_peer_within_the_timeout(ranks):
    """Rank 1 dies before a collective (the pool's last case); rank 0's
    psum fails within the group's timeout, naming the collective."""
    res = ranks[0]["kill"]
    assert "mesh collective psum" in res["error"] and res["seconds"] < 60.0
