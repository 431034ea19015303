"""Port parity, the failure taxonomy and the chaos harness: ``faults`` of
das4whales_tpu_torch against das4whales_tpu's.

``classify_failure`` gives the JAX class on a table of exceptions, and
puts the card's out-of-memory failures — ``torch.cuda.OutOfMemoryError``
by type, cuFFT's ``CUFFT_ALLOC_FAILED`` by text — in ``resource``, so
the downshift ladder catches them instead of burning the file.
``FaultPlan`` draws JAX's schedule for the same seed (the campaign chaos
parity in ``test_torch_campaign.py`` rests on it); the rung vocabulary,
the retry backoff and the dispatch pipeline are the JAX package's.
"""

from __future__ import annotations

import errno
import time

import numpy as np
import pytest
import torch

from das4whales_tpu import faults as jf
from das4whales_tpu.parallel import dispatch as jdispatch
from das4whales_tpu_torch import faults as tf
from das4whales_tpu_torch.parallel import dispatch as tdispatch
from tests.torch_threads import one_torch_thread  # noqa: F401


class XlaRuntimeError(RuntimeError):
    pass


def _table(mod):
    return [
        OSError(errno.EIO, "I/O error"),
        OSError(errno.ENOENT, "No such file"),
        OSError("Unable to open file (file signature not found)"),
        OSError("stale file handle on /mnt"),
        ConnectionResetError("reset"),
        TimeoutError("slow"),
        InterruptedError(),
        FloatingPointError("nan"),
        MemoryError(),
        KeyboardInterrupt(),
        ValueError("shape mismatch"),
        KeyError("x"),
        RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate 4.0G"),
        RuntimeError("something else broke"),
        XlaRuntimeError("exceeds the HBM capacity"),
        mod.DataHealthError("nonfinite"),
        mod.InjectedReadError(errno.EIO, "x"),
        mod.InjectedCorruptFile("x"),
        mod.InjectedTransferError("x"),
        mod.InjectedDetectorError("x"),
        mod.InjectedResourceExhausted("x"),
        mod.InjectedCrash("x"),
        mod.DeadlineExceeded("/f.h5", 1.0),
        mod.DispatchDeadlineExceeded("/f.h5", 1.0),
    ]


def test_classify_failure_matches_jax():
    want = [jf.classify_failure(e) for e in _table(jf)]
    got = [tf.classify_failure(e) for e in _table(tf)]
    assert got == want
    assert set(want) == set(tf.FAULT_CLASSES)


def test_card_out_of_memory_is_a_resource_failure():
    assert tf.classify_failure(torch.cuda.OutOfMemoryError("CUDA error")) == "resource"
    assert tf.classify_failure(torch.OutOfMemoryError("allocator")) == "resource"
    # the text alone, as a cuFFT plan allocation surfaces it
    assert tf.classify_failure(RuntimeError("cuFFT error: CUFFT_ALLOC_FAILED")) == "resource"
    assert tf.classify_failure(
        RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate")
    ) == "resource"
    # the JAX markers alone would burn such a file as corrupt
    assert jf.classify_failure(RuntimeError("cuFFT error: CUFFT_ALLOC_FAILED")) == "corrupt"


NAMES = [f"file{k}_seed{2026 + k}.h5" for k in range(40)] + ["a.tdms", "b c.h5"]


@pytest.mark.parametrize("seed", range(10))
def test_fault_plan_draws_the_jax_schedule(seed):
    for kinds in (jf.FAULT_KINDS, jf.FAULT_KINDS + jf.DISPATCH_FAULT_KINDS,
                  jf.DISPATCH_FAULT_KINDS):
        jp = jf.FaultPlan(seed, rate=0.5, kinds=kinds, max_transient_repeats=3)
        tp = tf.FaultPlan(seed, rate=0.5, kinds=kinds, max_transient_repeats=3)
        pol_j, pol_t = jf.RetryPolicy(), tf.RetryPolicy()
        for name in NAMES:
            js, ts = jp.spec_for(f"/x/{name}"), tp.spec_for(f"/y/{name}")
            assert (js is None) == (ts is None)
            if js is not None:
                assert (js.kind, js.site, js.n_times, js.ok_rung) == \
                    (ts.kind, ts.site, ts.n_times, ts.ok_rung)
            assert jp.expected_disposition(name, pol_j) == tp.expected_disposition(name, pol_t)


def test_fault_plan_hooks_fire_as_in_jax():
    jp = jf.FaultPlan(3, rate=1.0, kinds=("oom",))
    tp = tf.FaultPlan(3, rate=1.0, kinds=("oom",))
    for name in NAMES[:8]:
        for rung in (("batched", 4), ("batched", 2), ("file", 1), ("tiled", 1), ("host", 1)):
            outcomes = []
            for plan, mod in ((jp, jf), (tp, tf)):
                try:
                    plan.on_dispatch(name, rung)
                    outcomes.append(None)
                except mod.InjectedResourceExhausted as exc:
                    outcomes.append(str(exc))
            assert outcomes[0] == outcomes[1]
    # a pinned fault replaces the draw for its file only
    spec = tf.FaultSpec("oom", "dispatch", 10**9, ("batched", 2))
    pinned = tf.FaultPlan(3, rate=1.0, kinds=("oom",), pinned={NAMES[0]: spec})
    assert pinned.spec_for("/d/" + NAMES[0]) is spec
    assert pinned.spec_for(NAMES[1]) == tp.spec_for(NAMES[1])
    with pytest.raises(tf.InjectedResourceExhausted):
        pinned.on_dispatch(NAMES[0], ("batched", 4))
    pinned.on_dispatch(NAMES[0], ("batched", 2))
    with pytest.raises(ValueError):
        tf.FaultPlan(0, pinned={"x": tf.FaultSpec("oom", "read", 1)})


RUNGS = [("batched", 16), ("batched", 8), ("bank", 8), ("batched", 4), ("bank", 4),
         ("batched", 2), ("file", 1), ("bank", 1), ("tiled", 1), ("timeshard", 1), ("host", 1)]


def test_rung_rank_and_label_match_jax():
    assert tf.DOWNSHIFT_STAGES == jf.DOWNSHIFT_STAGES
    for r in RUNGS:
        assert tf.rung_rank(r) == jf.rung_rank(r)
        assert tf.rung_label(r) == jf.rung_label(r)
    assert sorted(RUNGS[::-1], key=tf.rung_rank) == RUNGS


def test_retry_state_and_backoff_match_jax():
    jp = jf.RetryPolicy(max_attempts=4, base_delay_s=0.01, budgets={"transient": 3})
    tp = tf.RetryPolicy(max_attempts=4, base_delay_s=0.01, budgets={"transient": 3})
    for key in ("a.h5", "b.h5"):
        for attempt in range(1, 6):
            assert tp.delay_s(key, attempt) == jp.delay_s(key, attempt)
    js, ts = jf.RetryState(jp), tf.RetryState(tp)
    slept_j, slept_t = [], []
    for _ in range(5):
        for st, slept in ((js, slept_j), (ts, slept_t)):
            st.attempt("a.h5")
            if st.should_retry("a.h5", "transient"):
                st.backoff("a.h5", "transient", sleep=slept.append)
    assert slept_t == slept_j and len(slept_t) == 3
    assert list(tf.Backoff(deadline_s=0.5).delays("k")) == list(jf.Backoff(deadline_s=0.5).delays("k"))


def test_call_with_deadline_abandons_a_wedged_call():
    t0 = time.perf_counter()
    with pytest.raises(tf.DispatchDeadlineExceeded):
        tf.call_with_deadline(lambda: time.sleep(2.0), 0.1, "/f.h5")
    assert time.perf_counter() - t0 < 1.0
    assert tf.call_with_deadline(lambda: 7, None, "/f.h5") == 7
    with pytest.raises(TimeoutError) as ei:
        tf.call_with_deadline(lambda: (_ for _ in ()).throw(TimeoutError("own")), 1.0, "/f.h5")
    assert not isinstance(ei.value, tf.DispatchDeadlineExceeded)


def test_pipelined_dispatch_matches_jax():
    for depth in (1, 2, 3):
        jp, tp = jdispatch.PipelinedDispatch(depth), tdispatch.PipelinedDispatch(depth)
        assert jp.enabled == tp.enabled
        out_j, out_t = [], []
        for k in range(6):
            out_j += [key for key, _ in jp.submit(k, None)]
            out_t += [key for key, _ in tp.submit(k, None)]
            assert jp.pending() == tp.pending()
        out_j += [key for key, _ in jp.drain()]
        out_t += [key for key, _ in tp.drain()]
        assert out_t == out_j == list(range(6))


def test_resolve_watchdogged_tags_the_rung_and_times_out():
    plan = tf.FaultPlan(0, rate=1.0, kinds=("oom",),
                        pinned={"x.h5": tf.FaultSpec("hang_dispatch", "dispatch", 10**9)},
                        hang_s=0.5)
    with pytest.raises(tf.DispatchDeadlineExceeded) as ei:
        tdispatch.resolve_watchdogged(lambda: 1, ["/d/x.h5"], ("batched", 4), 0.1, plan)
    assert ei.value.campaign_rung == "batched:4"
    with pytest.raises(ValueError) as ei:
        tdispatch.resolve_watchdogged(lambda: (_ for _ in ()).throw(ValueError("v")),
                                      ["/d/y.h5"], ("file", 1), None)
    assert ei.value.campaign_rung == "file"
    assert tdispatch.fetch({"a": torch.arange(3)})["a"].tolist() == [0, 1, 2]
    t = torch.ones(2)
    assert tdispatch.sync(t) is t
    assert np.array_equal(tdispatch.launch(lambda x: x + 1, np.arange(2)), [1, 2])
