"""``repro_torch.resilience`` against ``repro.resilience`` on the CPU (the
twins of ``tests/test_resilience.py``): checkpoints cross between the two
packages, resuming within the port gives the uninterrupted run's bits, the
injectors pick the reference's rows and batches, and the serving tier's
robustness paths (retry, shedding, watchdog, respawn, swaps) lose no
ticket.

Tolerances: a stream resumed across packages against the other package's
uninterrupted run at the stream parity bars of ``test_torch_streaming.py``
(final posterior rtol/atol 1e-3, per-batch ELBO rtol 1e-4); everything
within the port exactly."""

import contextlib
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_params_close, plates, trees_equal  # noqa
from repro.core import streaming as jst  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.resilience import CheckpointManager as JManager  # noqa: E402
from repro.resilience import FaultInjector as JInjector  # noqa: E402
from repro.resilience import resume_stream_fit as jresume  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.stream import DataStream  # noqa: E402
from repro_torch.resilience import (CheckpointManager, DeadlineError,  # noqa
                                    FaultInjector, ShedError,
                                    TransientCompileError,
                                    checkpointed_stream_fit,
                                    resume_stream_fit)
from repro_torch.resilience import checkpoint as ckpt  # noqa: E402
from repro_torch.serve.engine import PGMQueryEngine  # noqa: E402
from repro_torch.serve.plan import PlanCache, PlanKey  # noqa: E402
from repro_torch.serve.queue import AsyncPGMServer, SwapHandle  # noqa: E402

KW = dict(sweeps=5, tol=0.0)


@contextlib.contextmanager
def _obs_to(tmp_path, level="basic"):
    path = str(tmp_path / "events.jsonl")
    prev = obs.configure(level=level, path=path, reset_counters=True)
    try:
        yield path
    finally:
        obs.configure(level=prev["level"], path=prev["path"],
                      reset_counters=True)


@pytest.fixture(scope="module")
def setup():
    """Both packages' plates from the reference's initial posterior, and 8
    batches of 120 instances of a 2-component GMM."""
    stream, _, _ = jsyn.gmm_stream(8 * 120, 2, 3, seed=0)
    xcs = np.stack([np.asarray(b.xc) for b in stream.batches(120)])
    xds = np.zeros(xcs.shape[:2] + (0,), np.int32)
    return plates(0, None, n_features=3, latent_card=2) + (xcs, xds)


def _port(setup, xcs=None, state=None):
    _, _, _, tcp, tprior, tinit, xs, xds = setup
    xcs = xs if xcs is None else xcs
    state = tst.stream_init(tprior, tinit) if state is None else state
    return tst.stream_fit(tcp, tprior, state, xcs, xds[:len(xcs)], **KW)


def _ref(setup, xcs=None):
    jcp, jprior, jinit, _, _, _, xs, xds = setup
    xcs = xs if xcs is None else xcs
    return jst.stream_fit(jcp, jprior, jst.stream_init(jprior, jinit),
                          jnp.asarray(xcs), jnp.asarray(xds[:len(xcs)]),
                          **KW)


# -- checkpoints -----------------------------------------------------------------


def test_checkpoint_roundtrip_with_meta_is_exact(setup, tmp_path):
    state, _ = _port(setup, setup[6][:3])
    path = str(tmp_path / "s.npz")
    ckpt.save(path, state, {"t": 3, "network_version": 7})
    _, _, _, _, tprior, tinit = setup[:6]
    restored, meta = ckpt.load(path, tst.stream_init(tprior, tinit))
    assert meta == {"t": 3, "network_version": 7}
    assert trees_equal(state, restored)
    assert restored.n_drifts.dtype == torch.int64
    with np.load(path) as data:
        keys = set(data.files)
    assert {"\x1f".join((".drift", f)) for f in
            (".mean", ".cum", ".cum_min", ".t")} <= keys
    assert "\x1f".join((".post", ".reg", ".m")) in keys


def test_checkpoint_keys_are_the_references(setup, tmp_path):
    """The same state written by each package has the same npz keys,
    shapes, and float dtypes (counters: int32 there, int64 here)."""
    jcp, jprior, jinit = setup[:3]
    _, _, _, _, tprior, tinit = setup[:6]
    from repro.resilience import checkpoint as jckpt

    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save(jp, jst.stream_init(jprior, jinit), {"t": 0})
    ckpt.save(tp, tst.stream_init(tprior, tinit), {"t": 0})
    with np.load(jp) as a, np.load(tp) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape, k
            if a[k].dtype.kind == "f":
                assert a[k].dtype == b[k].dtype, k
                if k != "__meta__":
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_manager_retention_and_policy(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=2, keep=2, on_drift=True)
    state = {"w": np.arange(4.0), "t": torch.arange(3)}
    assert mgr.maybe_save(0, state) is not None       # first always fires
    assert mgr.maybe_save(1, state) is None           # within the period
    assert mgr.maybe_save(2, state) is not None
    assert mgr.maybe_save(3, state, drifted=True) is not None   # on-drift
    paths = mgr.paths()
    assert len(paths) == 2                            # pruned to keep=2
    assert mgr.latest() == paths[-1] == mgr.path_for(3)
    got, meta = ckpt.load(mgr.latest(), state)
    assert meta["reason"] == "drift" and meta["network_version"] == 0
    assert np.array_equal(got["w"], state["w"])
    assert torch.equal(got["t"], state["t"])
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), keep=0)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load(mgr.latest(), {"w": np.arange(5.0), "t": torch.arange(3)})


def test_resume_mid_stream_is_the_uninterrupted_bits(setup, tmp_path):
    _, _, _, tcp, tprior, tinit, xcs, xds = setup
    k = 3
    mgr = CheckpointManager(str(tmp_path), every=0, keep=3)
    head, _ = _port(setup, xcs[:k])
    mgr.save(k, head)
    resumed, tail = resume_stream_fit(tcp, tprior,
                                      tst.stream_init(tprior, tinit), xcs,
                                      xds, manager=mgr, **KW)
    full, info = _port(setup)
    assert tail["elbo"].shape[0] == xcs.shape[0] - k
    assert trees_equal(resumed, full)
    assert torch.equal(tail["elbo"], info["elbo"][k:])


def test_checkpointed_fit_segments_and_events(setup, tmp_path):
    _, _, _, tcp, tprior, tinit, xcs, xds = setup
    mgr = CheckpointManager(str(tmp_path / "ck"), every=2, keep=10)
    with _obs_to(tmp_path) as path:
        state, info = checkpointed_stream_fit(
            tcp, tprior, tst.stream_init(tprior, tinit), xcs[:6], xds[:6],
            manager=mgr, **KW)
        counts = obs.validate_obs_events(path)
    assert info["elbo"].shape[0] == 6
    assert [p[-17:] for p in mgr.paths()] == [
        "ckpt_00000002.npz", "ckpt_00000004.npz", "ckpt_00000006.npz"]
    assert counts["checkpoint"] == 3 and counts["stream_batch"] == 6
    full, _ = _port(setup, xcs[:6])
    assert trees_equal(state, full)                   # segmenting is exact


@pytest.mark.parametrize("k", [2, 5])
def test_reference_checkpoint_resumed_by_the_port(setup, tmp_path, k):
    jcp, jprior, jinit, tcp, tprior, tinit, xcs, xds = setup
    jhead, _ = _ref(setup, xcs[:k])
    JManager(str(tmp_path), every=0).save(k, jhead)
    got, tail = resume_stream_fit(tcp, tprior, tst.stream_init(tprior, tinit),
                                  xcs, xds, manager=CheckpointManager(
                                      str(tmp_path), every=0), **KW)
    jfull, jinfo = _ref(setup)
    assert tail["elbo"].shape[0] == xcs.shape[0] - k
    np.testing.assert_allclose(tail["elbo"].numpy(),
                               np.asarray(jinfo["elbo"])[k:], rtol=1e-4)
    assert_params_close(jfull.post, got.post, rtol=1e-3, atol=1e-3)
    assert int(got.drift.t) == int(jfull.drift.t)
    assert float(got.n_seen) == float(jfull.n_seen)


@pytest.mark.parametrize("k", [2, 5])
def test_port_checkpoint_resumed_by_the_reference(setup, tmp_path, k):
    jcp, jprior, jinit, _, _, _, xcs, xds = setup
    head, _ = _port(setup, xcs[:k])
    CheckpointManager(str(tmp_path), every=0).save(k, head)
    got, tail = jresume(jcp, jprior, jst.stream_init(jprior, jinit),
                        jnp.asarray(xcs), jnp.asarray(xds),
                        manager=JManager(str(tmp_path), every=0), **KW)
    full, info = _port(setup)
    assert tail["elbo"].shape[0] == xcs.shape[0] - k
    np.testing.assert_allclose(np.asarray(tail["elbo"]),
                               info["elbo"].numpy()[k:], rtol=1e-4)
    assert_params_close(got.post, full.post, rtol=1e-3, atol=1e-3)
    assert int(got.n_drifts) == int(full.n_drifts)


# -- injectors and quarantine ---------------------------------------------------------


@pytest.mark.parametrize("seed,rate", [(1, 0.2), (3, 0.25), (9, 0.5)])
def test_poison_nan_picks_the_references_batches(setup, seed, rate):
    xcs = setup[6]
    jbad, jidx = JInjector(seed=seed).poison_nan(xcs, rate=rate)
    inj = FaultInjector(seed=seed)
    tbad, tidx = inj.poison_nan(torch.from_numpy(xcs), rate=rate)
    assert np.array_equal(tidx, jidx)
    assert np.array_equal(np.isnan(tbad), np.isnan(jbad))
    assert inj.log == [("nan_batches", [int(i) for i in jidx])]


def test_poison_nan_skip_is_never_seen(setup):
    """A poisoned batch is skipped: the final state is the bits of a run
    that never saw it, and no NaN leaks into the info columns."""
    xcs = setup[6]
    bad, idx = FaultInjector(seed=3).poison_nan(xcs, rate=0.25)
    sp, ip = _port(setup, bad)
    keep = np.setdiff1d(np.arange(xcs.shape[0]), idx)
    sc, _ = _port(setup, xcs[keep])
    assert ip["quarantined"].nonzero().flatten().tolist() == idx.tolist()
    assert int(sp.n_quarantined) == len(idx)
    assert trees_equal(sp.post, sc.post) and trees_equal(sp.drift, sc.drift)
    for k in ("elbo", "score", "ph"):
        assert torch.isfinite(ip[k]).all()


@pytest.mark.parametrize("rate,seed", [(0.1, 42), (0.01, 6)])
def test_poison_stream_picks_the_references_rows(rate, seed):
    js, _, _ = jsyn.gmm_stream(500, 2, 3, seed=0)
    ts, _, _ = tsyn.gmm_stream(500, 2, 3, seed=0)
    a = np.asarray(jsyn.poison_stream(js, rate=rate, seed=seed).collect().xc)
    p = tsyn.poison_stream(ts, rate=rate, seed=seed)
    b = np.asarray(p.collect().xc)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    n_bad = int(np.isnan(b).any(axis=1).sum())
    assert 0 < n_bad < 500
    guarded = DataStream(p.attributes, tsyn.poison_stream(
        ts, rate=rate, seed=seed).chunks, n_instances=500, validate=True)
    clean = guarded.collect()
    assert guarded.quarantined == n_bad and clean.xc.shape[0] == 500 - n_bad
    with pytest.raises(ValueError):
        tsyn.poison_stream(ts, rate=1.5)


# -- plan cache ---------------------------------------------------------------------


def test_plan_cache_retry_after_transient_failure(tmp_path):
    cache = PlanCache(compile_retries=2, retry_backoff_s=0.01)
    box = FaultInjector().fail_compiles(cache, n=2)
    key = PlanKey(0, "jt-discrete", ("D0",), (4,), ("float32",))
    with _obs_to(tmp_path) as path:
        plan = cache.get(key, lambda: (lambda x: x + 1))
        evs = [json.loads(line) for line in open(path)]
    assert plan.run(1) == 2 and cache.retries == 2 and box["left"] == 0
    assert [(e["attempt"], e["error"]) for e in evs
            if e["event"] == "serve_retry"] == [
        (1, "TransientCompileError"), (2, "TransientCompileError")]
    assert cache.stats()["retries"] == 2


def test_plan_cache_build_raise_leaves_no_poisoned_entry():
    cache = PlanCache()
    key = PlanKey(0, "jt-discrete", ("D0",), (4,), ("float32",))

    def bad():
        raise TransientCompileError("boom")

    with pytest.raises(TransientCompileError):
        cache.get(key, bad)
    assert key not in cache and len(cache) == 0
    assert cache.get(key, lambda: (lambda x: x * 2)).run(3) == 6
    assert cache.stats()["misses"] == 2
    with pytest.raises(ValueError):
        PlanCache(compile_retries=-1)


# -- serving robustness --------------------------------------------------------------


def _bn(seed=0):
    return tsyn.random_discrete_bn(5, card=2, max_parents=2, seed=seed,
                                   device="cpu")


def _q(bn, i=0):
    names = [v.name for v in bn.order]
    return names[-1], {names[0]: float(i % 2)}


def _server(bn, **kw):
    kw = {"mode": "exact", "default_deadline_ms": 60_000, "device": "cpu",
          **kw}
    return AsyncPGMServer(bn, **kw)


def test_submit_sheds_over_max_queue(tmp_path):
    bn = _bn()
    with _obs_to(tmp_path) as path:
        with _server(bn, max_batch=64, max_delay_ms=10_000,
                     max_queue=2) as srv:
            kept = [srv.submit(*_q(bn)) for _ in range(2)]
            shed = [srv.submit(*_q(bn)) for _ in range(3)]
            for t in shed:
                assert t.done() and t.trigger == "shed"
                with pytest.raises(ShedError):
                    t.result()
            st = srv.stats()
            assert st["shed"] == 3 and st["submitted"] == 2
        counts = obs.validate_obs_events(path)
    for t in kept:
        assert t.error is None and t.result(timeout=120) is not None
    assert srv.stats()["pending"] == 0 and counts["serve_shed"] == 3


def test_request_timeout_fails_a_stuck_flush_with_deadline_error():
    bn = _bn()
    inj = FaultInjector()
    with _server(bn, max_batch=1, max_delay_ms=1, default_deadline_ms=40,
                 request_timeout_ms=40, supervise_interval_ms=5) as srv:
        srv.submit(*_q(bn), deadline_ms=60_000).result(timeout=120)  # warm
        inj.slow_flush(srv, delay_s=1.5, n=1)
        t = srv.submit(*_q(bn))
        with pytest.raises(DeadlineError):
            t.result(timeout=120)
        assert t.deadline_miss and t.trigger == "watchdog"
        ok = srv.submit(*_q(bn, 1), deadline_ms=60_000)
        assert ok.result(timeout=120) is not None
    assert srv.stats()["pending"] == 0


def test_worker_crash_requeues_and_respawns_with_zero_loss(tmp_path):
    bn = _bn()
    with _obs_to(tmp_path) as path:
        with _server(bn, max_batch=4, max_delay_ms=10_000,
                     supervise_interval_ms=5) as srv:
            box = FaultInjector().crash_worker(srv, widx=0)
            tickets = [srv.submit(*_q(bn, i)) for i in range(4)]
            results = [t.result(timeout=120) for t in tickets]
            st = srv.stats()
            assert box["fired"] and st["worker_restarts"] >= 1
            assert st["pending"] == 0
        counts = obs.validate_obs_events(path)
    assert counts["serve_worker"] >= 1
    assert all(t.error is None for t in tickets)
    eng = PGMQueryEngine(bn, mode="exact", pad_pow2=True, device="cpu")
    qs = [eng.submit(*_q(bn, i)) for i in range(4)]
    eng.flush()
    for r, q in zip(results, qs):
        assert np.array_equal(r, q.result)


def test_swap_nonblocking_returns_a_handle():
    bn, bn2 = _bn(0), _bn(9)
    with _server(bn, max_batch=8, max_delay_ms=5) as srv:
        srv.submit(*_q(bn)).result(timeout=120)
        handle = srv.swap_model(bn2, block=False)
        assert isinstance(handle, SwapHandle)
        info = handle.wait(timeout=120)
        assert handle.done() and info["new_version"] == 1
        assert info["warmed_plans"] == 1
        assert srv.stats()["network_version"] == 1
        new = srv.submit(*_q(bn)).result(timeout=120)
    assert all(k.network_version == 1 for k in srv.plans.keys())
    eng = PGMQueryEngine(bn2, mode="exact", pad_pow2=True, device="cpu")
    q = eng.submit(*_q(bn))
    eng.flush()
    assert np.array_equal(new, q.result)


def test_swap_abort_on_warm_failure_keeps_the_old_engines():
    bn, bn2 = _bn(0), _bn(9)
    cache = PlanCache()
    with _server(bn, max_batch=8, max_delay_ms=5, plan_cache=cache) as srv:
        before = srv.submit(*_q(bn)).result(timeout=120)
        FaultInjector().fail_compiles(cache, n=10)
        with pytest.raises(TransientCompileError):
            srv.swap_model(bn2)
        handle = srv.swap_model(bn2, block=False)
        with pytest.raises(TransientCompileError):
            handle.wait(timeout=120)
        FaultInjector.disarm(cache=cache)
        assert srv.stats()["network_version"] == 0
        assert all(k.network_version == 0 for k in cache.keys())
        after = srv.submit(*_q(bn)).result(timeout=120)
        assert np.array_equal(before, after)


def test_chaos_nan_crash_and_build_failure_lose_nothing():
    """A 1%-NaN training stream, one worker crash and one transient build
    failure in one serving run: the learner quarantines the rows, and the
    server answers every accepted ticket with the direct engine's bits."""
    from repro_torch.pgm_models import GaussianMixture

    clean, _, _ = tsyn.gmm_stream(2000, 3, 4, seed=5)
    poisoned = tsyn.poison_stream(clean, rate=0.01, seed=6)
    guarded = DataStream(poisoned.attributes, poisoned.chunks,
                         n_instances=poisoned.n_instances, validate=True)
    m = GaussianMixture(guarded.attributes, n_states=3, device="cpu")
    m.update_model(guarded)
    assert guarded.quarantined > 0
    xs = np.asarray(clean.collect().xc)
    ev = lambda j: {f"X{i}": float(xs[j, i]) for i in range(4)}

    cache = PlanCache(compile_retries=2, retry_backoff_s=0.01)
    inj = FaultInjector(seed=7)
    with AsyncPGMServer(m, mode="vmp", max_batch=4, max_delay_ms=20,
                        default_deadline_ms=60_000, replicas=2,
                        plan_cache=cache, supervise_interval_ms=5) as srv:
        srv.submit("Z", ev(0)).result(timeout=120)
        crash = inj.crash_worker(srv)
        inj.fail_compiles(cache, n=1)
        tickets = [srv.submit("Z", ev(j)) for j in range(1, 25)]
        results = [t.result(timeout=120) for t in tickets]
        st = srv.stats()
    assert crash["fired"] and st["worker_restarts"] >= 1
    assert st["plans"]["retries"] >= 1 and st["pending"] == 0
    assert all(t.error is None for t in tickets)
    z = m.posterior_z(xs[1:25]).numpy()
    np.testing.assert_allclose(np.stack(results), z, atol=1e-6)
    assert [k for k, _ in inj.log] == ["worker_crash", "compile_failures"]


def test_slow_replica_is_degraded_and_serving_stays_exact(tmp_path):
    """A replica stalled by ``slow_flush`` drops its health score while the
    other serves on; every ticket is answered."""
    bn = _bn()
    inj = FaultInjector()
    with _obs_to(tmp_path, "trace") as path:
        srv = _server(bn, max_batch=8, max_delay_ms=5, replicas=2,
                      supervise_interval_ms=5)
        srv.submit(*_q(bn)).result(timeout=120)
        inj.slow_flush(srv, delay_s=0.05, n=1000, widx=0)
        tickets, i = [], 0
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            tickets.append(srv.submit(*_q(bn, i)))
            i += 1
            time.sleep(0.006)
            if srv.health.snapshots()[0]["degraded"]:
                break
        h = srv.health.snapshots()
        srv.stop()
        counts = obs.validate_obs_events(path)
        text = obs.default_prometheus_text()
        trace = obs.write_chrome_trace(path, str(tmp_path / "trace.json"))
    assert "serve_request_ms_bucket" in text and "replica_score" in text
    assert any(e["ph"] == "X" for e in trace["traceEvents"])
    assert h[0]["degraded"] and not h[1]["degraded"]
    assert srv.stats()["pending"] == 0
    assert all(t.done() and t.error is None for t in tickets)
    assert counts["serve_health"] >= 2 and counts["slo"] >= 1
