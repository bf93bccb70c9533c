"""``repro_torch.serve.queue.AsyncPGMServer`` on the CPU (the twins of the
async tests of ``tests/test_serve.py``): micro-batches triggered by size,
timeout and deadline give the bits of the port's direct engine on the same
bucket (and the reference engine's answers within 1e-5), deadlines order
the flushes, a hot swap drops nothing and leaves no plan of the old
network (it waits for a flush held on the old engines, released or
crashed), replicas answer as one worker, and
vmp buckets split over a one-rank gloo mesh give the mesh-free bits.
Buckets form on the clock, so answers are held against the direct engine
on each bucket the server recorded (``_record``).

Clock-driven tests keep the reference's generous margins: every wait is
bounded (``result(timeout=120)``) and size triggers sit behind a
10 s coalescing window."""

import datetime
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from _torch_parity import bn_to_port  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.serve.engine import PGMQueryEngine as JEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.serve.engine import PGMQueryEngine  # noqa: E402
from repro_torch.serve.queue import AsyncPGMServer  # noqa: E402


def _bn(seed=0):
    return tsyn.random_discrete_bn(5, card=2, max_parents=2, seed=seed,
                                   device="cpu")


def _names(bn):
    return [v.name for v in bn.order]


def _direct(bn, queries, **kw):
    eng = PGMQueryEngine(bn, mode="exact", device="cpu", **kw)
    qs = [eng.submit(t, e) for t, e in queries]
    eng.flush()
    return [q.result for q in qs]


def _reference(seed, queries):
    eng = JEngine(jsyn.random_discrete_bn(5, card=2, max_parents=2,
                                          seed=seed), mode="exact",
                  pad_pow2=True)
    qs = [eng.submit(t, e) for t, e in queries]
    eng.flush()
    return [np.asarray(q.result) for q in qs]


def _server(bn, **kw):
    kw = {"mode": "exact", "default_deadline_ms": 60_000, "device": "cpu",
          **kw}
    return AsyncPGMServer(bn, **kw)


def _record(srv):
    """The buckets ``srv`` flushes, each as its items: a bucket's size
    depends on the clock, so answers are held against the direct engine
    on each recorded bucket."""
    buckets, flush = [], srv._flush_bucket

    def rec(eng, bucket, trigger):
        buckets.append(list(bucket.items))
        return flush(eng, bucket, trigger)

    srv._flush_bucket = rec
    return buckets


def _check(buckets, model, mode="exact"):
    """Each ticket's answer is the bits of a direct ``PGMQueryEngine(
    pad_pow2=True)`` flush of its bucket; returns the answers checked."""
    n = 0
    for items in buckets:
        eng = PGMQueryEngine(model, mode=mode, pad_pow2=True, device="cpu")
        qs = [eng.submit(t, e, p) for _, t, e, p in items]
        eng.flush()
        for (ticket, *_), q in zip(items, qs):
            assert np.array_equal(ticket.result(timeout=0), q.result)
            n += 1
    return n


def test_the_port_network_is_the_references():
    jbn = jsyn.random_discrete_bn(5, card=2, max_parents=2, seed=0)
    tbn = bn_to_port(jbn)
    bn = _bn()
    for v in bn.order:
        assert torch.equal(bn.cpds[v.name].table, tbn.cpds[v.name].table)


@pytest.mark.parametrize("replicas", [1, 2])
def test_size_trigger_matches_direct_engine(replicas):
    bn = _bn()
    names = _names(bn)
    queries = [(names[-1], {names[0]: float(i % 2)}) for i in range(4)]
    with _server(bn, max_batch=4, max_delay_ms=10_000,
                 deadline_margin_ms=0.0, replicas=replicas) as srv:
        buckets = _record(srv)
        tickets = [srv.submit(t, e) for t, e in queries]
        results = [t.result(timeout=120) for t in tickets]
        assert all(t.trigger == "size" for t in tickets)
    assert [len(b) for b in buckets] == [4]
    for r, d, j in zip(results, _direct(bn, queries, pad_pow2=True),
                       _reference(0, queries)):
        assert np.array_equal(r, d)
        np.testing.assert_allclose(r, j, atol=1e-5)


def test_timeout_trigger_matches_direct_engine():
    bn = _bn()
    names = _names(bn)
    queries = [(names[-1], {names[1]: 1.0}), (names[-1], {names[1]: 0.0}),
               (names[-1], {names[1]: 1.0})]
    with _server(bn, max_batch=64, max_delay_ms=50) as srv:
        buckets = _record(srv)
        tickets = [srv.submit(t, e) for t, e in queries]
        results = [t.result(timeout=120) for t in tickets]
        assert all(t.trigger == "timeout" for t in tickets)
    assert _check(buckets, bn) == len(queries)
    for r, j in zip(results, _reference(0, queries)):
        np.testing.assert_allclose(r, j, atol=1e-5)


def test_deadline_drives_flush_order_across_mixed_schemas(tmp_path):
    bn = _bn()
    names = _names(bn)
    slow = (names[-1], {names[0]: 1.0})
    fast = (names[-1], {names[1]: 1.0, names[2]: 0.0})
    path = str(tmp_path / "events.jsonl")
    prev = obs.configure(level="basic", path=path, reset_counters=True)
    try:
        with _server(bn, max_batch=64, max_delay_ms=10_000,
                     deadline_margin_ms=100.0) as srv:
            for t, e in (slow, fast):           # warm both plans
                srv.submit(t, e, deadline_ms=1.0).result(timeout=120)
            t_slow = srv.submit(*slow, deadline_ms=2_000)   # submitted first
            t_fast = srv.submit(*fast, deadline_ms=500)     # tighter deadline
            t_fast.result(timeout=120)
            t_slow.result(timeout=120)
            assert t_fast.trigger == "deadline"
            assert t_fast.done_s < t_slow.done_s
        counts = obs.validate_obs_events(path)
    finally:
        obs.configure(level=prev["level"], path=prev["path"],
                      reset_counters=True)
    assert t_fast.deadline_miss is False
    assert counts["serve_deadline"] == 4 and counts["slo"] == 4
    evs = [json.loads(line) for line in open(path)]
    trig = [e["trigger"] for e in evs if e["event"] == "serve_deadline"]
    assert trig[2:] == ["deadline", "deadline"]


def test_hot_swap_mid_stream_drops_nothing_and_changes_answers():
    bn, bn2 = _bn(0), _bn(9)
    names = _names(bn)
    query = (names[-1], {names[0]: 1.0})
    with _server(bn, max_batch=8, max_delay_ms=5) as srv:
        srv.submit(*query).result(timeout=120)      # warm v0
        tickets, stop = [], threading.Event()

        def pump():
            while not stop.is_set():
                tickets.append(srv.submit(*query))
                time.sleep(0.002)

        th = threading.Thread(target=pump)
        th.start()
        try:
            time.sleep(0.05)
            info = srv.swap_model(bn2)
            time.sleep(0.05)
        finally:
            stop.set()
            th.join(timeout=120)
        results = [t.result(timeout=120) for t in tickets]
        assert srv.stats()["pending"] == 0
        assert info["new_version"] == 1 and info["warmed_plans"] >= 1
    assert all(t.error is None for t in tickets)
    # buckets of any size: the answer of either network (atol 1e-6, as
    # bucket sizes differ from the direct engine's)
    old = _direct(bn, [query], pad_pow2=True)[0]
    new = _direct(bn2, [query], pad_pow2=True)[0]
    assert not np.allclose(old, new)
    for r in results:
        assert (np.allclose(r, old, atol=1e-6)
                or np.allclose(r, new, atol=1e-6))
    assert any(np.allclose(r, new, atol=1e-6) for r in results)
    assert all(k.network_version == 1 for k in srv.plans.keys())



@pytest.mark.parametrize("end", ["release", "crash"])
def test_swap_waits_for_a_flush_on_the_old_engines(end):
    """A worker holding a version-0 bucket across ``swap_model``: the swap
    switches and drains, but invalidates the old plans only once that
    flush has ended, so none is cached again after it.  ``crash`` kills
    the held worker instead (the supervisor requeues its bucket onto the
    new engines) and the swap still completes."""
    from repro_torch.resilience.errors import WorkerCrashError

    bn, bn2 = _bn(0), _bn(9)
    names = _names(bn)
    query = (names[-1], {names[0]: 1.0})
    gate, held, release = threading.Lock(), threading.Event(), threading.Event()

    def hook(widx, bucket):
        with gate:
            first = not held.is_set()
            held.set()
        if first:
            assert release.wait(60)
            if end == "crash":
                raise WorkerCrashError(f"injected crash in worker {widx}")

    with _server(bn, max_batch=8, max_delay_ms=5, replicas=2,
                 supervise_interval_ms=5) as srv:
        srv.submit(*query).result(timeout=120)      # warm v0
        srv._flush_hook = hook
        t_old = srv.submit(*query)
        assert held.wait(60)                        # popped on v0 engines
        handle = srv.swap_model(bn2, block=False)
        deadline = time.monotonic() + 60
        while srv.stats()["network_version"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        # the other worker serves the new version meanwhile
        t_new = srv.submit(*query)
        r_new = t_new.result(timeout=120)
        time.sleep(0.1)
        assert not handle.done()
        assert any(k.network_version == 0 for k in srv.plans.keys())
        release.set()
        info = handle.wait(timeout=120)
        r_old = t_old.result(timeout=120)
        assert info["new_version"] == 1
        assert all(k.network_version == 1 for k in srv.plans.keys())
        assert srv.stats()["pending"] == 0
        if end == "crash":
            assert srv.stats()["worker_restarts"] >= 1
    old = _direct(bn, [query], pad_pow2=True)[0]
    new = _direct(bn2, [query], pad_pow2=True)[0]
    assert np.array_equal(r_new, new)
    # released: flushed on the engines it took; crashed: requeued after
    # the switch, so the new engines answer it
    assert np.array_equal(r_old, old if end == "release" else new)


def test_stop_while_a_respawn_is_staged():
    """``stop()`` while the supervisor has staged a dead worker's
    replacement but not yet started it (it starts staged threads outside
    the lock): the replacement is joined once started, not joined before
    (which raises).  Here the staged thread's start waits until ``stop()``
    has begun; the crashed bucket is served by the other replica."""
    import repro_torch.serve.queue as Q
    from repro_torch.resilience.faultinject import FaultInjector

    bn = _bn()
    names = _names(bn)
    query = (names[-1], {names[0]: 1.0})
    staged, go = threading.Event(), threading.Event()

    class Delayed(threading.Thread):
        def start(self):
            staged.set()
            assert go.wait(60)
            super().start()

    class Threading:                        # the module's threading, but Thread
        Thread = Delayed

        def __getattr__(self, name):
            return getattr(threading, name)

    srv = _server(bn, max_batch=8, max_delay_ms=5, replicas=2,
                  supervise_interval_ms=5)
    real = Q.threading
    try:
        srv.submit(*query).result(timeout=120)
        Q.threading = Threading()
        box = FaultInjector().crash_worker(srv)
        t = srv.submit(*query)
        r = t.result(timeout=120)           # the other replica serves it
        assert staged.wait(60) and box["fired"]
    finally:
        Q.threading = real
        timer = threading.Timer(0.2, go.set)
        timer.start()
        srv.stop()
        timer.join()
    assert srv.stats()["worker_restarts"] == 1
    assert not any(w.is_alive() for w in srv._workers)
    assert np.array_equal(r, _direct(bn, [query], pad_pow2=True)[0])

def _gmm():
    from repro_torch.pgm_models import GaussianMixture

    stream, _, _ = tsyn.gmm_stream(400, 3, 4, seed=1)
    m = GaussianMixture(stream.attributes, n_states=3, device="cpu")
    m.update_model(stream)
    xs = np.asarray(stream.collect().xc)
    queries = [("Z", {f"X{i}": float(xs[j, i]) for i in range(4)})
               for j in range(12)]
    return m, xs, queries


def test_vmp_replicas_match_a_single_worker():
    m, xs, queries = _gmm()

    def run(replicas):
        with AsyncPGMServer(m, mode="vmp", max_batch=4, max_delay_ms=10_000,
                            default_deadline_ms=60_000,
                            replicas=replicas) as srv:
            buckets = _record(srv)
            tickets = [srv.submit(t, e) for t, e in queries]
            out = [t.result(timeout=120) for t in tickets]
        assert _check(buckets, m, "vmp") == len(queries)
        return out

    # buckets may differ between the runs (the clock), rows by ~1 ulp
    one, three = run(1), run(3)
    np.testing.assert_allclose(np.stack(one), np.stack(three), atol=1e-6)
    np.testing.assert_allclose(np.stack(one), m.posterior_z(xs[:12]).numpy(),
                               atol=1e-6)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo world in this process and its ("data",) mesh."""
    store = tmp_path_factory.mktemp("queue_world1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_mesh_replicas_on_a_one_rank_group(world1):
    m, xs, queries = _gmm()
    with AsyncPGMServer(m, mode="vmp", max_batch=4, max_delay_ms=10_000,
                        default_deadline_ms=60_000, replicas=2,
                        mesh=world1) as srv:
        buckets = _record(srv)
        tickets = [srv.submit(t, e) for t, e in queries]
        for t in tickets:
            t.result(timeout=120)
        assert any(k.mode == "vmp" for k in srv.plans.keys())
    # each bucket over the one-rank mesh: the mesh-free engine's bits
    assert _check(buckets, m, "vmp") == len(queries)
    with pytest.raises(ValueError, match="mode='vmp'"):
        AsyncPGMServer(_bn(), mode="exact", device="cpu", mesh=world1)


def test_a_failing_flush_fails_its_tickets_and_stop_refuses():
    """A bucket whose flush raises (unknown evidence, caught at flush as
    in the reference) fails its tickets with the error; serving goes on."""
    bn = _bn()
    names = _names(bn)
    srv = _server(bn, max_batch=4, max_delay_ms=5)
    bad = srv.submit(names[-1], {"nope": 1.0})
    with pytest.raises(ValueError, match="unknown evidence"):
        bad.result(timeout=120)
    ok = srv.submit(names[-1], {names[0]: 1.0})
    assert np.array_equal(ok.result(timeout=120), _direct(
        bn, [(names[-1], {names[0]: 1.0})], pad_pow2=True)[0])
    srv.stop()
    assert srv.stats()["pending"] == 0
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit(*(_names(bn)[-1], {_names(bn)[0]: 1.0}))
    with pytest.raises(ValueError):
        AsyncPGMServer(bn, replicas=0, device="cpu")
