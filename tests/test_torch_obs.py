"""``repro_torch.obs`` against ``repro.obs`` on the CPU (the twins of
``tests/test_obs.py`` and ``tests/test_obs_agg.py``): the aggregation tier
and exporters give the reference's numbers and exact strings on the same
inputs, a stream fit emits the reference's events with the same fields,
each package's validator accepts the other's file, and obs levels never
change a result bit.

Tolerances: quantiles, snapshots and exporter strings exactly; event
values of a stream fit at the parity bars of ``test_torch_streaming.py``
(ELBO, score, Page-Hinkley rtol 1e-4, atol 1e-4; flags and sweeps
exactly); ``chunk_n_eff`` exactly (sums of 0/1 masks)."""

import contextlib
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import bn_to_port, plates  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.core import vmp as jvmp  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.obs import agg as jagg  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.core import vmp as tvmp  # noqa: E402
from repro_torch.obs import agg as tagg  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs.health import HealthTracker  # noqa: E402
from repro_torch.serve.engine import PGMQueryEngine  # noqa: E402

KW = dict(sweeps=6, tol=0.0, drift_threshold=3.0)


@contextlib.contextmanager
def _obs_to(mod, tmp_path, level="trace", name="events.jsonl"):
    """Route ``mod``'s sink (``repro.obs`` or ``repro_torch.obs``) to a temp
    file at ``level``; restore the previous config on exit."""
    path = str(tmp_path / name)
    prev = mod.configure(level=level, path=path, reset_counters=True)
    try:
        yield path
    finally:
        mod.configure(level=prev["level"], path=prev["path"],
                      reset_counters=True)


def _events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


# -- aggregation tier ---------------------------------------------------------


def _fill(mod, seed, n=400):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    reg.counter("c_total", leg=str(seed % 2)).inc(seed + 1)
    h = reg.histogram("lat_ms", route="a")
    for v in rng.lognormal(0.5, 1.0, n):
        h.record(v)
    h2 = reg.histogram("small", lo=1.0, hi=16.0, growth=2.0)
    for v in (0.25, 1.5, 3.0, 20.0, float("nan")):
        h2.record(v)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_and_snapshots_match_reference(seed):
    jr, tr = _fill(jagg, seed), _fill(tagg, seed)
    assert tr.snapshot() == jr.snapshot()
    for name, labels in (("lat_ms", {"route": "a"}), ("small", {})):
        jh, th = jr.histogram(name, **labels), tr.histogram(name, **labels)
        qs = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0)
        assert th.quantiles(qs) == jh.quantiles(qs)
        assert th.count == jh.count and th.sum == jh.sum


def test_merge_and_snapshot_quantiles_match_reference():
    snaps = {m: [_fill(m, s).snapshot() for s in (1, 2, 3)]
             for m in (jagg, tagg)}
    merged = {m: m.merge_snapshots(m.merge_snapshots(*snaps[m][:2]),
                                   snaps[m][2]) for m in (jagg, tagg)}
    assert merged[tagg] == merged[jagg]
    # associativity, and the port's merge of the reference's snapshots
    assert tagg.merge_snapshots(snaps[tagg][0], tagg.merge_snapshots(
        *snaps[tagg][1:])) == merged[tagg]
    assert tagg.merge_snapshots(tagg.merge_snapshots(*snaps[jagg][:2]),
                                snaps[jagg][2]) == merged[jagg]
    hist = [e for e in merged[tagg]["metrics"] if e["kind"] == "histogram"]
    for h in hist:
        for q in (0.5, 0.99):
            assert (tagg.quantile_from_snapshot(h, q)
                    == jagg.quantile_from_snapshot(h, q))
    with pytest.raises(ValueError, match="bucket configs differ"):
        r1, r2 = tagg.MetricsRegistry(), tagg.MetricsRegistry()
        r1.histogram("h", growth=1.15).record(1.0)
        r2.histogram("h", growth=2.0).record(1.0)
        tagg.merge_snapshots(r1.snapshot(), r2.snapshot())


def test_counter_gauge_and_newest_gauge_wins():
    reg = tagg.MetricsRegistry()
    c = reg.counter("reqs_total", mode="exact")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5 and reg.counter("reqs_total", mode="exact") is c
    with pytest.raises(ValueError):
        c.inc(-1)
    a, b = tagg.MetricsRegistry(), tagg.MetricsRegistry()
    a.gauge("g").set(1.0)
    b.gauge("g").set(2.0)                     # written last
    for snap in (tagg.merge_snapshots(a.snapshot(), b.snapshot()),
                 tagg.merge_snapshots(b.snapshot(), a.snapshot())):
        assert snap["metrics"][0]["value"] == 2.0


def test_prometheus_text_equals_reference():
    snap = {m: None for m in (jagg, tagg)}
    for m in snap:
        reg = m.MetricsRegistry()
        reg.counter("kernel_dispatch_total", kernel="k:cuda").inc(2)
        reg.gauge("replica_score", worker=0).set(0.5)
        h = reg.histogram("lat_ms", lo=1.0, hi=16.0, growth=2.0, route="a")
        for v in (1.5, 3.0, 20.0, 0.5):
            h.record(v)
        h2 = reg.histogram("serve_request_ms", mode="exact", schema="D0,D1")
        for v in np.random.default_rng(4).lognormal(1.0, 1.0, 300):
            h2.record(v)
        snap[m] = reg.snapshot()
    text = texport.prometheus_text(snap[tagg])
    assert text == jexport.prometheus_text(snap[tagg])
    assert text == jexport.prometheus_text(snap[jagg])
    assert 'lat_ms_bucket{route="a",le="+Inf"} 4' in text


def _span_records():
    rng = np.random.default_rng(1)
    out = []
    for i in range(12):
        out.append({"ts": 100.0 + i * 1e-3, "seq": i + 1, "run": f"r{i % 2}",
                    "event": "span" if i % 5 else "metric",
                    "name": ["serve.flush", "serve.bucket", "jt.execute"][i % 3],
                    "dur_us": float(rng.uniform(1, 500)), "span_id": i + 1,
                    "parent_id": None if i % 3 == 0 else i, "tid": 7 + i % 2,
                    "batch": i, "value": 1})
    return out


def test_chrome_trace_equals_reference(tmp_path):
    recs = _span_records()
    assert texport.chrome_trace(recs) == jexport.chrome_trace(recs)
    lines = [json.dumps(r) for r in recs]
    assert texport.chrome_trace(lines) == jexport.chrome_trace(lines)
    out = str(tmp_path / "trace.json")
    tr = texport.write_chrome_trace(lines, out)
    with open(out) as fh:
        assert json.load(fh) == tr == jexport.chrome_trace(recs)


def test_health_tracker_scoring_and_defer():
    tr = HealthTracker(2, alpha=0.5, threshold=0.5, min_flushes=3)
    assert tr.scores() == [1.0, 1.0] and not tr.should_defer(0)
    for _ in range(5):
        tr.record_flush(0, 100.0)
        tr.record_flush(1, 1.0)
    s = tr.scores()
    assert s[1] == 1.0 and s[0] < 0.05
    assert tr.should_defer(0) and not tr.should_defer(1)
    snaps = tr.snapshots()
    assert snaps[0]["degraded"] and not snaps[1]["degraded"]
    lone = HealthTracker(1)
    for _ in range(5):
        lone.record_flush(0, 500.0, error=True)
    assert not lone.should_defer(0)


# -- stream fit events ---------------------------------------------------------


@pytest.fixture(scope="module")
def drift_setup():
    stream, _ = jsyn.drift_stream(750, 3, seed=8)     # 6 batches, shift at 3
    xcs = np.stack([np.asarray(b.xc) for b in stream.batches(250)])
    xds = np.zeros(xcs.shape[:2] + (0,), np.int32)
    return plates(0, None, n_features=3, latent_card=2) + (xcs, xds)


def _port_fit(setup, xcs=None):
    _, _, _, tcp, tprior, tinit, xs, xds = setup
    xcs = xs if xcs is None else xcs
    return tst.stream_fit(tcp, tprior, tst.stream_init(tprior, tinit), xcs,
                          xds, **KW)


def test_stream_fit_events_match_reference_and_validators_cross(
        drift_setup, tmp_path):
    jcp, jprior, jinit = drift_setup[:3]
    xcs, xds = drift_setup[6:]
    with _obs_to(jobs, tmp_path, "basic", "ref.jsonl") as jpath:
        jst.stream_fit(jcp, jprior, jst.stream_init(jprior, jinit),
                       jnp.asarray(xcs), jnp.asarray(xds), **KW)
    with _obs_to(tobs, tmp_path, "basic", "port.jsonl") as tpath:
        _, info = _port_fit(drift_setup)
    # each package's validator accepts the other's file
    jc, tc = (jobs.validate_obs_events(jpath),
              tobs.validate_obs_events(jpath))
    assert jc == tc
    assert (jobs.validate_obs_events(tpath)
            == tobs.validate_obs_events(tpath))
    jev = [e for e in _events(jpath) if e["event"] != "kernel_dispatch"]
    tev = [e for e in _events(tpath) if e["event"] != "kernel_dispatch"]
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    assert tc["stream_batch"] == 6 and tc["drift"] >= 1
    base = ("ts", "seq", "run")
    for je, te in zip(jev, tev):
        assert set(te) == set(je), je["event"]
        for k in set(te) - set(base) - {"event"}:
            a, b = te[k], je[k]
            if isinstance(b, float):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                           err_msg=f"{je['event']}.{k}")
            else:
                assert a == b and type(a) is type(b), (je["event"], k)
    # both emit a kernel_dispatch snapshot: route labels differ by design
    # (pallas/interpret/einsum against cuda/einsum), kernel names agree
    (jk,) = [e for e in _events(jpath) if e["event"] == "kernel_dispatch"]
    (tk,) = [e for e in _events(tpath) if e["event"] == "kernel_dispatch"]
    assert tk["site"] == jk["site"] == "stream_fit"
    assert ({k.split(":")[0] for k in tk["counts"]}
            == {k.split(":")[0] for k in jk["counts"]})
    # one reduction a batch for the drift score, one a sweep of its fit
    assert tk["counts"] == {
        "clg_suffstats:einsum": 6 + int(info["sweeps"].sum())}
    # the events read the info columns
    evs = [e for e in _events(tpath) if e["event"] == "stream_batch"]
    assert [e["elbo"] for e in evs] == info["elbo"].tolist()
    assert sum(e["n_eff"] for e in evs) == 1500.0


@pytest.mark.parametrize("level", ["basic", "trace"])
def test_obs_levels_give_the_same_bits(drift_setup, tmp_path, level):
    with _obs_to(tobs, tmp_path, "off") as path:
        s_off, i_off = _port_fit(drift_setup)
    assert not (tmp_path / "events.jsonl").exists(), \
        "REPRO_OBS=off must never open the sink"
    with _obs_to(tobs, tmp_path, level, "on.jsonl") as path:
        s_on, i_on = _port_fit(drift_setup)
        assert tobs.validate_obs_events(path)["stream_batch"] == 6
    from _torch_parity import trees_equal

    assert trees_equal(s_off, s_on)
    for k in i_off:
        assert torch.equal(i_off[k], i_on[k]), k


def test_stream_update_emits_one_batch(drift_setup, tmp_path):
    _, _, _, tcp, tprior, tinit, xcs, xds = drift_setup
    with _obs_to(tobs, tmp_path, "basic") as path:
        tst.stream_update(tcp, tprior, tst.stream_init(tprior, tinit),
                          torch.from_numpy(xcs[0]), torch.from_numpy(xds[0]),
                          sweeps=3)
        counts = tobs.validate_obs_events(path)
    assert counts == {"stream_batch": 1, "kernel_dispatch": 1}
    (ev,) = [e for e in _events(path) if e["event"] == "stream_batch"]
    assert ev["t"] == 0 and ev["drifted"] is False and ev["sweeps"] == 3


def test_quarantine_events_match_reference(drift_setup, tmp_path):
    jcp, jprior, jinit = drift_setup[:3]
    xcs, xds = drift_setup[6:]
    bad = xcs.copy()
    bad[[1, 4]] = np.nan
    with _obs_to(jobs, tmp_path, "basic", "ref.jsonl") as jpath:
        jst.stream_fit(jcp, jprior, jst.stream_init(jprior, jinit),
                       jnp.asarray(bad), jnp.asarray(xds), **KW)
    with _obs_to(tobs, tmp_path, "basic", "port.jsonl") as tpath:
        _port_fit(drift_setup, bad)
    pick = lambda p: [(e["t"], e["site"]) for e in _events(p)
                      if e["event"] == "quarantine"]
    assert pick(tpath) == pick(jpath) == [(1, "stream"), (4, "stream")]
    assert tobs.REGISTRY.snapshot() == {"metrics": []}   # reset on exit


def test_local_step_with_metrics_matches_reference():
    jcp, _, jinit, tcp, _, tinit = plates(2, None, n_features=3,
                                          latent_card=2)
    xc = np.random.default_rng(3).standard_normal((300, 3), np.float32)
    xd = np.zeros((300, 0), np.int32)
    mask = np.concatenate([np.ones(260), np.zeros(40)]).astype(np.float32)
    T = lambda a: torch.from_numpy(a)
    for chunk in (None, 128):
        _, _, jm = jvmp.local_step(jcp, jinit, jnp.asarray(xc),
                                   jnp.asarray(xd), jnp.asarray(mask),
                                   chunk=chunk, with_metrics=True)
        ts, tr, tm = tvmp.local_step(tcp, tinit, T(xc), T(xd), T(mask),
                                     chunk=chunk, with_metrics=True)
        assert tm.chunk_n_eff.tolist() == np.asarray(jm.chunk_n_eff).tolist()
        s0, r0 = tvmp.local_step(tcp, tinit, T(xc), T(xd), T(mask),
                                 chunk=chunk)
        assert torch.equal(r0, tr) and torch.equal(s0.local_elbo,
                                                   ts.local_elbo)
    assert tm.chunk_n_eff.tolist() == [128.0, 128.0, 4.0]


# -- the exact engine and the serving engine -----------------------------------


def _exact_queries():
    return [("D0", {"D2": 1, "D3": 2}), ("D0", {"D2": 0, "D3": 0}),
            ("D0", {"D3": 1})]


def _run_engine(mod_engine, bn, batches):
    eng = mod_engine(bn, mode="exact", **({} if mod_engine is not
                                          PGMQueryEngine else
                                          {"device": "cpu"}))
    out = []
    for qs in batches:
        subs = [eng.submit(t, e) for t, e in qs]
        eng.flush()
        out.append([q.result for q in subs])
    return out


def test_serve_exact_telemetry_matches_reference(tmp_path):
    from repro.serve.engine import PGMQueryEngine as JEngine

    jbn = jsyn.random_discrete_bn(4, card=3, seed=0, tree=True)
    tbn = bn_to_port(jbn)
    batches = [_exact_queries(),
               [("D0", {"D2": 2, "D3": 1}), ("D0", {"D2": 1, "D3": 0})]]
    with _obs_to(jobs, tmp_path, "trace", "ref.jsonl") as jpath:
        _run_engine(JEngine, jbn, batches)
    with _obs_to(tobs, tmp_path, "trace", "port.jsonl") as tpath:
        _run_engine(PGMQueryEngine, tbn, batches)
        counts = tobs.validate_obs_events(tpath)
    jcounts = jobs.validate_obs_events(jpath)
    assert counts == jcounts
    assert counts["serve_flush"] == 2 and counts["serve_bucket"] == 3
    assert counts["jt_plan"] == 2
    pick = lambda p, ev, keys: [tuple(e[k] for k in keys)
                                for e in _events(p) if e["event"] == ev]
    for ev, keys in (("jt_plan", ("pipeline", "n_cliques", "levels",
                                  "batch", "schema", "bucketed")),
                     ("serve_bucket", ("mode", "schema", "batch",
                                       "queue_depth", "cache_hit")),
                     ("serve_flush", ("mode", "n_queries", "n_buckets"))):
        assert pick(tpath, ev, keys) == pick(jpath, ev, keys), ev
    tev = _events(tpath)
    buckets = [e for e in tev if e["event"] == "serve_bucket"]
    assert all(b["latency_us"] > 0 and b["execute_us"] >= 0 for b in buckets)
    assert [b["compile_us"] > 0 for b in buckets] == [True, True, False]
    spans = {e["span_id"]: e for e in tev if e["event"] == "span"}
    assert (sorted(s["name"] for s in spans.values())
            == sorted(e["name"] for e in _events(jpath)
                      if e["event"] == "span"))
    for s in spans.values():
        if s["name"] == "serve.flush":
            assert s["parent_id"] is None
        elif s["name"] == "serve.bucket":
            assert spans[s["parent_id"]]["name"] == "serve.flush"
        else:
            assert spans[s["parent_id"]]["name"] == "serve.bucket"


def test_serve_off_no_events_and_identical_posteriors(tmp_path):
    tbn = bn_to_port(jsyn.random_discrete_bn(4, card=3, seed=0, tree=True))
    with _obs_to(tobs, tmp_path, "off"):
        off = _run_engine(PGMQueryEngine, tbn, [_exact_queries()])
        assert not (tmp_path / "events.jsonl").exists()
    with _obs_to(tobs, tmp_path, "trace", "on.jsonl"):
        on = _run_engine(PGMQueryEngine, tbn, [_exact_queries()])
    for a, b in zip(off[0], on[0]):
        assert np.array_equal(a, b)


def test_serve_vmp_and_temporal_telemetry(tmp_path):
    from repro_torch.data import synthetic as tsyn
    from repro_torch.pgm_models import GaussianMixture, HiddenMarkovModel

    s, _, _ = tsyn.gmm_stream(400, 3, 4, seed=1)
    m = GaussianMixture(s.attributes, n_states=3, device="cpu")
    m.update_model(s)
    xs = s.collect().xc
    batches, attrs, _ = tsyn.hmm_stream(n_batches=2, s=8, t=6, states=2,
                                        f=2, seed=0)
    hmm = HiddenMarkovModel(attrs, n_states=2, seed=0, device="cpu")
    with _obs_to(tobs, tmp_path, "basic") as path:
        eng = PGMQueryEngine(m, mode="vmp")
        for rows in (range(3), range(3, 6)):
            for b in rows:
                eng.submit("Z", {f"X{i}": float(xs[b, i]) for i in range(4)})
            eng.flush()
        hmm.update_model(batches[0], sweeps=3)
        teng = PGMQueryEngine(hmm, mode="temporal")
        for b in range(3):
            teng.submit("predict", {"horizon": 2}, payload=batches[1].xc[b])
        teng.flush()
        counts = tobs.validate_obs_events(path)
    evs = _events(path)
    vb = [e for e in evs if e["event"] == "serve_bucket"
          and e["mode"] == "vmp"]
    assert [b["cache_hit"] for b in vb] == [False, True]
    (tp,) = [e for e in evs if e["event"] == "temporal_plan"]
    assert (tp["batch"], tp["T"], tp["S"], tp["horizon"]) == (4, 6, 2, 2)
    (tf,) = [e for e in evs if e["event"] == "temporal_fit"]
    assert tf["model"] == "HiddenMarkovModel" and 1 <= tf["sweeps"] <= 3
    assert counts["serve_flush"] == 3


def test_temporal_events_match_reference(tmp_path):
    """seq_stream_fit from the reference's initial posterior (the setting of
    ``test_torch_temporal.py``): the same events, flags and sweeps, ELBO at
    rtol 1e-4."""
    from repro.pgm_models import dynamic as jdyn
    from repro_torch import convert
    from repro_torch.data import synthetic as tsyn
    from repro_torch.pgm_models import dynamic as tdyn

    kw = dict(n_batches=5, s=12, t=10, states=2, f=2, shift=8.0, seed=10)
    jb, attrs, _ = jsyn.hmm_stream(**kw)
    tb, _, _ = tsyn.hmm_stream(**kw)
    jm = jdyn.HiddenMarkovModel(attrs, n_states=2, seed=0)
    tm = tdyn.HiddenMarkovModel(attrs, n_states=2, seed=0, device="cpu")
    tm.posterior = convert.hmm_posterior_from_numpy(jm.posterior, "cpu")
    with _obs_to(jobs, tmp_path, "basic", "ref.jsonl") as jpath:
        jdyn.seq_stream_fit(jm, jb, sweeps=5, tol=0.0)
    with _obs_to(tobs, tmp_path, "basic", "port.jsonl") as tpath:
        tdyn.seq_stream_fit(tm, tb, sweeps=5, tol=0.0)
    j = [e for e in _events(jpath) if e["event"] != "kernel_dispatch"]
    t = [e for e in _events(tpath) if e["event"] != "kernel_dispatch"]
    assert [(e["event"], e.get("t")) for e in t] == \
        [(e["event"], e.get("t")) for e in j]
    assert any(e["event"] == "drift" for e in t)
    for je, te in zip(j, t):
        assert set(te) == set(je)
        if te["event"] == "stream_batch":
            assert (te["drifted"], te["sweeps"]) == (je["drifted"],
                                                     je["sweeps"])
        np.testing.assert_allclose(te["score"], je["score"], rtol=1e-4,
                                   atol=1e-4)
    # the einsum M-step dispatches no kernel wrapper in either package
    kd = lambda p: [e for e in _events(p) if e["event"] == "kernel_dispatch"]
    assert kd(tpath) == kd(jpath) == []


def test_data_quarantine_event(tmp_path):
    from repro_torch.data.stream import FINITE, REAL, Attribute, DataStream

    xc = np.zeros((6, 2), np.float32)
    xc[1, 0] = np.nan
    xd = np.zeros((6, 1), np.int32)
    xd[4, 0] = 5
    ds = DataStream([Attribute("a", REAL), Attribute("b", REAL),
                     Attribute("c", FINITE, 2)],
                    lambda: iter([(xc[:3], xd[:3]), (xc[3:], xd[3:])]),
                    validate=True)
    with _obs_to(tobs, tmp_path, "basic") as path:
        ds.collect()
        snap = tobs.REGISTRY.snapshot()
    q = [(e["t"], e["site"], e["dropped"]) for e in _events(path)
         if e["event"] == "quarantine"]
    assert q == [(0, "data", 1), (1, "data", 1)]
    (c,) = snap["metrics"]
    assert c["name"] == "quarantine_total" and c["value"] == 2.0


# -- kernel dispatch counters ---------------------------------------------------


def test_kernel_dispatch_counts(tmp_path):
    from repro_torch.kernels import factor_ops

    x = torch.zeros((2, 4, 8))
    with _obs_to(tobs, tmp_path, "basic") as path:
        assert tobs.kernel_counts() == {}
        factor_ops.log_marginalize(x)
        factor_ops.log_marginalize(x)
        factor_ops.log_product(x, torch.zeros((2, 8)))
        kc = tobs.kernel_counts()
        tobs.emit_kernel_counts(site="test")
        snap = tobs.REGISTRY.snapshot()
        ev = [e for e in _events(path) if e["event"] == "kernel_dispatch"]
    assert kc == {"log_marginalize:einsum": 2, "log_product:einsum": 1}
    assert ev[0]["counts"] == kc and ev[0]["site"] == "test"
    assert {(e["labels"]["kernel"], e["value"]) for e in snap["metrics"]} \
        == {("log_marginalize:einsum", 2.0), ("log_product:einsum", 1.0)}


def test_kernel_counters_off_cost_nothing(tmp_path):
    from repro_torch.kernels import factor_ops

    with _obs_to(tobs, tmp_path, "off"):
        factor_ops.log_marginalize(torch.zeros((2, 4, 8)))
        assert tobs.kernel_counts() == {}
        tobs.emit_kernel_counts()
        assert not (tmp_path / "events.jsonl").exists()


def test_kernel_counts_exact_under_many_threads(tmp_path, monkeypatch):
    """At least eight threads (more than the cores) of plain-route wrapper
    calls, with a short switch interval, count every dispatch, and the
    shared ``_launch`` counts every launch (its CUDA calls stubbed, so the
    lock and the counters run here)."""
    import os
    import sys

    from repro_torch.kernels import clg_stats, factor_ops

    n_threads = min(64, max(8, (os.cpu_count() or 1) + 1))
    n = 2400 // n_threads
    x, b = torch.zeros((2, 4, 8)), torch.zeros((2, 8))
    xd = torch.zeros((16, 2), dtype=torch.int32)
    r = torch.ones((16, 3))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    counts = {"fake": 0}
    dev = torch.device("cuda", 0)
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for _ in range(n):
            factor_ops.log_product(x, b)
            clg_stats.clg_disc_counts(xd, r, 4)
            clg_stats._launch(counts, "fake", dev, lambda stream: 0)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _obs_to(tobs, tmp_path, "basic"):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            kc = tobs.kernel_counts()
    finally:
        sys.setswitchinterval(switch)
    total = n_threads * n
    assert counts["fake"] == total
    assert kc == {"log_product:einsum": total,
                  "clg_disc_counts:einsum": total, "fake:cuda": total}


# -- sink mechanics ----------------------------------------------------------------


def test_span_null_below_trace(tmp_path):
    with _obs_to(tobs, tmp_path, "basic") as path:
        with tobs.span("should.not.emit") as sp:
            assert sp.span_id is None
            sp.add(extra=1)
        assert tobs.current_span() is None
        tobs.emit("metric", name="x", value=1.0)
        counts = tobs.validate_obs_events(path)
    assert "span" not in counts and counts["metric"] == 1


def test_span_error_stamped_and_reraised(tmp_path):
    with _obs_to(tobs, tmp_path, "trace") as path:
        with pytest.raises(KeyError):
            with tobs.span("boom.region", tag="x") as outer:
                assert tobs.current_span() is outer
                with tobs.span("inner") as inner:
                    assert inner.parent_id == outer.span_id
                raise KeyError("inner failure")
        spans = [e for e in _events(path) if e["event"] == "span"]
    assert [s["name"] for s in spans] == ["inner", "boom.region"]
    assert spans[1]["error"] == "KeyError" and spans[1]["tag"] == "x"
    assert "error" not in spans[0] and spans[1]["dur_us"] >= 0


def _line(**kw):
    base = {"ts": 1.0, "seq": kw.pop("seq", 1), "run": "r1",
            "event": "metric", "name": "x", "value": 0}
    base.update(kw)
    return json.dumps(base)


def test_validate_obs_events_rejects_malformed_like_reference():
    cases = [(["{not json"], "invalid JSON"),
             ([_line(event="nope")], "unknown event"),
             (['{"ts": 1.0, "seq": 1, "event": "log"}'], "missing base field"),
             (['{"ts": 1.0, "seq": 1, "run": "r", "event": "drift", "t": 0}'],
              "missing field"),
             ([_line(seq=2), _line(seq=2)], "not monotone")]
    for lines, msg in cases:
        for mod in (tobs, jobs):
            with pytest.raises(ValueError, match=msg):
                mod.validate_obs_events(lines)
    ok = [_line(seq=5), _line(seq=3, run="r2")]
    assert tobs.validate_obs_events(ok) == {"metric": 2}
    assert tobs.EVENT_SCHEMA == jobs.EVENT_SCHEMA


def test_configure_restores_previous_and_log(tmp_path, capsys):
    prev = tobs.configure(level="basic", path=str(tmp_path / "a.jsonl"))
    try:
        assert tobs.enabled() and not tobs.enabled(tobs.TRACE)
        with pytest.raises(ValueError, match="unknown obs level"):
            tobs.configure(level="loud")
        tobs.log("hello", component="test", n=3)
    finally:
        back = tobs.configure(level=prev["level"], path=prev["path"])
    assert back == {"level": "basic", "path": str(tmp_path / "a.jsonl")}
    assert "hello" in capsys.readouterr().err
    evs = _events(tmp_path / "a.jsonl")
    assert [e["event"] for e in evs] == ["log"]
    assert evs[0]["n"] == 3
