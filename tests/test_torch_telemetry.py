"""The port's telemetry (``repro_torch.serve.telemetry``) against the
reference's (``repro.serve.telemetry``) on the CPU.

  * the cases of ``tests/test_telemetry.py``, run on the port;
  * the same observations through both registries: counts and buckets
    equal exactly, ``sum`` / ``mean`` within ``SUM_RTOL`` (the reference's
    merge adds a histogram's total as one term, so a merged sum may sit an
    ulp from the sum of the observations, ROADMAP §3); the parsed
    Prometheus samples equal; the Chrome trace has the reference's schema
    (``ph``, ``pid`` the lane, ``tid`` the shard, ``process_name``
    metadata);
  * a served trace with telemetry on both packages: the same counters,
    histogram counts, gauge names and span counts, with the lane labels;
  * ``annotate=True`` puts ``torch.profiler.record_function`` ranges
    around the spans.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.launch.serve import run_continuous as ref_run_continuous
from repro.models import TransformerLM as RefLM
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import telemetry as ref_tele
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.launch import serve as cli
from repro_torch.serve import engine
from repro_torch.serve.telemetry import (NULL_TELEMETRY, MetricsRegistry,
                                         StepTracer, StreamingHistogram,
                                         Telemetry, default_edges)

import jax

SUM_RTOL = 1e-12


# ------------------------------------------------- streaming histograms

def test_histogram_exact_moments():
    h = StreamingHistogram()
    xs = [0.001, 0.01, 0.25, 1.5, 80.0]
    for x in xs:
        h.observe(x)
    assert h.count == len(xs)
    assert h.total == pytest.approx(sum(xs))
    assert h.vmin == min(xs) and h.vmax == max(xs)
    assert h.mean == pytest.approx(np.mean(xs))


def test_histogram_percentile_bounds_and_order():
    h = StreamingHistogram()
    xs = np.random.default_rng(0).lognormal(-3, 2, size=500)
    for x in xs:
        h.observe(float(x))
    qs = [h.percentile(q) for q in (0, 25, 50, 75, 95, 100)]
    assert qs == sorted(qs)
    assert all(h.vmin <= v <= h.vmax for v in qs)
    exact = float(np.percentile(xs, 50))
    i = int(np.searchsorted(h.edges, exact))
    lo = h.edges[max(i - 2, 0)]
    hi = h.edges[min(i + 1, len(h.edges) - 1)]
    assert lo <= h.percentile(50) <= hi


def test_histogram_merge_equals_concat():
    a, b, both = (StreamingHistogram() for _ in range(3))
    rng = np.random.default_rng(1)
    for x in rng.exponential(0.05, size=64):
        a.observe(float(x))
        both.observe(float(x))
    for x in rng.exponential(5.0, size=64):
        b.observe(float(x))
        both.observe(float(x))
    a.merge(b)
    assert a.snapshot() == both.snapshot()


def test_histogram_merge_requires_identical_edges():
    with pytest.raises(ValueError):
        StreamingHistogram().merge(
            StreamingHistogram(edges=default_edges(per_decade=8)))


def _assert_hist_snapshots_match(got, want):
    """Counts and buckets exactly, sums and means within SUM_RTOL."""
    for k in ("count", "min", "max", "buckets"):
        assert got[k] == want[k], k
    for k in ("sum", "mean", "p50", "p95", "p99"):
        assert got[k] == pytest.approx(want[k], rel=SUM_RTOL, abs=0), k


# the reference property's failing example (ROADMAP §3), then seeded lists
# over its strategy (floats in [1e-6, 1e3], up to 40 each)
MERGE_CASES = [([1e-06], [32.0, 480.9305111679527])] + [
    tuple(list(np.random.default_rng(s).uniform(1e-6, 1e3, size=n))
          for n in np.random.default_rng(s + 100).integers(0, 41, size=2))
    for s in range(8)]


@pytest.mark.parametrize("xs,ys", MERGE_CASES)
def test_histogram_merge_property(xs, ys):
    """Merging equals observing the concatenation: counts and buckets
    exactly, sum and mean within SUM_RTOL — also for the reference's own
    failing example."""
    a, b, both = (StreamingHistogram() for _ in range(3))
    for x in xs:
        a.observe(x)
        both.observe(x)
    for y in ys:
        b.observe(y)
        both.observe(y)
    a.merge(b)
    assert a.count == both.count == len(xs) + len(ys)
    _assert_hist_snapshots_match(a.snapshot(), both.snapshot())


# ------------------------------------------------- registry + prometheus

def test_registry_labels_and_values():
    reg = MetricsRegistry()
    reg.inc("preempts", lane=0, shard=1)
    reg.inc("preempts", 2, lane=0, shard=1)
    reg.inc("preempts", lane=1, shard=0)
    reg.gauge("pool_occupancy", 0.5, lane=0, shard=0)
    assert reg.value("preempts", lane=0, shard=1) == 3
    assert reg.value("preempts", lane=1, shard=0) == 1
    assert reg.value("preempts", lane=9, shard=9) == 0
    assert reg.value("pool_occupancy", lane=0, shard=0) == 0.5
    assert reg.value("preempts", shard=1, lane=0) == 3


def test_registry_snapshot_and_prometheus():
    reg = MetricsRegistry()
    reg.inc("preempts", 3, lane=0, shard=1)
    reg.observe("ttft_s", 0.25, lane=0)
    snap = reg.snapshot()
    assert {r["name"] for r in snap["counters"]} == {"preempts"}
    (h,) = snap["histograms"]
    assert h["name"] == "ttft_s" and h["labels"] == {"lane": 0}
    assert h["count"] == 1 and h["sum"] == pytest.approx(0.25)
    text = reg.to_prometheus()
    assert "# TYPE repro_preempts counter" in text
    assert 'repro_preempts{lane="0",shard="1"} 3' in text
    assert "# TYPE repro_ttft_s histogram" in text
    assert 'repro_ttft_s_count{lane="0"} 1' in text
    assert 'le="+Inf"' in text


def test_registry_merge_across_workers():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.inc("tokens_generated", 5, lane=0)
    b.inc("tokens_generated", 7, lane=0)
    b.observe("ttft_s", 0.1, lane=0)
    a.merge(b)
    assert a.value("tokens_generated", lane=0) == 12
    assert a.hist("ttft_s", lane=0).count == 1


def _feed(reg, seed):
    """A seeded mix of counters, gauges and histograms over lane / shard
    labels, in two registries merged into the first."""
    rng = np.random.default_rng(seed)
    other = type(reg)()
    for r in (reg, other):
        for _ in range(40):
            lane, shard = int(rng.integers(0, 3)), int(rng.integers(0, 2))
            r.inc("preempts", int(rng.integers(1, 4)), lane=lane,
                  shard=shard)
            r.gauge("pool_occupancy", float(rng.uniform()), lane=lane,
                    shard=shard)
            r.observe("decode_step_s", float(rng.lognormal(-4, 1.5)),
                      lane=lane, shard=shard)
            r.observe("ttft_s", float(rng.exponential(0.2)), lane=lane)
    reg.merge(other)
    return reg


def _prom_samples(text):
    """{(metric, labels): value} of a Prometheus text exposition, and the
    set of its TYPE lines."""
    samples, types = {}, set()
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            types.add(line)
            continue
        head, value = line.rsplit(" ", 1)
        samples[head] = float(value)
    return samples, types


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registries_agree_with_the_reference(seed):
    """The same observations through both registries: snapshots equal
    (histogram counts and buckets exactly, sums within SUM_RTOL) and the
    parsed Prometheus samples equal."""
    got = _feed(MetricsRegistry(), seed)
    want = _feed(ref_tele.MetricsRegistry(), seed)
    g, w = got.snapshot(), want.snapshot()
    assert g["counters"] == w["counters"]
    assert g["gauges"] == w["gauges"]
    assert len(g["histograms"]) == len(w["histograms"])
    for gh, wh in zip(g["histograms"], w["histograms"]):
        assert (gh["name"], gh["labels"]) == (wh["name"], wh["labels"])
        _assert_hist_snapshots_match(gh, wh)
    gs, gt = _prom_samples(got.to_prometheus())
    ws, wt = _prom_samples(want.to_prometheus())
    assert gt == wt and gs.keys() == ws.keys()
    for k, v in gs.items():
        assert v == pytest.approx(ws[k], rel=SUM_RTOL, abs=0), k


# ------------------------------------------------- chrome trace tracer

def test_tracer_chrome_schema_roundtrip(tmp_path):
    tr = StepTracer()
    tr.process_name(0, "lane 0 (N=2)")
    t0 = tr.now_us()
    tr.complete("decode", t0, 120.0, pid=0, tid=1, args={"rows": 2})
    tr.instant("preempt", pid=0, tid=1, args={"row": 3})
    path = tmp_path / "trace.json"
    tr.export(path)
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} <= {"X", "i", "M"}
    meta = [e for e in evs if e["ph"] == "M"]
    assert meta and meta[0]["name"] == "process_name"
    x = next(e for e in evs if e["ph"] == "X")
    assert x["name"] == "decode" and x["dur"] == pytest.approx(120.0)
    assert x["pid"] == 0 and x["tid"] == 1 and x["args"] == {"rows": 2}
    i = next(e for e in evs if e["ph"] == "i")
    assert i["s"] == "t" and i["args"] == {"row": 3}
    assert doc["otherData"]["dropped_events"] == 0


def test_tracer_ring_buffer_drops_oldest():
    tr = StepTracer(capacity=4)
    for k in range(10):
        tr.instant(f"e{k}", pid=0, tid=0)
    evs = [e for e in tr.chrome_trace()["traceEvents"] if e["ph"] == "i"]
    assert [e["name"] for e in evs] == ["e6", "e7", "e8", "e9"]
    assert tr.chrome_trace()["otherData"]["dropped_events"] == 6


def _record(tele):
    tele.tracer.process_name(2, "lane 2 (N=4) [decode]")
    with tele.span("decode", lane=2, shard=0, metric="decode_step_s",
                   rows=4):
        pass
    tele.instant("handoff", lane=1, dst_lane=2, row=0)
    return tele.tracer.chrome_trace()


def test_chrome_trace_schema_matches_the_reference():
    """Same calls, same event schema: keys, ph, pid = lane, tid = shard,
    args, and the process_name metadata rows."""
    got, want = _record(Telemetry()), _record(ref_tele.Telemetry())
    strip = lambda d: [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                       for e in d["traceEvents"]]
    assert strip(got) == strip(want)
    assert got.keys() == want.keys()
    assert got["otherData"] == want["otherData"]
    assert ({k for e in got["traceEvents"] for k in e}
            == {k for e in want["traceEvents"] for k in e})


# ------------------------------------------------- telemetry facade

def test_null_telemetry_is_inert():
    tele = NULL_TELEMETRY
    with tele.span("decode", lane=0, metric="decode_step_s"):
        pass
    tele.inc("preempts", lane=0)
    tele.observe("ttft_s", 0.1, lane=0)
    tele.gauge("pool_occupancy", 0.3, lane=0, shard=0)
    tele.instant("cancel", lane=0)
    tele.maybe_snapshot(0)
    assert tele.registry.snapshot() == {"counters": [], "gauges": [],
                                        "histograms": []}
    assert tele.snapshots == []
    assert tele.tracer.chrome_trace()["traceEvents"] == []
    assert tele.span("a") is tele.span("b")


def test_enabled_span_records_metric_and_event():
    tele = Telemetry()
    with tele.span("decode", lane=1, shard=2, metric="decode_step_s",
                   rows=4):
        pass
    h = tele.registry.hist("decode_step_s", lane=1, shard=2)
    assert h is not None and h.count == 1
    (x,) = [e for e in tele.tracer.chrome_trace()["traceEvents"]
            if e["ph"] == "X"]
    assert (x["name"], x["pid"], x["tid"]) == ("decode", 1, 2)
    assert x["args"]["rows"] == 4


def test_snapshot_interval_and_exports(tmp_path):
    tele = Telemetry(snapshot_every=2)
    for step in range(1, 7):
        tele.inc("tokens_generated", lane=0)
        tele.maybe_snapshot(step)
    assert [s["step"] for s in tele.snapshots] == [2, 4, 6]
    assert [s["counters"][0]["value"] for s in tele.snapshots] == [2, 4, 6]
    mpath = tmp_path / "metrics.json"
    prom = tele.write_metrics(mpath)
    doc = json.loads(mpath.read_text())
    assert len(doc["snapshots"]) == 3
    assert doc["final"]["counters"][0]["value"] == 6
    assert prom.suffix == ".prom"
    assert "repro_tokens_generated" in prom.read_text()
    tpath = tmp_path / "trace.json"
    tele.write_trace(tpath)
    assert "traceEvents" in json.loads(tpath.read_text())


def test_annotate_wraps_spans_in_record_function():
    """annotate=True: each span is a ``torch.profiler.record_function``
    range, visible in a profile of the host; off, none appears."""
    for annotate in (True, False):
        tele = Telemetry(annotate=annotate)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tele.span("engine_step", lane=0):
                torch.ones(4).add_(1)
        names = {e.key for e in prof.key_averages()}
        assert ("engine_step" in names) == annotate


# ------------------------------------------------- a served trace

CAPACITY, BLOCK, ROWS = 20, 4, 2


def _trace(cfg):
    rng = np.random.default_rng(7)
    return [(s, rng.integers(4, cfg.vocab_size, size=(n,)), m)
            for s, n, m in ((0, 5, 4), (0, 9, 3), (2, 3, 5), (5, 7, 2))]


def test_served_trace_records_what_the_reference_records():
    """Reduced qwen2-1.5b, N=2, paged chunked, the same trace and weights
    on both packages with telemetry on: identical tokens, counters
    (tokens, requests, step signatures), histogram counts per label,
    gauge names, span counts per name and lane, and snapshot steps."""
    cfg_r = ref_config("qwen2-1.5b", reduced=True)
    cfg = get_config("qwen2-1.5b", reduced=True)
    ref = RefLM.init(jax.random.PRNGKey(0), cfg_r, RefMux(n=2))
    port = interop.params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                         device="cpu")
    trace = _trace(cfg)
    tele, tele_r = Telemetry(snapshot_every=3), ref_tele.Telemetry(
        snapshot_every=3)
    got = cli.run_continuous(
        port, engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=2), capacity=CAPACITY,
                                 dtype=torch.float32, cache_layout="paged",
                                 block_size=BLOCK),
        ROWS, [(t, p.copy(), m) for t, p, m in trace], chunk=4,
        use_kernels=False, telemetry=tele, device="cpu")
    want = ref_run_continuous(
        ref, RefServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=2),
                            capacity=CAPACITY, dtype=jnp.float32,
                            cache_layout="paged", block_size=BLOCK),
        ROWS, [(t, p.copy(), m) for t, p, m in trace], chunk=4,
        telemetry=tele_r)
    assert ({r.uid: r.output for r in got["completed"]}
            == {r.uid: [int(t) for t in r.output]
                for r in want["completed"]})
    g, w = tele.registry.snapshot(), tele_r.registry.snapshot()
    assert g["counters"] == w["counters"]
    assert ([(h["name"], h["labels"], h["count"]) for h in g["histograms"]]
            == [(h["name"], h["labels"], h["count"])
                for h in w["histograms"]])
    assert ([(x["name"], x["labels"]) for x in g["gauges"]]
            == [(x["name"], x["labels"]) for x in w["gauges"]])
    count = lambda t: sorted(
        (e["ph"], e["name"], e["pid"], e["tid"])
        for e in t.tracer.chrome_trace()["traceEvents"])
    assert count(tele) == count(tele_r)
    assert ([s["step"] for s in tele.snapshots]
            == [s["step"] for s in tele_r.snapshots])
    assert (tele.registry.hist("decode_step_s", lane=0, shard=0).count
            == got["decode_steps"])
