"""Serving observability in the port (container_engine_accelerators_tpu_
torch/serving/observe.py and otel.py) against the reference's modules:
every registry, text-format, flight-recorder and trace-model case runs
once on each package's modules (one body holds the port to the
reference), and the port's instrumented engine is held to the
reference's on the same numpy-drawn weights and traffic (f32, CPU):
equal histogram counts, the same /metrics series, the same trace stages.
The twin of tests/test_observe.py and of the primitive cases of
tests/test_tracing.py, with the client-timing drift guard ported."""

import bisect
import io
import json
import threading
import time

import pytest

from _torch_port import (
    PAGE, draw_params, jax_decoder, jax_params, port_model, rand_prompt,
)
from container_engine_accelerators_tpu.serving import observe as ref_observe
from container_engine_accelerators_tpu.serving import otel as ref_otel
from container_engine_accelerators_tpu.serving.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine,
)
from container_engine_accelerators_tpu_torch.serving import observe
from container_engine_accelerators_tpu_torch.serving import otel


@pytest.fixture(params=["jax", "torch"])
def mods(request):
    """(observe, otel) of the reference or of the port."""
    if request.param == "jax":
        return ref_observe, ref_otel
    return observe, otel


# -- registry primitives ---------------------------------------------------
class TestRegistryPrimitives:
    def test_counter_inc_and_monotonicity(self, mods):
        ob, _ = mods
        r = ob.Registry()
        c = r.counter("t_total", "help", labelnames=("route",))
        c.inc(1.0, "a")
        c.inc(2.5, "a")
        c.inc(1.0, "b")
        assert c.value("a") == 3.5
        assert c.value("b") == 1.0
        with pytest.raises(ValueError):
            c.inc(-1.0, "a")

    def test_label_arity_and_names_enforced(self, mods):
        ob, _ = mods
        r = ob.Registry()
        c = r.counter("t_total", "help", labelnames=("route",))
        with pytest.raises(ValueError):
            c.inc(1.0)
        with pytest.raises(ValueError):
            c.inc(1.0, "a", "b")
        with pytest.raises(ValueError):
            r.counter("bad name", "help")
        with pytest.raises(ValueError):
            r.gauge("ok", "help", labelnames=("bad-label",))

    def test_schema_conflict_rejected_get_or_create_idempotent(self, mods):
        ob, _ = mods
        r = ob.Registry()
        c1 = r.counter("x_total", "help")
        assert r.counter("x_total", "help") is c1
        with pytest.raises(ValueError):
            r.gauge("x_total", "help")
        with pytest.raises(ValueError):
            r.counter("x_total", "help", labelnames=("l",))
        h1 = r.histogram("h_seconds", "help", buckets=(0.1, 1.0))
        assert r.histogram("h_seconds", "help", buckets=(1.0, 0.1)) is h1
        with pytest.raises(ValueError):
            r.histogram("h_seconds", "help", buckets=(0.5,))

    def test_histogram_buckets_sum_count(self, mods):
        ob, _ = mods
        h = ob.Registry().histogram("h_seconds", "help",
                                    buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v)
        counts, total, n = h.state()
        assert counts == [1, 2, 1, 1]
        assert n == 5
        assert abs(total - 56.05) < 1e-9

    def test_histogram_quantile_and_window_diff(self, mods):
        ob, _ = mods
        h = ob.Histogram("h", "help", buckets=(1.0, 2.0, 4.0))
        for v in (0.5, 1.5, 3.0, 3.5):
            h.observe(v)
        assert h.quantile(0.5) == pytest.approx(2.0)
        h.observe(100.0)
        assert h.quantile(0.99) == pytest.approx(4.0)
        assert ob.Histogram("e", "h", buckets=(1.0,)).quantile(0.5) is None
        before = h.state()
        for v in (3.0, 3.0, 3.0):
            h.observe(v)
        delta = [a - b for a, b in zip(h.state()[0], before[0])]
        q = ob.quantile_from_counts(h.bounds, delta, 0.5)
        assert 2.0 < q <= 4.0

    def test_same_histogram_names_and_buckets_as_the_reference(self, mods):
        ob, _ = mods
        eo = ob.EngineObservability()
        ref = ref_observe.EngineObservability()
        for name in ("ttft", "itl", "queue_wait", "chunk", "commit_lag",
                     "spec_accept"):
            mine, want = getattr(eo, name), getattr(ref, name)
            assert (mine.name, mine.bounds) == (want.name, want.bounds)
        assert ob.TTFT_BUCKETS == ref_observe.TTFT_BUCKETS
        assert ob.ITL_BUCKETS == ref_observe.ITL_BUCKETS
        assert ob.SPEC_ACCEPT_BUCKETS == ref_observe.SPEC_ACCEPT_BUCKETS


# -- text format -----------------------------------------------------------
class TestTextFormat:
    def test_render_parse_round_trip(self, mods):
        ob, _ = mods
        r = ob.Registry()
        r.counter("req_total", "requests", labelnames=("code",)).inc(
            3.0, "200")
        r.gauge("depth", "queue depth").set(7.0)
        h = r.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
        h.observe(0.05)
        h.observe(0.5)
        text = r.render()
        assert "# TYPE req_total counter" in text
        assert "# TYPE lat_seconds histogram" in text
        parsed = ob.parse_text(text)
        assert parsed["req_total"]['{code="200"}'] == 3.0
        assert parsed["depth"][""] == 7.0
        assert parsed["lat_seconds_bucket"]['{le="0.1"}'] == 1.0
        assert parsed["lat_seconds_bucket"]['{le="+Inf"}'] == 2.0
        assert parsed["lat_seconds_count"][""] == 2.0
        assert parsed["lat_seconds_sum"][""] == pytest.approx(0.55)
        # The other package's parser reads this render identically.
        other = observe if ob is ref_observe else ref_observe
        assert other.parse_text(text) == parsed

    def test_exemplars_openmetrics_only(self, mods):
        ob, _ = mods
        r = ob.Registry()
        r.counter("req_total", "requests").inc(1.0)
        h = r.histogram("lat_seconds", "latency", buckets=(1.0,))
        h.observe(0.5, exemplar="0000002a")
        classic = r.render()
        assert "trace_id" not in classic and "# EOF" not in classic
        om = r.render(openmetrics=True)
        assert 'trace_id="0000002a"' in om
        assert om.rstrip().endswith("# EOF")
        assert "# TYPE req counter" in om
        for text in (classic, om):
            parsed = ob.parse_text(text)
            assert parsed["lat_seconds_bucket"]['{le="1"}'] == 1.0
            assert parsed["req_total"][""] == 1.0

    def test_label_values_escaped(self, mods):
        ob, _ = mods
        r = ob.Registry()
        r.counter("x_total", "h", labelnames=("msg",)).inc(
            1.0, 'quote " and\nnewline')
        text = r.render()
        assert '\\"' in text and "\\n" in text
        assert ob.parse_text(text)["x_total"]

    def test_collector_containment_and_replacement(self, mods):
        ob, _ = mods
        r = ob.Registry()
        r.counter("live_total", "h").inc(1.0)

        def good(v):
            def collect():
                yield ob.MetricSnapshot("good_gauge", "gauge", "h",
                                        [({}, v)])
            return collect

        def broken():
            raise RuntimeError("provider exploded")

        r.register_collector("good", good(1.0))
        r.register_collector("broken", broken)
        parsed = ob.parse_text(r.render())
        assert parsed["live_total"][""] == 1.0
        assert parsed["good_gauge"][""] == 1.0
        assert not any(k.startswith("broken") for k in parsed)
        r.register_collector("good", good(2.0))  # replaces by name
        assert ob.parse_text(r.render())["good_gauge"][""] == 2.0

    def test_snapshot_helpers(self, mods):
        ob, _ = mods
        gauges = ob.snapshot_gauges({"a": 1, "b": 2.5, "flag": True,
                                     "events": [1]})
        assert [g.name for g in gauges] == ["serve_engine_a",
                                            "serve_engine_b"]
        merged = ob.merge_snapshots(
            ob.relabel_snapshots(gauges, engine=0)
            + ob.relabel_snapshots(gauges, engine=1)
        )
        assert [m.name for m in merged] == ["serve_engine_a",
                                            "serve_engine_b"]
        assert merged[0].samples == [({"engine": "0"}, 1.0),
                                     ({"engine": "1"}, 1.0)]


# -- flight recorder -------------------------------------------------------
class TestFlightRecorder:
    def test_ring_retains_last_n_oldest_first(self, mods):
        ob, _ = mods
        fr = ob.FlightRecorder(capacity=4)
        for i in range(10):
            fr.record("evt", i=i)
        assert [e["i"] for e in fr.events()] == [6, 7, 8, 9]
        assert fr.total == 10

    def test_dump_format_and_destination(self, mods):
        ob, _ = mods
        fr = ob.FlightRecorder(capacity=8)
        fr.record("admit", plen=5)
        fr.record("kill", err="boom")
        buf = io.StringIO()
        text = fr.dump("test death", file=buf)
        out = buf.getvalue()
        assert text in out
        assert "engine flight recorder (test death)" in out
        assert "admit" in out and "kill" in out and "err=boom" in out
        assert "+    0.000s" in out

    def test_concurrent_writers_never_lose_the_ring(self, mods):
        ob, _ = mods
        fr = ob.FlightRecorder(capacity=64)

        def writer(k):
            for i in range(200):
                fr.record("w", k=k, i=i)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert fr.total == 800
        assert len(fr.events()) == 64


# -- trace / span model ----------------------------------------------------
class TestTraceModel:
    def test_span_duration_and_open_spans(self, mods):
        _, ot = mods
        tr = ot.Trace()
        s = tr.span("queue_wait", 1.0, 1.5)
        assert s.duration_s == pytest.approx(0.5)
        assert tr.span("decode", 2.0).duration_s is None
        assert [x["name"] for x in tr.to_dict()["spans"]] == [
            "queue_wait", "decode"]

    def test_trace_ids_unique_and_ring_eviction(self, mods):
        _, ot = mods
        assert len({ot.new_trace_id() for _ in range(100)}) == 100
        ring = ot.TraceRing(capacity=3)
        traces = [ot.Trace() for _ in range(5)]
        for t in traces:
            ring.append(t)
        assert len(ring) == 3 and ring.total == 5
        assert [t.trace_id for t in ring.traces()] == [
            t.trace_id for t in traces[2:]]

    def test_context_codec_round_trip_and_rejects(self, mods):
        _, ot = mods
        ctx = ot.TraceContext.new()
        child = ctx.child("deadbeef")
        back = ot.TraceContext.from_wire(child.to_wire())
        assert (back.trace_id, back.parent_span_id) == (
            ctx.trace_id, "deadbeef")
        # The wire is shared: the other package decodes it the same.
        other = otel if ot is ref_otel else ref_otel
        assert other.TraceContext.from_wire(child.to_wire()).trace_id == (
            ctx.trace_id)
        for bad in ("", "garbage", "00-xyz-1-01", "01-aa-bb-01",
                    "00-aa-bb", "00--bb-01", "00-AA-bb-01"):
            with pytest.raises(ValueError):
                ot.TraceContext.from_wire(bad)

    def test_span_identity_graft_and_wire_dicts(self, mods):
        _, ot = mods
        t = ot.Trace(process="router")
        root = t.span("request", 0.0, 2.0)
        d = {"name": "decode", "start": 1.0, "end": 1.5,
             "process": "worker0:pid7", "parent_id": root.span_id,
             "attrs": {"row": 0}}
        grafted = t.graft(d)
        assert grafted.process == "worker0:pid7"
        assert grafted.parent_id == root.span_id
        assert t.graft({"start": "x"}) is None
        assert t.graft("not a dict") is None
        # A span dict crosses packages unchanged.
        other = otel if ot is ref_otel else ref_otel
        wire = root.to_dict()
        assert other.span_from_dict(wire).to_dict() == wire
        assert ot.span_from_dict(d).to_dict()["parent_id"] == root.span_id

    def test_stage_attribution_and_summary(self, mods):
        _, ot = mods
        t = ot.Trace()
        t.span("request", 0.0, 3.0)
        t.span("queue_wait", 0.0, 0.25)
        t.span("tier_fetch", 0.25, 0.5)
        t.span("prefill_chunk", 0.5, 1.0)
        t.span("prefill_handoff", 1.0, 1.25)
        t.span("migrate", 1.25, 1.5)
        t.span("decode", 1.5, 3.0)
        stages = ot.stage_durations(t)
        assert stages["queue"] == pytest.approx(0.25)
        assert stages["tier_fetch"] == pytest.approx(0.25)
        assert stages["prefill"] == pytest.approx(0.5)
        assert stages["migrate"] == pytest.approx(0.25)
        assert stages["decode"] == pytest.approx(1.5)
        assert ot.trace_total_s(t) == pytest.approx(3.0)
        other = otel if ot is ref_otel else ref_otel
        assert ot.trace_summary(t) == other.trace_summary(t)

    def test_tail_digest_and_tracez_payload(self, mods):
        _, ot = mods

        def trace(total, decode):
            t = ot.Trace()
            t.span("request", 0.0, total)
            t.span("decode", 0.0, decode)
            return t

        d = ot.TailDigest(capacity=64, keep=4)
        for i in range(100):
            d.add(trace(float(i), float(i) / 2))
        slow = d.slowest()
        totals = [s["spans"][0]["end"] for s in slow]
        assert len(slow) == 4 and totals == sorted(totals, reverse=True)
        assert min(totals) >= 90.0
        assert d.summary()["requests"] == 100
        assert d.summary()["decode"]["count"] == 64
        payload = ot.tracez_payload(
            [trace(float(i), 1.0) for i in range(20)], limit=5)
        assert len(payload["recent"]) == 5
        assert isinstance(payload["recent"][0]["spans"], int)
        assert payload["stages"]["decode"]["count"] == 20
        assert len(payload["slowest"]) == 2
        json.dumps(payload)


# -- the instrumented engine ----------------------------------------------
@pytest.fixture(scope="module")
def setup():
    params = draw_params(0)
    return params, port_model(params)


ENGINE_KW = dict(prompt_grid=4, prefill_chunk=PAGE, page_size=PAGE)
# Counters the port's engine keeps beyond the reference's (the fused
# steps inside blocks, the speculative pass / window figures, the
# scheduler's phase and starved time and the final prefill chunks a
# CUDA graph replay served).
PORT_ONLY_STATS = {"fused_steps", "spec_verify_passes", "spec_window_rows",
                   "spec_window_tokens", "spec_draft_passes",
                   "spec_draft_chains", "phase_wait_ns", "phase_side_ns",
                   "phase_admit_ns", "phase_stage_ns", "phase_dispatch_ns",
                   "phase_sync_ns", "phase_commit_ns", "starved_ns",
                   "starved_admit_ns", "starved_commit_ns",
                   "launch_idle_ns", "prefill_replays"}


def _engine(pm, slots=2, **kw):
    return ContinuousBatchingEngine(pm, slots, device="cpu",
                                    **{**ENGINE_KW, **kw})


def _bucket_width_at(hist, value):
    i = bisect.bisect_left(hist.bounds, value)
    lo = hist.bounds[i - 1] if i > 0 else 0.0
    hi = hist.bounds[i] if i < len(hist.bounds) else hist.bounds[-1]
    return max(hi - lo, hi)


def _series(registry):
    return set(observe.parse_text(registry.render()))


TRAFFIC = [(1, 5, 4), (2, 19, 6), (3, 9, 3), (1, 5, 5)]  # (seed, plen, new)


def _run_traffic(eng):
    outs = [eng.submit(rand_prompt(s, p), n, 0.0, timeout=300)
            for s, p, n in TRAFFIC]
    t0 = time.monotonic()
    while eng.snapshot()["active_rows"] and time.monotonic() - t0 < 60:
        time.sleep(0.01)
    return outs


class TestInstrumentedEngine:
    @pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
    def test_histograms_series_and_stages_match_the_reference(
            self, setup, quant):
        # The same weights and sequential traffic (a prefix hit on the
        # last request) through both packages' observed engines: equal
        # tokens, equal histogram counts, the same /metrics series (the
        # port's extra counters aside) and the same trace stages.
        params, pm = setup
        eng = _engine(pm, quant=quant)
        try:
            outs = _run_traffic(eng)
            obs = eng.observability
            mine = {n: getattr(obs, n).state()[2] for n in
                    ("ttft", "itl", "queue_wait", "chunk", "commit_lag",
                     "spec_accept")}
            names = _series(obs.registry)
            stages = [[s.name for s in t.spans] for t in obs.traces.traces()]
        finally:
            eng.close()
        ref = JaxEngine(jax_decoder(), jax_params(params), 2, quant=quant,
                        **ENGINE_KW)
        try:
            want_outs = _run_traffic(ref)
            robs = ref.observability
            want = {n: getattr(robs, n).state()[2] for n in mine}
            want_names = _series(robs.registry)
            want_stages = [[s.name for s in t.spans]
                           for t in robs.traces.traces()]
        finally:
            ref.close()
        assert outs == want_outs
        assert mine == want, (mine, want)
        n_tok = sum(n for _, _, n in TRAFFIC)
        assert mine["ttft"] == len(TRAFFIC)
        assert mine["itl"] == n_tok - len(TRAFFIC)
        extra = {f"serve_engine_{k}_total" for k in PORT_ONLY_STATS}
        assert names - extra == want_names
        assert stages == want_stages
        assert all(s[0] == "queue_wait" and "prefill_chunk" in s
                   and s[-1] == "decode" for s in stages)

    def test_registry_agrees_with_client_observed_timings(self, setup):
        # The drift guard: the registry's TTFT / ITL agree with
        # independent client-side stamps within bucket resolution.
        _, pm = setup
        eng = _engine(pm)
        try:
            n_req, max_new = 4, 6
            client_ttft, client_gaps = {}, []
            lock = threading.Lock()

            def fire(i):
                stamps = []
                t0 = time.monotonic()
                eng.submit(
                    rand_prompt(i, 3 + i), max_new, 0.0, timeout=300,
                    on_token=lambda row, tok: stamps.append(
                        time.monotonic()),
                )
                with lock:
                    client_ttft[i] = stamps[0] - t0
                    client_gaps.extend(
                        b - a for a, b in zip(stamps, stamps[1:]))

            threads = [threading.Thread(target=fire, args=(i,))
                       for i in range(n_req)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            assert len(client_ttft) == n_req
            obs = eng.observability
            assert obs.enabled
            assert obs.ttft.state()[2] == n_req
            assert obs.itl.state()[2] == n_req * (max_new - 1)
            assert obs.queue_wait.state()[2] == n_req
            for q in (0.5, 0.95):
                reg = obs.ttft.quantile(q)
                cli = sorted(client_ttft.values())[
                    min(n_req - 1, int(q * n_req))]
                tol = _bucket_width_at(obs.ttft, cli) + 0.05
                assert abs(reg - cli) <= tol, (q, reg, cli, tol)
            reg_itl = obs.itl.quantile(0.5)
            cli_itl = sorted(client_gaps)[len(client_gaps) // 2]
            tol = _bucket_width_at(obs.itl, cli_itl) + 0.05
            assert abs(reg_itl - cli_itl) <= tol
            assert 0.0 <= obs.ttft.state()[1] <= n_req * 300.0
        finally:
            eng.close()

    def test_engine_series_and_sealed_trace_on_scrape(self, setup):
        _, pm = setup
        eng = _engine(pm)
        try:
            eng.submit(rand_prompt(1, 5), 4, 0.0, timeout=300)
            parsed = observe.parse_text(eng.observability.registry.render())
            assert parsed["serve_ttft_seconds_count"][""] == 1.0
            assert parsed["serve_engine_retired_total"][""] == 1.0
            assert parsed["serve_engine_admitted_total"][""] == 1.0
            assert parsed["serve_engine_active_rows"][""] == 0.0
            [trace] = eng.observability.traces.traces()
            names = [s.name for s in trace.spans]
            assert names[0] == "queue_wait" and names[-1] == "decode"
            assert "prefill_chunk" in names
            assert trace.attrs["outcome"] == "done"
            assert trace.attrs["tokens"] == 4
            assert all(s.end is not None for s in trace.spans)
            provide = eng.observability.gauge_provider(eng)()
            assert provide["serve_engine_kv_pages_total"] > 0
        finally:
            eng.close()

    def test_propagated_trace_context_opens_the_trace(self, setup):
        _, pm = setup
        eng = _engine(pm)
        try:
            ctx = otel.TraceContext.new().child("feedface")
            eng.submit(rand_prompt(2, 6), 3, 0.0, timeout=300,
                       trace_ctx=ctx)
            [trace] = eng.observability.traces.traces()
            assert trace.trace_id == ctx.trace_id
            assert trace.spans[0].parent_id == "feedface"
            assert eng.observability.spans_for(ctx.trace_id)
        finally:
            eng.close()

    def test_observe_false_is_inert(self, setup):
        _, pm = setup
        eng = _engine(pm, observe=False)
        try:
            eng.submit(rand_prompt(2, 4), 3, 0.0, timeout=300)
            obs = eng.observability
            assert not obs.enabled
            assert obs.recorder.total == 0 and obs.traces.total == 0
            assert "serve_ttft" not in obs.registry.render()
            assert "flight_recorder" not in eng.snapshot()
        finally:
            eng.close()

    def test_shared_registry_and_spec_accept_histogram(self, setup):
        # An embedder's registry carries the engine's series, and a
        # speculative engine folds each window's accept fraction.
        _, pm = setup
        reg = observe.Registry()
        eng = _engine(pm, spec_k=2, registry=reg)
        try:
            eng.submit(rand_prompt(5, 9), 8, 0.0, timeout=300)
            parsed = observe.parse_text(reg.render())
            assert parsed["serve_spec_accept_ratio_count"][""] >= 1.0
            assert parsed["serve_engine_spec_drafted_tokens_total"][""] > 0
        finally:
            eng.close()

    def test_kill_dumps_flight_recorder_and_snapshot_carries_it(
            self, setup, capsys):
        _, pm = setup
        eng = _engine(pm)
        try:
            eng.submit(rand_prompt(3, 4), 3, 0.0, timeout=300)
            eng.kill(RuntimeError("budget exhausted (test)"))
            err = capsys.readouterr().err
            assert "engine flight recorder" in err
            assert "budget exhausted (test)" in err
            kinds = [e["kind"] for e in eng.snapshot()["flight_recorder"]]
            assert "admit" in kinds and "retire" in kinds
            assert kinds[-1] == "kill"
            with pytest.raises(RuntimeError):
                eng.submit(rand_prompt(4, 4), 3, 0.0, timeout=5)
        finally:
            eng.close()

    def test_step_failures_record_retry_fail_and_restart(self, setup,
                                                        capsys):
        # A decode step that fails on every attempt: the recorder holds
        # the retries, the failure and the supervisor's restart, whose
        # dump reaches stderr.
        from container_engine_accelerators_tpu_torch.serving import (
            EngineSupervisor,
        )

        _, pm = setup
        eng = _engine(pm, step_retries=1, retry_backoff_s=0.001,
                      retry_backoff_cap_s=0.002)
        sup = EngineSupervisor(eng, max_restarts=2).start()
        real = eng._decode_fn
        fails = [0]

        def flaky(*a, **k):
            if fails[0] < 2:
                fails[0] += 1
                raise RuntimeError("injected decode fault")
            return real(*a, **k)

        eng._decode_fn = flaky
        try:
            with pytest.raises(RuntimeError):
                eng.submit(rand_prompt(6, 5), 4, 0.0, timeout=300)
            t0 = time.monotonic()
            while eng.snapshot()["restarts"] < 1:
                assert time.monotonic() - t0 < 60
                time.sleep(0.01)
            kinds = [e["kind"] for e in eng.observability.recorder.events()]
            assert kinds.count("step_retry") == 1
            assert "step_fail" in kinds and "restart" in kinds
            assert "supervisor restart #1" in capsys.readouterr().err
            assert eng.submit(rand_prompt(6, 5), 4, 0.0, timeout=300)
        finally:
            sup.stop()
            eng.close()


def test_engine_observability_reads_no_environment(monkeypatch):
    monkeypatch.setenv("SERVE_LM_FLIGHT_EVENTS", "3")
    eo = observe.engine_observability()
    for i in range(5):
        eo.recorder.record("e", i=i)
    assert len(eo.recorder.events()) == 5
    assert len(observe.engine_observability(
        env={"SERVE_LM_FLIGHT_EVENTS": "3"}).recorder._buf) == 3
