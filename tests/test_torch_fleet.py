"""The port's in-process fleet (serving/fleet.py FleetManager) against the
reference's: two replicas on the same numpy-drawn weights (f32, CPU)
give equal greedy tokens, equal placements and equal counters on the
same traffic, and after the same engine_death:1 schedule both evict
replica 1 and lose no request; a poison prompt fails only its own
request in both, the port's predicate firing on the port's prefill
arguments.  Then the reference's fleet cases (tests/test_fleet.py, the
fleet cases of tests/test_kv_migration.py and tests/test_tracing.py) on
the port alone: labelled metrics, saturation, health drain and rejoin,
eviction, route faults, the no-leak pin, migrate-or-recompute, the
prefill handoff and the assembled traces.
"""

import threading
import time

import numpy as np
import pytest
import torch

from _torch_port import (
    PAGE, draw_params, jax_decoder, jax_params, port_model, rand_prompt,
)
from conftest import wait_until
from container_engine_accelerators_tpu.serving import faults as ref_faults
from container_engine_accelerators_tpu.serving.fleet import (
    FleetManager as RefFleet,
)
from container_engine_accelerators_tpu_torch.models import generate as G
from container_engine_accelerators_tpu_torch.serving import faults as F
from container_engine_accelerators_tpu_torch.serving import fleet as fleet_mod
from container_engine_accelerators_tpu_torch.serving import observe
from container_engine_accelerators_tpu_torch.serving.errors import (
    QueueFullError,
)
from container_engine_accelerators_tpu_torch.serving.fleet import (
    FleetManager,
)

ENGINE_KW = dict(prompt_grid=4, page_size=PAGE, prefill_chunk=PAGE,
                 retry_backoff_s=0.01, retry_backoff_cap_s=0.02)
# Deterministic engine counters (the timing-dependent ones, such as
# steps, queue_peak and max_active, are left out).
COUNTERS = ("admitted", "retired", "prefix_hits", "prefix_misses",
            "prefix_hit_tokens", "prefix_lookup_tokens",
            "prefix_inserted_pages", "admit_failures", "rows_failed",
            "restarts", "kv_pages_in_use", "prefix_cached_pages")
POISON = 61


@pytest.fixture(scope="module")
def setup():
    params = draw_params(0)
    return params, port_model(params)


def _fleet(pm, n=2, slots=2, **kw):
    engine_kw = {**ENGINE_KW, **kw.pop("engine_kw", {})}
    kw.setdefault("restart_backoff_s", 0.01)
    return FleetManager(pm, n, slots, engine_kw=engine_kw, **kw)


def _ref_fleet(params, n=2, slots=2, **kw):
    engine_kw = {**ENGINE_KW, **kw.pop("engine_kw", {})}
    kw.setdefault("restart_backoff_s", 0.01)
    return RefFleet(jax_decoder(), jax_params(params), n, slots,
                    engine_kw=engine_kw, **kw)


def _trace_placements(fleet):
    placements = []
    inner = fleet._route

    def traced(*args, **kwargs):
        out = inner(*args, **kwargs)
        placements.append(out)
        return out

    fleet._route = traced
    return placements


def _prompt(seed, p_len, prefix=None):
    tail = rand_prompt(seed, p_len - (0 if prefix is None else len(prefix)))
    if prefix is None:
        return tail
    return np.concatenate([np.asarray(prefix, np.int32)[None], tail], 1)


def _solo(pm, prompt, n):
    return G.generate_prefill(pm, prompt, prompt.shape[1], n, 0.0,
                              torch.Generator())[0].tolist()


# Sequential traffic: two prompts sharing a 2-page prefix (the second
# follows the first by affinity and hits its pages), distinct prompts
# the hash ring spreads, and a repeat.
PREFIX = np.arange(2 * PAGE, dtype=np.int32) % 64
TRAFFIC = [(_prompt(1, 2 * PAGE + 3, PREFIX), 5), (_prompt(2, 11), 4),
           (_prompt(3, 2 * PAGE + 6, PREFIX), 6), (_prompt(4, 9), 3),
           (_prompt(5, 13), 5), (_prompt(6, 7), 4), (_prompt(2, 11), 4)]


def _serve(fleet, traffic):
    placements = _trace_placements(fleet)
    outs = [fleet.submit(p, n, 0.0, timeout=300) for p, n in traffic]
    for eng in fleet.engines:
        wait_until(lambda e=eng: not e.snapshot()["active_rows"],
                   what="an idle replica")
    snap = fleet.snapshot()
    engines = [{k: e[k] for k in COUNTERS} for e in snap["engines"]]
    return outs, placements, snap["fleet"], snap["router"], engines


# -- both packages on the same traffic ---------------------------------------
class TestFleetParity:
    def test_tokens_placements_and_counters_match_the_reference(
            self, setup):
        params, pm = setup
        fleet = _fleet(pm)
        try:
            got = _serve(fleet, TRAFFIC)
        finally:
            fleet.close()
        ref = _ref_fleet(params)
        try:
            want = _serve(ref, TRAFFIC)
        finally:
            ref.close()
        assert got[0] == want[0]
        assert got[1] == want[1]
        assert got[2] == want[2] and got[3] == want[3]
        assert got[4] == want[4]
        # The fleet really spread and steered: both replicas served, the
        # prefix follower hit by affinity.
        assert {rid for rid, _ in got[1]} == {0, 1}
        assert got[1][2] == (got[1][0][0], "affinity")
        assert sum(e["prefix_hits"] for e in got[4]) >= 1
        for (p, n), out in zip(TRAFFIC, got[0]):
            assert out == [_solo(pm, p, n)]

    def test_engine_death_evicts_the_same_replica_losing_nothing(
            self, setup):
        # engine_death:1 persistent from its first call; no restart
        # budget: the first request placed on replica 1 crashes it, is
        # re-routed and completes; replica 1 is evicted in both.
        params, pm = setup

        def run(make, faults):
            fleet = make(engine_kw=dict(step_retries=0), max_restarts=0)
            inj = faults.FaultInjector(seed=0)
            inj.plan("engine_death:1", fail_after=0, fail_n=10 ** 6)
            faults.install_fleet_faults(fleet, inj)
            try:
                outs = [fleet.submit(p, n, 0.0, timeout=300)
                        for p, n in TRAFFIC[:5]]
                wait_until(lambda: fleet.replica_states()[1] == "dead",
                           what="the eviction")
                snap = fleet.snapshot()
                return (outs, snap["replica_states"], snap["fleet"],
                        inj.stats()["engine_death:1"]["injected"])
            finally:
                fleet.close()

        got = run(lambda **kw: _fleet(pm, **kw), F)
        want = run(lambda **kw: _ref_fleet(params, **kw), ref_faults)
        assert got[0] == want[0]
        assert got[1] == want[1] == ["up", "dead"]
        assert got[2] == want[2]
        assert got[2]["replica_deaths"] == 1 and got[2]["rerouted"] >= 1
        assert got[2]["completed"] == 5
        assert got[3] >= 1

    def test_poison_prompt_fails_only_its_request(self, setup):
        params, pm = setup
        # One prefill chunk (PAGE tokens), so the seam's chunk starts
        # at the prompt's first token.
        poison = np.concatenate(
            [[[POISON]], rand_prompt(9, 5)], 1).astype(np.int32)

        def run(make, faults):
            fleet = make()
            inj = faults.FaultInjector(seed=0)
            for eng in fleet.engines:
                faults.install_engine_faults(eng, inj)
            inj.plan("prefill", match=faults.poison_prompt_match(POISON),
                     fail_n=10 ** 6)
            try:
                ok = [fleet.submit(p, n, 0.0, timeout=300)
                      for p, n in TRAFFIC[1:3]]
                with pytest.raises(faults.InjectedFault):
                    fleet.submit(poison, 3, 0.0, timeout=300)
                ok.append(fleet.submit(TRAFFIC[3][0], 3, 0.0, timeout=300))
                snap = fleet.snapshot()
                return (ok, inj.stats()["prefill"]["injected"],
                        snap["replica_states"], snap["fleet"]["rerouted"])
            finally:
                fleet.close()

        got = run(lambda: _fleet(pm), F)
        want = run(lambda: _ref_fleet(params), ref_faults)
        assert got == want
        # The predicate fired once, on the port's own prefill seam: the
        # failure is per request, so it is never re-routed.
        assert got[1] == 1 and got[3] == 0
        assert got[2] == ["up", "up"]


def test_poison_predicate_reads_the_ports_prefill_arguments():
    # The port's seam: (cache, scratch, chunk, block-table row, start,
    # ...); the chunk is a 2-D torch int32 tensor.
    cache = [{"k": torch.zeros(2, 2), "v": torch.zeros(2, 2)}]
    row = np.zeros((4,), np.int32)
    for token, want in ((POISON, True), (POISON + 1, False)):
        chunk = torch.tensor([[token, 3, 4]], dtype=torch.int32)
        args = (cache, cache, chunk, row, 0, 0, 3, 0.0, torch.Generator())
        assert F.poison_prompt_match(POISON)(*args) is want
    # A verbatim copy of the reference's predicate reads torch's dtype
    # name ("torch.int32") and never fires on the port's arguments.
    chunk = torch.tensor([[POISON, 3]], dtype=torch.int32)
    assert not ref_faults.poison_prompt_match(POISON)(cache, cache, chunk)
    assert F.poison_prompt_match(POISON)(np.array([[POISON]], np.int64))


def test_engine_seams_are_the_ports(setup):
    _, pm = setup
    fleet = _fleet(pm, engine_kw=dict(spec_k=2, decode_steps=0))
    try:
        inj = F.FaultInjector(seed=0)
        eng = fleet.engines[0]
        F.install_engine_faults(eng, inj)
        for attr, seam in (("_prefill_fn", "prefill"),
                           ("_prefill_chunk_fn", "prefill_chunk"),
                           ("_decode_fn", "decode_step"),
                           ("_preload_fn", "prefix_preload"),
                           ("_verify_fn", "spec_verify"),
                           ("_draft_fn", "spec_draft")):
            assert getattr(eng, attr).__fault_seam__ == seam, attr
        inj.plan("spec_draft", fail_calls=[0])
        out = fleet.engines[0].submit(rand_prompt(3, 9), 6, timeout=300)
        assert len(out[0]) == 6
        assert inj.stats()["spec_draft"]["injected"] == 1
    finally:
        fleet.close()


# -- the reference's fleet cases, on the port --------------------------------
class TestFleetServing:
    def test_metrics_per_engine_labels(self, setup):
        _, pm = setup
        fleet = _fleet(pm)
        try:
            fleet.submit(_prompt(7, 10), 3, 0.0, timeout=300)
            text = fleet.registry.render()
            parsed = observe.parse_text(text)
            for fam in ("serve_engine_admitted_total",
                        "serve_engine_active_rows",
                        "serve_engine_kv_pages_in_use"):
                labels = set(parsed[fam])
                assert any('engine="0"' in lab for lab in labels), fam
                assert any('engine="1"' in lab for lab in labels), fam
            assert any('engine="' in lab for lab in
                       parsed.get("serve_ttft_seconds_count", {}))
            assert parsed["fleet_replicas_up"][""] == 2.0
            assert parsed["fleet_router_placements_total"][""] >= 1.0
            helps = [line.split()[2] for line in text.splitlines()
                     if line.startswith("# HELP")]
            assert len(helps) == len(set(helps))
            gauges = fleet.gauge_provider()()
            assert gauges["fleet_replicas_up"] == 2.0
            assert "fleet_engine1_queue_depth" in gauges
        finally:
            fleet.close()

    def test_fleet_wide_saturation_sheds(self, setup):
        _, pm = setup
        fleet = _fleet(pm, slots=1, engine_kw=dict(max_queue=1))
        stop = threading.Event()
        holders = []
        try:
            def hold(p):
                while not stop.is_set():
                    try:
                        fleet.submit(p, 40, 0.0, timeout=300)
                        return
                    except QueueFullError:
                        time.sleep(0.005)
                    except RuntimeError:
                        return

            for i in range(4):
                th = threading.Thread(target=hold,
                                      args=(_prompt(31 + i, 8),))
                th.start()
                holders.append(th)
            wait_until(lambda: all(
                s["active_rows"] >= 1 and s["queue_depth"] >= 1
                for s in fleet.snapshot()["engines"]),
                timeout=120, what="both replicas saturated")
            shed = False
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and not shed:
                try:
                    fleet.submit(_prompt(99, 8), 2, 0.0, timeout=0.2)
                except QueueFullError:
                    shed = True
                except RuntimeError:
                    continue
            assert shed, "the fleet never shed under saturation"
            assert fleet.snapshot()["fleet"]["spills"] >= 1
        finally:
            stop.set()
            fleet.close()
            for th in holders:
                th.join(timeout=300)

    def test_health_drain_requeues_queued_then_rejoins(self, setup):
        _, pm = setup
        fleet = _fleet(pm, slots=1)
        src = F.ScriptedEventSource(names=["gpu0"])
        fleet.attach_health_source(0, src)
        prefix = np.arange(PAGE, dtype=np.int32)
        fleet.router.index.record(prefix, 0)  # both requests -> 0
        placements = _trace_placements(fleet)
        results, errors = {}, {}

        def fire(name, prompt, max_new):
            try:
                results[name] = fleet.submit(prompt, max_new, 0.0,
                                             timeout=300)
            except Exception as e:  # pylint: disable=broad-except
                errors[name] = e

        try:
            t_long = threading.Thread(
                target=fire, args=("long", _prompt(60, PAGE + 4, prefix), 40))
            t_long.start()
            wait_until(lambda: placements, what="the long placement")
            assert placements[0][0] == 0
            t_short = threading.Thread(
                target=fire, args=("short", _prompt(61, PAGE + 4, prefix), 3))
            t_short.start()
            wait_until(lambda: fleet.engines[0].queue_depth > 0,
                       what="the short request queued on replica 0")
            src.chip_loss(0)
            t_short.join(timeout=300)
            assert "short" in results, errors.get("short")
            snap = fleet.snapshot()
            assert snap["fleet"]["yanked"] >= 1
            assert snap["fleet"]["rerouted"] >= 1
            assert placements[-1][0] == 1
            t_long.join(timeout=300)
            assert "long" in results, errors.get("long")
            src.recover_chip(0)
            wait_until(lambda: fleet.replica_states()[0] == "up",
                       what="the rejoin")
            assert fleet.snapshot()["fleet"]["recoveries"] == 1
        finally:
            fleet.close()

    def test_evicted_replica_never_placed_again(self, setup):
        _, pm = setup
        fleet = _fleet(pm, slots=1, engine_kw=dict(step_retries=0),
                       max_restarts=0)
        inj = F.FaultInjector(seed=0)
        inj.plan("engine_death:0", fail_after=0, fail_n=10 ** 6)
        F.install_fleet_faults(fleet, inj)
        placements = _trace_placements(fleet)
        dead = []
        try:
            seed = 0
            while fleet.replica_states()[0] != "dead" and seed < 40:
                seed += 1
                fleet.submit(_prompt(seed, 8), 2, 0.0, timeout=300)
            assert fleet.replica_states()[0] == "dead"
            del placements[:]
            for seed in range(8):
                out = fleet.submit(_prompt(400 + seed, 8), 2, 0.0,
                                   timeout=300)
                assert len(out[0]) == 2
            assert {rid for rid, _ in placements} == {1}
            assert fleet.router.stats()["ring_members"] == 1
            dead.append(fleet.snapshot()["fleet"]["replica_deaths"])
        finally:
            fleet.close()
        assert dead == [1]

    def test_single_replica_restart_preserves_yanked_ticket(self, setup):
        _, pm = setup
        fleet = _fleet(pm, n=1, slots=1, engine_kw=dict(step_retries=0),
                       max_restarts=3)
        inj = F.FaultInjector(seed=0)
        inj.plan("engine_death:0", fail_calls=[1])
        F.install_fleet_faults(fleet, inj)
        results, errors = {}, {}

        def fire(name, prompt, max_new):
            try:
                results[name] = fleet.submit(prompt, max_new, 0.0,
                                             timeout=300)
            except Exception as e:  # pylint: disable=broad-except
                errors[name] = e

        try:
            threads = [threading.Thread(
                target=fire, args=(f"r{i}", _prompt(900 + i, 8), 4))
                for i in range(3)]
            for th in threads:
                th.start()
                time.sleep(0.05)
            for th in threads:
                th.join(timeout=300)
            assert len(results) >= 2, errors
            snap = fleet.snapshot()
            assert snap["engines"][0]["restarts"] == 1
            assert snap["replica_states"] == ["up"]
        finally:
            fleet.close()

    def test_route_fault_is_contained_to_its_request(self, setup):
        _, pm = setup
        fleet = _fleet(pm, slots=1)
        inj = F.FaultInjector(seed=0)
        inj.plan("route", fail_calls=[1])
        F.install_fleet_faults(fleet, inj)
        try:
            assert len(fleet.submit(_prompt(70, 8), 2, 0.0,
                                    timeout=300)[0]) == 2
            with pytest.raises(F.InjectedFault):
                fleet.submit(_prompt(71, 8), 2, 0.0, timeout=300)
            assert len(fleet.submit(_prompt(72, 8), 2, 0.0,
                                    timeout=300)[0]) == 2
            text = fleet.registry.render()
            assert 'serve_fault_injected_total{seam="route"} 1' in text
        finally:
            fleet.close()

    def test_fleetwide_kill_rebuild_leaves_no_pages(self, setup):
        _, pm = setup
        fleet = _fleet(pm, engine_kw=dict(step_retries=0,
                                          prefix_cache=False),
                       max_restarts=3)
        inj = F.FaultInjector(seed=0)
        for i in range(2):
            inj.plan(f"engine_death:{i}", fail_calls=[1])
        F.install_fleet_faults(fleet, inj)
        try:
            seed = 500
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and not all(
                    e.snapshot()["restarts"] >= 1 for e in fleet.engines):
                fleet.submit(_prompt(seed, 12), 4, 0.0, timeout=300)
                seed += 1
            assert all(e.snapshot()["restarts"] >= 1 for e in fleet.engines)
            for eng in fleet.engines:
                wait_until(lambda e=eng: not (
                    e.snapshot()["active_rows"] or e.snapshot()["queue_depth"]
                ), what="an idle replica")
                assert eng.snapshot()["kv_pages_in_use"] == 0
            p = _prompt(600, 10)
            assert fleet.submit(p, 4, 0.0, timeout=300) == [_solo(pm, p, 4)]
        finally:
            fleet.close()


class TestFleetMigration:
    def test_hash_fleet_fetches_instead_of_duplicating(self, setup):
        # The hash control with migration on: the shared prefix's pages
        # are fetched from their owner, not prefilled again elsewhere,
        # and every answer is the solo oracle's.
        _, pm = setup
        fleet = _fleet(pm, affinity=False, migrate=True)
        prefix = np.arange(3 * PAGE, dtype=np.int32) % 64
        try:
            for i in range(6):
                p = _prompt(100 + i, 3 * PAGE + 5, prefix)
                assert fleet.submit(p, 3, 0.0, timeout=300) == [
                    _solo(pm, p, 3)]
            snap = fleet.snapshot()
            assert snap["fleet"]["kv_migrations"] >= 1
            assert snap["fleet"]["kv_migrate_failures"] == 0
            assert sum(e["prefix_hits"] for e in snap["engines"]) >= 4
            assert 'fleet_kv_migrate_seconds_count' in \
                fleet.registry.render()
        finally:
            fleet.close()

    def test_roles_fleet_prefill_handoff_parity(self, setup):
        _, pm = setup
        fleet = _fleet(pm, roles=["prefill", "decode"])
        try:
            for i in range(3):
                p = _prompt(300 + i, 4 * PAGE + 3)
                assert fleet.submit(p, 4, 0.0, timeout=300) == [
                    _solo(pm, p, 4)]
            snap = fleet.snapshot()
            assert snap["replica_roles"] == ["prefill", "decode"]
            assert snap["fleet"]["prefill_handoffs"] >= 1
            assert snap["fleet"]["kv_migrations"] >= 1
            # Client requests landed on the decode replica.
            assert snap["engines"][1]["admitted"] >= 3
        finally:
            fleet.close()

    def test_migrate_or_recompute_skips_then_probes(self, setup):
        _, pm = setup
        fleet = _fleet(pm, migrate=True)
        try:
            assert fleet._should_migrate(4)
            assert not fleet._should_migrate(0)
            with fleet._lock:
                fleet._migrate_bps = 1.0
                fleet._migrate_page_bytes = 1e6
            skips = [fleet._should_migrate(4) for _ in range(8)]
            assert skips == [False] * 7 + [True]
            assert fleet.snapshot()["fleet"]["kv_migrate_skipped"] == 7
        finally:
            fleet.close()

    def test_bad_roles_and_placement_options_rejected(self, setup):
        _, pm = setup
        for roles in (["prefill"], ["prefill", "prefill"],
                      ["prefill", "verify"]):
            with pytest.raises(ValueError):
                _fleet(pm, roles=roles)
        with pytest.raises(ValueError, match="submeshes for"):
            _fleet(pm, submeshes=[None])
        with pytest.raises(ValueError):
            _fleet(pm, devices=["cpu"])
        with pytest.raises(ValueError, match="devices="):
            _fleet(pm, engine_kw=dict(device="cpu"))


def test_replicas_on_named_devices_share_or_copy_the_model(setup):
    _, pm = setup
    p = _prompt(11, 9)
    fleet = _fleet(pm, devices=["cpu", torch.device("cpu")])
    try:
        assert all(e._model is pm for e in fleet.engines)
        assert fleet.submit(p, 3, 0.0, timeout=300) == [_solo(pm, p, 3)]
    finally:
        fleet.close()
    # The copy a replica on another device gets: the same config and
    # weights in new tensors, serving the same greedy tokens.
    copy = fleet_mod._model_on(pm, "cpu")
    assert copy is not pm and copy.config == pm.config
    want = pm.state_dict()
    for name, t in copy.state_dict().items():
        assert t.data_ptr() != want[name].data_ptr(), name
        assert torch.equal(t, want[name]), name
    fleet = _fleet(copy)
    try:
        assert fleet.submit(p, 3, 0.0, timeout=300) == [_solo(pm, p, 3)]
    finally:
        fleet.close()


def test_launch_counts_add_across_threads_and_tallies_stay_per_thread():
    # Replicas of one process launch the same wrappers from their own
    # scheduler threads: no count may be lost, and a thread's tally (a
    # CUDA-graph capture's take-back) holds its own launches only.
    import sys

    from container_engine_accelerators_tpu_torch.ops import _build
    from container_engine_accelerators_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    before, n_threads, n = paged_attention.launches, 16, 2000
    tallies = [None] * n_threads
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            if i % 2:
                with _build.tally() as mine:
                    for _ in range(n):
                        _build.add_launches(paged_attention)
                tallies[i] = dict(mine)
            else:
                for _ in range(n):
                    _build.add_launches(paged_attention)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert paged_attention.launches - before == n_threads * n
    assert all(t == {paged_attention: n} for t in tallies[1::2])
    _build.add_launches(paged_attention, -n_threads * n)


class TestFleetTracing:
    def test_assembled_trace_has_router_and_replica_spans(self, setup):
        from container_engine_accelerators_tpu_torch.serving import otel

        _, pm = setup
        fleet = _fleet(pm)
        try:
            ctx = otel.TraceContext.new()
            fleet.submit(_prompt(40, 10), 3, 0.0, timeout=300,
                         trace_ctx=ctx)
            tz = fleet.tracez()
            assert tz["total"] == 1 and tz["enabled"]
            (summary,) = tz["recent"]
            assert summary["trace_id"] == ctx.trace_id
            (trace,) = fleet.traces.traces()
            names = [s.name for s in trace.spans]
            assert names[0] == "request" and "placement" in names
            assert "decode" in names and "queue_wait" in names
            assert {s.process for s in trace.spans} >= {"router"}
            assert any(s.process.startswith("engine") for s in trace.spans)
            assert trace.attrs["outcome"] == "ok"
            fleet.set_tracing(False)
            fleet.submit(_prompt(41, 10), 3, 0.0, timeout=300)
            assert fleet.tracez()["total"] == 1
        finally:
            fleet.close()

    def test_rerouted_request_traces_the_reroute(self, setup):
        _, pm = setup
        fleet = _fleet(pm, engine_kw=dict(step_retries=0), max_restarts=0)
        inj = F.FaultInjector(seed=0)
        inj.plan("engine_death:1", fail_after=0, fail_n=10 ** 6)
        F.install_fleet_faults(fleet, inj)
        try:
            for i in range(6):
                fleet.submit(_prompt(50 + i, 9), 3, 0.0, timeout=300)
            spans = [s.name for t in fleet.traces.traces() for s in t.spans]
            assert "reroute" in spans
            assert all(t.attrs["outcome"] == "ok"
                       for t in fleet.traces.traces())
        finally:
            fleet.close()
