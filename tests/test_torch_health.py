"""The port's health layer (plugin/health.py) against the reference's:
the same scripted events through the reference's TPUHealthChecker and
the port's GPUHealthChecker leave the same health queue (the six
catch_error scenarios of tests/test_health.py and its listen-loop
recovery), the vendor layer's edge and streak rules over a fake NVML
table (tests/torch_fake_nvml.py), the NVML source's recovery and new
devices, `make_event_source`, and the server's --health-source /
--health-critical: parsing, and a drain on a critical event that an
ERROR_CLEARED restores."""

import json
import queue
import threading
import time
import urllib.error
import urllib.request

import pytest

from torch_fake_nvml import FakeNvml
from conftest import wait_until
from container_engine_accelerators_tpu.plugin import health as ref_health
from container_engine_accelerators_tpu.plugin.api import (
    deviceplugin_pb2 as ref_pb2,
)
from container_engine_accelerators_tpu_torch import server as S
from container_engine_accelerators_tpu_torch.native import nvml as N
from container_engine_accelerators_tpu_torch.plugin import health as H
from container_engine_accelerators_tpu_torch.plugin import util
from container_engine_accelerators_tpu_torch.plugin.api import (
    HEALTHY, UNHEALTHY, deviceplugin_pb2 as pb2,
)


class FakeEvent:
    def __init__(self, device_index, error_code, device_name=""):
        self.device_index = device_index
        self.error_code = error_code
        self.timestamp_us = 0
        self.device_name = device_name

    @property
    def is_host_event(self):
        return self.device_index < 0


class FakeEventSource(H.EventSource):
    """Names and a queue of scripted events; usable by both packages'
    checkers (they read device_names / wait / recover / close)."""

    def __init__(self, names):
        self.names = names
        self.events = queue.Queue()
        self.closed = False

    def device_names(self):
        return self.names

    def wait(self, timeout_ms):
        try:
            return self.events.get(timeout=timeout_ms / 1000)
        except queue.Empty:
            return None

    def close(self):
        self.closed = True


def _checkers(n=4, critical=(), device_ids=None):
    """The reference's and the port's checker over one name list."""
    names = [f"nvidia{i}" for i in range(n)]
    ids = device_ids or names
    out = []
    for mod, dp in ((ref_health, ref_pb2), (H, pb2)):
        kind = (mod.TPUHealthChecker if mod is ref_health
                else mod.GPUHealthChecker)
        hq = queue.Queue()
        src = FakeEventSource(names)
        devices = {d: dp.Device(ID=d, health=HEALTHY) for d in ids}
        out.append((kind(devices, hq, critical_errors=critical,
                         event_source=src), hq, src))
    return out


def _drain(q):
    out = []
    while True:
        try:
            d = q.get_nowait()
        except queue.Empty:
            return out
        out.append((d.ID, d.health))


# (events, configured critical codes, the checker's device ids): the
# reference's catch_error cases, each held on both checkers.
SCENARIOS = {
    "always_critical": ([(2, 1)], (), None),
    "not_configured_skipped": ([(1, 2)], (), None),
    "configured": ([(1, 2)], (2,), None),
    "host_event_marks_all": ([(-1, 0)], (), None),
    "named_removal": ([(-1, 1000, "nvidia3")], (), None),
    "unnamed_removal": ([(-1, 1000)], (), None),
    "named_removal_partitioned": ([(-1, 1000, "nvidia2")], (),
                                  ["slice0", "slice1"]),
    "unknown_index_ignored": ([(17, 1)], (), None),
    "partitioned_emits_name": ([(3, 1)], (), ["slice0", "slice1"]),
    "xid_application_skipped": ([(0, N.XID_CODE_BASE + 31)], (1, 2, 3),
                                None),
    "sequence": ([(0, 1), (0, 1), (2, 5), (1, 3), (-1, 6)], (5,), None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_catch_error_leaves_the_reference_queue(name):
    events, critical, ids = SCENARIOS[name]
    (ref, ref_q, _), (port, port_q, _) = _checkers(
        critical=critical, device_ids=ids)
    for ev in events:
        ref.catch_error(FakeEvent(*ev))
        port.catch_error(FakeEvent(*ev))
    want = _drain(ref_q)
    assert _drain(port_q) == want
    assert {k: v.health for k, v in port.devices.items()} == {
        k: v.health for k, v in ref.devices.items()}
    if name in ("always_critical", "configured", "host_event_marks_all"):
        assert want and all(h == UNHEALTHY for _, h in want)


@pytest.mark.parametrize("flaky", [False, True], ids=["flow", "recover"])
def test_listen_loop_matches_reference(monkeypatch, flaky):
    # Events flow through the listen thread; a failing wait is recovered
    # (once) and the loop listens on.  Both checkers, the same script.
    for mod in (ref_health, H):
        monkeypatch.setattr(mod, "WAIT_TIMEOUT_MS", 100)
        monkeypatch.setattr(mod, "RECOVER_BACKOFF_S", 0.01)
    got = []
    for hc, hq, src in _checkers():
        src.broken, src.recover_calls = flaky, 0
        real_wait = src.wait

        def wait(ms, src=src, real_wait=real_wait):
            if src.broken:
                raise RuntimeError("event wait failed: -2")
            return real_wait(ms)

        def recover(src=src):
            src.recover_calls += 1
            src.broken = False

        src.wait, src.recover = wait, recover
        hc.start()
        try:
            src.events.put(FakeEvent(1, 1))
            d = hq.get(timeout=5)
            got.append(((d.ID, d.health), src.recover_calls))
        finally:
            hc.stop()
        assert src.closed
    assert got[0] == got[1] == (("nvidia1", UNHEALTHY), int(flaky))


# -- the vendor layer ------------------------------------------------------
ACTIVE = {0: 1, 1: 1}
DOWN = {0: 1, 1: 0}


def _vendor(links=None, clocks=None, n=2):
    fake = FakeNvml(n=n, links=links, clocks=clocks)
    nv = N.Nvml(lib=fake)
    src = H.NvmlFieldsEventSource.probe(H.NvmlEventSource(nv), nv)
    assert src is not None
    src.POLL_INTERVAL_S = 0.0  # poll every wait
    return src, fake


def _codes(src, k=1):
    out = []
    for _ in range(k):
        ev = src.wait(1)
        out.append(None if ev is None else (ev.device_index, ev.error_code))
    return out if k > 1 else out[0]


def test_link_down_raises_link_fatal_once_and_recovers():
    src, fake = _vendor(links=[dict(ACTIVE), dict(ACTIVE)])
    assert _codes(src) is None  # the baseline: every link active
    fake.links[1] = dict(DOWN)
    ev = src.wait(1)
    assert (ev.device_index, ev.error_code) == (1, H.LINK_FATAL)
    assert not ev.is_host_event
    assert _codes(src) is None  # edge-triggered
    fake.links[1] = dict(ACTIVE)
    assert _codes(src) == (1, H.ERROR_CLEARED)
    assert _codes(src) is None  # recovery emits once
    fake.links[1] = dict(DOWN)
    assert _codes(src) == (1, H.LINK_FATAL)  # a fresh edge


def test_link_never_seen_active_is_not_judged():
    # A link disabled from the first read may be the topology: never a
    # drain on a guess.
    src, fake = _vendor(links=[dict(DOWN), dict(ACTIVE)])
    assert _codes(src, 3) == [None] * 3
    assert src.sdk_state() == "active"


def test_recovery_survives_a_read_outage():
    src, fake = _vendor(links=[dict(ACTIVE), dict(ACTIVE)])
    src.wait(1)
    fake.links[1] = dict(DOWN)
    assert _codes(src) == (1, H.LINK_FATAL)
    fake.rc["nvmlDeviceGetNvLinkState"] = 999  # a failed read
    assert _codes(src) is None
    assert src.sdk_state() == "active"  # the clocks still read
    fake.rc.pop("nvmlDeviceGetNvLinkState")
    fake.links[1] = dict(ACTIVE)  # recovered meanwhile
    assert _codes(src) == (1, H.ERROR_CLEARED)
    assert _codes(src) is None


def test_unparseable_state_never_emits_recovery():
    src, fake = _vendor(links=[dict(ACTIVE), dict(ACTIVE)])
    src.wait(1)
    fake.links[1] = dict(DOWN)
    assert _codes(src) == (1, H.LINK_FATAL)
    fake.links[1] = {0: 1, 1: 7}  # neither enabled nor disabled
    assert _codes(src) is None  # neither fatal nor recovery
    fake.links[1] = dict(ACTIVE)
    assert _codes(src) == (1, H.ERROR_CLEARED)


def test_link_latch_clears_on_failed_reads():
    src, fake = _vendor(links=[dict(ACTIVE), dict(ACTIVE)])
    src.wait(1)
    fake.links[1] = dict(DOWN)
    assert _codes(src) == (1, H.LINK_FATAL)
    assert _codes(src) is None  # latched
    fake.rc["nvmlDeviceGetNvLinkState"] = 999
    assert _codes(src) is None
    fake.rc.pop("nvmlDeviceGetNvLinkState")
    assert _codes(src) == (1, H.LINK_FATAL)  # re-emits after the outage


def test_no_nvlink_on_any_card_reads_empty():
    src, _ = _vendor(links=[{}, {}])
    assert _codes(src, 2) == [None, None]
    assert src._metric_state[src.LINKS] == "empty"


@pytest.mark.parametrize("bit", [N.CLOCKS_EVENT_HW_SLOWDOWN,
                                 N.CLOCKS_EVENT_HW_THERMAL,
                                 N.CLOCKS_EVENT_HW_POWER_BRAKE])
def test_throttle_requires_sustained_polls(bit):
    src, fake = _vendor(clocks=[bit | 0x1, 0])
    assert _codes(src) is None  # poll 1: the streak starts
    assert _codes(src) == (0, H.THROTTLE_SEVERE)  # poll 2: sustained
    assert _codes(src) is None  # still slowed: no re-emit
    fake.clocks[0] = 0
    assert _codes(src) is None  # clear: the streak resets
    fake.clocks[0] = bit
    assert _codes(src) is None  # one new poll is a blip


@pytest.mark.parametrize("mask", [0x1, 0x2, 0x4, 0x10, 0x20, 0x100])
def test_other_clocks_reasons_never_throttle(mask):
    src, _ = _vendor(clocks=[mask, mask])
    assert _codes(src, 4) == [None] * 4


def test_throttle_streak_resets_on_failed_read_and_latch_holds():
    src, fake = _vendor(clocks=[0x8, 0])
    assert _codes(src) is None
    fake.rc["nvmlDeviceGetCurrentClocksEventReasons"] = 999
    assert _codes(src) is None  # the failed read clears the streak
    fake.rc.pop("nvmlDeviceGetCurrentClocksEventReasons")
    assert _codes(src) is None  # restarts at 1
    assert _codes(src) == (0, H.THROTTLE_SEVERE)
    fake.rc["nvmlDeviceGetCurrentClocksEventReasons"] = 999
    assert _codes(src) is None  # a blip mid-condition
    fake.rc.pop("nvmlDeviceGetCurrentClocksEventReasons")
    assert _codes(src, 2) == [None, None]  # re-sustained: latched
    fake.clocks[0] = 0
    assert _codes(src) is None
    fake.clocks[0] = 0x8
    assert _codes(src, 2) == [None, (0, H.THROTTLE_SEVERE)]


def test_sdk_state_tracks_liveness():
    src, fake = _vendor(links=[{}, {}])
    assert src.sdk_state() == "absent"  # nothing polled yet
    src.wait(1)
    assert src.sdk_state() == "active"  # the clocks read
    fake.rc["nvmlDeviceGetCurrentClocksEventReasons"] = 999
    src.wait(1)
    assert src.sdk_state() == "empty"  # no links, clocks failing
    fake.rc["nvmlDeviceGetNvLinkState"] = 999
    src.wait(1)
    assert src.sdk_state() == "absent"
    fake.rc.clear()
    fake.links = [{0: 5}, {0: 9}]
    fake.rc["nvmlDeviceGetCurrentClocksEventReasons"] = 999
    src.wait(1)
    assert src.sdk_state() == "unparseable"
    assert set(util.SDK_STATES) >= set(src._metric_state.values())
    hc = H.GPUHealthChecker({}, queue.Queue())
    assert hc.sdk_state() == "absent"
    hc._source = src
    assert hc.sdk_state() == "unparseable"


def test_xid_events_win_and_vendor_events_queue():
    src, fake = _vendor(links=[dict(ACTIVE), dict(ACTIVE)])
    src.wait(1)
    fake.links[0] = dict(DOWN)
    fake.events.put((0, 48))
    assert _codes(src) == (0, H.HBM_UNCORRECTABLE_ECC)
    assert _codes(src) == (0, H.LINK_FATAL)  # queued, not lost


def test_vendor_events_reach_the_checker_when_critical(monkeypatch):
    monkeypatch.setattr(H, "WAIT_TIMEOUT_MS", 100)
    src, fake = _vendor(links=[dict(ACTIVE), dict(ACTIVE)])
    src.wait(1)
    fake.links[1] = dict(DOWN)
    devices = {f"nvidia{i}": pb2.Device(ID=f"nvidia{i}", health=HEALTHY)
               for i in range(2)}
    hq = queue.Queue()
    hc = H.GPUHealthChecker(devices, hq, critical_errors=[H.LINK_FATAL],
                            event_source=src)
    hc.start()
    try:
        got = hq.get(timeout=10)
        assert (got.ID, got.health) == ("nvidia1", UNHEALTHY)
    finally:
        hc.stop()


# -- the NVML source and the factory -------------------------------------
def test_nvml_source_recovers_and_watches_new_devices():
    fake = FakeNvml(n=2)
    nv = N.Nvml(lib=fake)
    src = H.NvmlEventSource(nv)
    assert [c for c, *_ in fake.registered] == [0, 1]
    fake.n = 3  # a card appears
    fake.minors.append(2)
    src.refresh_devices()
    assert [c for c, *_ in fake.registered] == [0, 1, 2]
    src.refresh_devices()  # nothing new
    assert len(fake.registered) == 3
    fake.rc["nvmlEventSetFree"] = 999  # the old set is already gone
    src.recover()
    fake.rc.clear()
    assert fake.sets_made == 2
    assert [c for c, *_ in fake.registered[3:]] == [0, 1, 2]
    assert src.device_names() == ["nvidia0", "nvidia1", "nvidia2"]
    fake.events.put((2, 79))
    ev = src.wait(10)
    assert (ev.device_index, ev.error_code) == (2, H.FIRMWARE_PANIC)
    src.close()


def test_make_event_source():
    with pytest.raises(ValueError, match="health source"):
        H.make_event_source(N.Nvml(lib=FakeNvml()), source="nvml")
    with pytest.raises(ValueError, match="health source"):
        ref_health.make_event_source(source="nvml")
    nv = N.Nvml(lib=FakeNvml())
    assert type(H.make_event_source(nv, "native")) is H.NvmlEventSource
    assert type(H.make_event_source(nv, "auto")) is H.NvmlFieldsEventSource
    assert type(H.make_event_source(nv, "nvml-fields")) is (
        H.NvmlFieldsEventSource)
    bare = N.Nvml(lib=FakeNvml(vendor=False))
    assert type(H.make_event_source(bare, "auto")) is H.NvmlEventSource
    with pytest.raises(RuntimeError, match="nvml-fields health required"):
        H.make_event_source(bare, "nvml-fields")
    assert H.SOURCES == S.HEALTH_SOURCES


# -- the server ------------------------------------------------------------
def test_health_flags_parse():
    cfg = S.parse_args([])
    assert cfg.health_source == "" and cfg.health_critical == (
        S.HEALTH_CRITICAL)
    assert S.HEALTH_CRITICAL == {1, 2, 3, 4, 5, 1000}
    cfg = S.parse_args(["--health-source", "nvml-fields",
                        "--health-critical", "1, 6,100031"])
    assert cfg.health_source == "nvml-fields"
    assert cfg.health_critical == {1, 6, 100031}
    for bad in (["--health-source", "libtpu-sdk"],
                ["--health-critical", "1,two"]):
        with pytest.raises(SystemExit):
            S.parse_args(bad)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_drains_on_a_critical_event_and_restores(monkeypatch):
    # --health-source auto over a fake card: an application Xid never
    # drains; Xid 74 (code 2) does; the vendor layer's NVLink recovery
    # (ERROR_CLEARED) restores service.
    monkeypatch.setattr(H.NvmlFieldsEventSource, "POLL_INTERVAL_S", 0.0)
    fake = FakeNvml(n=1, links=[dict(ACTIVE)])
    app = S.ServingApp(S.parse_args([
        "--model", "transformer_lm", "--dim", "32", "--depth", "1",
        "--vocab", "64", "--max-seq", "32", "--slots", "2", "--device",
        "cpu", "--no-observe", "--health-source", "auto",
        "--health-critical", "1,2"]), nvml=N.Nvml(lib=fake))
    httpd = app.make_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        app.load_model()
        assert _get(port, "/healthz") == (200, "ok")
        watch = app._health_watch
        assert isinstance(app._health_source, H.NvmlFieldsEventSource)
        fake.events.put((0, 31))
        wait_until(lambda: fake.events.empty(), 10, what="xid 31 read")
        time.sleep(0.3)
        assert _get(port, "/healthz") == (200, "ok")
        fake.events.put((0, 74))
        wait_until(lambda: app.draining() == "device-health", 10,
                   what="the drain")
        code, body = _get(port, "/healthz")
        assert code == 503 and "device-health" in body
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"prompt": [[1, 2, 3]], "max_new": 2}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 503
        assert watch.unhealthy == {0}
        fake.links[0] = {0: 1, 1: 0}  # a link goes down ...
        wait_until(lambda: 0 in app._health_source._link_fatal_emitted,
                   10, what="the link edge")
        fake.links[0] = dict(ACTIVE)  # ... and comes back: ERROR_CLEARED
        wait_until(lambda: app.draining() == "", 15, what="the restore")
        assert _get(port, "/healthz") == (200, "ok")
    finally:
        app.drain_for_shutdown(httpd, timeout=5)
        app.close()
    assert fake.sets_freed  # close frees the watch's event set


def test_server_health_source_without_nvml_fails_to_load(monkeypatch):
    monkeypatch.setattr(N, "LIBRARY", "libnvidia-ml-absent.so.1")
    app = S.ServingApp(S.parse_args([
        "--model", "transformer_lm", "--dim", "32", "--depth", "1",
        "--vocab", "64", "--max-seq", "32", "--slots", "2", "--device",
        "cpu", "--no-observe", "--health-source", "native"]))
    try:
        with pytest.raises(N.NvmlUnavailable):
            app.load_model()
        assert not app.ready.is_set()
    finally:
        app.close()
