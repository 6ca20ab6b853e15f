"""GPU health: error events -> Unhealthy devices, and the event sources
the server's health-gated drain and the fleet's per-replica watches
subscribe to.  The port of
container_engine_accelerators_tpu/plugin/health.py (`EventSource` :90,
`NativeEventSource` :122-180, `LibtpuSdkEventSource` :196-470,
`make_event_source` :474, `TPUHealthChecker` :502-646).

The reference mirrors the Go `health_checker.go`: Xid 48 always
critical, a 5000 ms blocking event wait, a host-wide event marks every
device.  Here the events are NVML's own (native/nvml.py): each card's
Xid critical errors, with the Xid mapped onto the reference's error-code
taxonomy in one table (nvml.XID_CODES), so the codes keep their
meanings for every subscriber:
  0 = ERROR_CLEARED           (a recovery; never critical)
  1 = HBM_UNCORRECTABLE_ECC   (always critical, the Xid-48 code)
  2 = LINK_FATAL              (Xid 74; the vendor layer's NVLink edge)
  3 = ENGINE_HANG             (Xids 8, 119)
  4 = OVERTEMP_SHUTDOWN       (no Xid; nothing bound here reports it)
  5 = FIRMWARE_PANIC          (Xids 79, 62, 120)
  6 = THROTTLE_SEVERE         (the vendor layer: sustained hardware
                               slowdown, thermal slowdown or power brake)
  1000 = EVENT_DEVICE_REMOVED (NVML reports the card lost; host-wide)
Every other Xid arrives as nvml.XID_CODE_BASE + xid: critical only
where configured, so an application fault (Xid 13, 31, 43, ...) never
drains a card.

Sources (`make_event_source`): "native" is the Xid watch alone
(NvmlEventSource); "nvml-fields" layers the vendor reads over it
(NvmlFieldsEventSource, the counterpart of the reference's libtpu-SDK
layer) and raises where NVML serves none; "auto" layers them when NVML
serves them.  An NVIDIA driver that refuses event registration raises NvmlError
naming the refusal: no source reports a watch it does not have.

Only `GPUHealthChecker` builds kubelet Device messages, and it imports
the protobuf module itself, so the serving health path needs neither
grpc nor protobuf.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..native import nvml as nvml_mod
from . import util
from .api import UNHEALTHY

log = logging.getLogger(__name__)

# Code 1 (HBM uncorrectable ECC) is always critical, mirroring the
# always-on Xid 48 (health_checker.go:59).
ALWAYS_CRITICAL_ERRORS = frozenset({1})

WAIT_TIMEOUT_MS = 5000  # WaitForEvent parity (health_checker.go:238)
RECOVER_BACKOFF_S = 1.0  # pause before rebuilding a failed event watch

# A recovery: the device's reported condition resolved.  catch_error
# skips it; drain-on-bad-device subscribers (the server, the fleet)
# restore service on it.
ERROR_CLEARED = 0

HBM_UNCORRECTABLE_ECC = 1
LINK_FATAL = 2
ENGINE_HANG = 3
OVERTEMP_SHUTDOWN = 4
FIRMWARE_PANIC = 5
THROTTLE_SEVERE = 6

EVENT_DEVICE_REMOVED = nvml_mod.EVENT_DEVICE_REMOVED

SOURCES = ("auto", "native", "nvml-fields")


class EventSource:
    """Seam over the native event API.  wait() returns an object with
    .device_index (-1 for host-wide), .error_code, .timestamp_us — or
    None on timeout."""

    def device_names(self) -> List[str]:
        raise NotImplementedError

    def wait(self, timeout_ms: int):
        raise NotImplementedError

    def recover(self) -> None:
        """Re-establish the event watch after a wait() error.  Default:
        no-op."""

    def refresh_devices(self) -> None:
        """Register devices that appeared after start; called on each
        wait timeout.  Default: no-op."""

    def close(self) -> None:
        pass

    def sdk_state(self) -> str:
        """Liveness of the vendor layer behind this source, one of
        util.SDK_STATES ("absent" without one)."""
        return "absent"


class NvmlEventSource(EventSource):
    """The production source: NVML's Xid critical-error events on every
    card (the reference's NativeEventSource)."""

    def __init__(self, nvml=None):
        self._nvml = nvml_mod.Nvml() if nvml is None else nvml
        self._set = None
        self._registered = 0
        self._register_all()

    def _register_all(self) -> None:
        self._set = self._nvml.event_set_create()
        self._registered = 0
        try:
            self._register_new()
        except nvml_mod.NvmlError:
            self._nvml.event_set_free(self._set)
            self._set = None
            raise

    def _register_new(self) -> int:
        """Watch the devices past the registered ones; returns how many."""
        n = self._nvml.device_count
        for i in range(self._registered, n):
            self._nvml.register_event(self._set, i)
        added, self._registered = n - self._registered, n
        return added

    def device_names(self) -> List[str]:
        return self._nvml.device_names()

    def wait(self, timeout_ms: int):
        return self._nvml.wait_for_event(self._set, timeout_ms)

    def recover(self) -> None:
        """NVML cannot refresh a set in place: free it (it may already be
        gone) and register every device anew."""
        if self._set is not None:
            try:
                self._nvml.event_set_free(self._set)
            except nvml_mod.NvmlError as e:
                log.info("health: freeing the old event set: %s", e)
        self._nvml.sync_device_count()
        self._register_all()

    def refresh_devices(self) -> None:
        """Watch devices NVML lists since the last look."""
        self._nvml.sync_device_count()
        added = self._register_new()
        if added:
            log.info("health checker: watching %d new device(s)", added)

    def close(self) -> None:
        if self._set is not None:
            self._nvml.event_set_free(self._set)
            self._set = None


class NvmlFieldsEventSource(EventSource):
    """The vendor layer over the Xid watch: the reference's
    LibtpuSdkEventSource with NVML's reads in place of the libtpu SDK's
    two metrics.

    Delegates the blocking wait to the base source, then (at most once
    per POLL_INTERVAL_S) reads each card's NVLink states and
    clocks-event reasons:
      - an NVLink that was seen active and now reads inactive makes its
        card bad: LINK_FATAL once per healthy-to-bad edge, and
        ERROR_CLEARED once every such link reads active again.  A link
        never seen active (disabled from the start, or absent) is not
        judged, and a state other than 0 / 1 counts as healthy for the
        bad edge and never as a recovery;
      - hardware slowdown, hardware thermal slowdown or power brake
        (nvml.SEVERE_CLOCKS_EVENTS) held for THROTTLE_SUSTAIN_POLLS
        consecutive successful polls emits THROTTLE_SEVERE once, until a
        poll reads the card clear.
    A failed read clears that metric's edge latch or streak (the next
    bad read counts fresh), and per-metric liveness ("active" /
    "unparseable" / "empty" for no NVLink on any card / "absent" for a
    failed read) aggregates into `sdk_state`."""

    POLL_INTERVAL_S = 5.0
    THROTTLE_SUSTAIN_POLLS = 2
    LINKS, CLOCKS = "nvlink_state", "clocks_event_reasons"

    def __init__(self, base: EventSource, nvml):
        self._nvml = nvml
        self._base = base
        self._pending: "collections.deque" = collections.deque()
        self._bad: Dict[int, bool] = {}  # the link edge latch
        # Links ever seen active, per card: the baseline a link is
        # judged against.  Survives read outages.
        self._seen_active: Dict[int, set] = {}
        # Cards with LINK_FATAL emitted and no ERROR_CLEARED since;
        # survives read outages, so a recovery after one is delivered.
        self._link_fatal_emitted: set = set()
        self._streak: Dict[int, int] = {}
        # Cards with THROTTLE_SEVERE emitted and not read clear since.
        self._throttle_emitted: set = set()
        self._last_poll = 0.0
        self._metric_state: Dict[str, str] = {}
        self._logged_state = ""

    @classmethod
    def probe(cls, base: EventSource, nvml):
        """An instance when `nvml` exports the vendor reads, else None."""
        if not nvml.serves_vendor_reads:
            return None
        return cls(base, nvml)

    # -- delegation ------------------------------------------------------
    def device_names(self) -> List[str]:
        return self._base.device_names()

    def recover(self) -> None:
        self._base.recover()

    def refresh_devices(self) -> None:
        self._base.refresh_devices()

    def close(self) -> None:
        self._base.close()

    def wait(self, timeout_ms: int):
        event = self._base.wait(timeout_ms)
        self._poll()
        if event is not None:
            return event
        return self._pending.popleft() if self._pending else None

    def sdk_state(self) -> str:
        return util.aggregate_sdk_state(self._metric_state.values())

    @staticmethod
    def _event(device_index: int, code: int):
        """A synthetic event from the vendor reads, an NVML one's shape."""
        return nvml_mod.Event(device_index, code, nvml_mod.Nvml.now_us())

    # -- polling -----------------------------------------------------------
    def _read(self, metric, n):
        """Per-card readings of `metric` (None: the read failed)."""
        read = (self._nvml.nvlink_states if metric == self.LINKS
                else self._nvml.clocks_event_reasons)
        try:
            return [read(i) for i in range(n)]
        except nvml_mod.NvmlError as e:
            log.debug("health: %s unreadable: %s", metric, e)
            return None

    def _poll(self) -> None:
        now = time.monotonic()
        if now - self._last_poll < self.POLL_INTERVAL_S:
            return
        self._last_poll = now
        n = len(self._base.device_names())
        links = self._read(self.LINKS, n)
        if links is None or not any(links):
            # A failed read, or no card serving a link: the edge latch
            # clears, so a still-bad link re-emits on the next read.
            self._metric_state[self.LINKS] = (
                "absent" if links is None else "empty")
            self._bad.clear()
        else:
            self._poll_links(links)
        clocks = self._read(self.CLOCKS, n)
        if clocks is None:
            self._metric_state[self.CLOCKS] = "absent"
            self._streak.clear()
        else:
            self._metric_state[self.CLOCKS] = "active"
            self._poll_clocks(clocks)
        agg = self.sdk_state()
        if agg != self._logged_state:
            log.info("nvml-fields health layer state: %s (per-metric %s)",
                     agg, dict(self._metric_state))
            self._logged_state = agg

    def _poll_links(self, links) -> None:
        usable = False
        for idx, states in enumerate(links):
            recognized = bool(states) and all(
                v in (0, 1) for v in states.values())
            usable |= recognized
            seen = self._seen_active.setdefault(idx, set())
            seen.update(k for k, v in states.items() if v == 1)
            is_bad = recognized and any(states.get(k) == 0 for k in seen)
            if is_bad and not self._bad.get(idx, False):
                log.error("nvml: card %d has an NVLink down (states %r)",
                          idx, states)
                self._pending.append(self._event(idx, LINK_FATAL))
                self._link_fatal_emitted.add(idx)
            elif (not is_bad and recognized
                  and idx in self._link_fatal_emitted):
                log.info("nvml: card %d NVLinks recovered", idx)
                self._pending.append(self._event(idx, ERROR_CLEARED))
                self._link_fatal_emitted.discard(idx)
            self._bad[idx] = is_bad
        self._metric_state[self.LINKS] = "active" if usable else "unparseable"

    def _poll_clocks(self, masks) -> None:
        for idx, mask in enumerate(masks):
            if mask & nvml_mod.SEVERE_CLOCKS_EVENTS:
                streak = self._streak.get(idx, 0) + 1
            else:
                streak = 0
                self._throttle_emitted.discard(idx)
            self._streak[idx] = streak
            if (streak >= self.THROTTLE_SUSTAIN_POLLS
                    and idx not in self._throttle_emitted):
                log.error("nvml: card %d slowed by hardware for %d polls "
                          "(clocks-event reasons %#x)", idx, streak, mask)
                self._pending.append(self._event(idx, THROTTLE_SEVERE))
                self._throttle_emitted.add(idx)


def make_event_source(nvml=None, source: str = "auto") -> EventSource:
    """The production event source: "native" the Xid watch alone,
    "nvml-fields" the vendor layer over it (RuntimeError where NVML
    exports no vendor reads), "auto" the vendor layer where NVML serves
    it.  `nvml`: an open nvml.Nvml (default: open the NVIDIA driver's)."""
    if source not in SOURCES:
        raise ValueError(f"unknown health source {source!r}")
    if nvml is None:
        nvml = nvml_mod.Nvml()
    base = NvmlEventSource(nvml)
    if source == "native":
        return base
    vendor = NvmlFieldsEventSource.probe(base, nvml)
    if vendor is not None:
        log.info("health: nvml-fields layer installed over the Xid watch")
        return vendor
    if source == "nvml-fields":
        base.close()
        raise RuntimeError(
            "nvml-fields health required but this NVML exports no "
            "clocks-event-reason and NVLink-state reads"
        )
    return base


class GPUHealthChecker:
    """Watches the cards' error events and feeds Unhealthy device
    updates into the manager's health queue: the reference's
    TPUHealthChecker.  The daemon passes GPUManager's physical devices
    and its queue; ListAndWatch applies each update to the manager's
    registry (GPUManager.set_device_health), the one registry of the
    devices.  The checker's copy only tells a physical device from a
    card of a slice, whose name it sends for the manager to carry to
    its slice."""

    def __init__(
        self,
        devices: Dict,
        health_queue: "queue.Queue",
        critical_errors: Sequence[int] = (),
        event_source: Optional[EventSource] = None,
        source: str = "auto",
    ):
        from .api import deviceplugin_pb2 as dp_pb2

        self._device_type = dp_pb2.Device
        # A copy, so the manager's registry is written by the manager
        # alone; the listen thread and direct catch_error callers share
        # it under a lock.
        self._devices_lock = threading.Lock()
        self.devices: Dict = {  # guarded-by: _devices_lock
            k: dp_pb2.Device(ID=v.ID, health=v.health)
            for k, v in devices.items()
        }
        self.health = health_queue
        self.critical_errors = set(ALWAYS_CRITICAL_ERRORS)
        for c in critical_errors:
            log.info("health checker: adding critical error code %d", c)
            self.critical_errors.add(int(c))
        self._source = event_source
        self._source_kind = source
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        log.info("Starting GPU Health Checker")
        if self._source is None:
            self._source = make_event_source(source=self._source_kind)
        self._thread = threading.Thread(target=self._listen_to_events,
                                        daemon=True)
        self._thread.start()

    def sdk_state(self) -> str:
        """Liveness of this checker's vendor layer ("absent" before
        start or on a native-only source)."""
        if self._source is None:
            return "absent"
        return self._source.sdk_state()

    def _listen_to_events(self) -> None:
        while not self._stop.is_set():
            try:
                event = self._source.wait(WAIT_TIMEOUT_MS)
            except Exception as e:  # pylint: disable=broad-except
                # A native error: back off, rebuild the watch, listen on.
                log.error("health checker wait error: %s", e)
                self._stop.wait(RECOVER_BACKOFF_S)
                try:
                    self._source.recover()
                except Exception as re:  # pylint: disable=broad-except
                    log.error("health checker recover failed: %s", re)
                continue
            if event is None:
                try:
                    self._source.refresh_devices()
                except Exception as e:  # pylint: disable=broad-except
                    log.error("health checker device refresh failed: %s", e)
                continue
            self.catch_error(event)

    def catch_error(self, event) -> None:
        """Apply one error event to the device registry (catchError
        parity, health_checker.go:179-226)."""
        if (event.error_code not in self.critical_errors
                and not event.is_host_event):
            log.info("Health checker is skipping error code %d",
                     event.error_code)
            return
        if event.is_host_event:
            removed_name = getattr(event, "device_name", "")
            if event.error_code == EVENT_DEVICE_REMOVED and removed_name:
                # The lost card is named: mark it alone.
                log.error("GPU %s was removed with an error pending; "
                          "marking it unhealthy.", removed_name)
                with self._devices_lock:
                    known = removed_name in self.devices
                if known:
                    self._mark_unhealthy(removed_name)
                else:
                    self.health.put(self._device_type(ID=removed_name,
                                                      health=UNHEALTHY))
                return
            log.error("Host-wide GPU error: all devices will go unhealthy.")
            with self._devices_lock:
                dev_ids = list(self.devices)
            for dev_id in dev_ids:
                self._mark_unhealthy(dev_id)
            return
        names = self._source.device_names()
        if not 0 <= event.device_index < len(names):
            log.error("Critical error code=%d on unknown device index %d.",
                      event.error_code, event.device_index)
            return
        name = names[event.device_index]
        log.error("Critical GPU error code=%d on device=%s; the device will "
                  "go unhealthy.", event.error_code, name)
        with self._devices_lock:
            known = name in self.devices
        if known:
            self._mark_unhealthy(name)
        else:
            # Partitioned devices: emit the card's name for the manager
            # to propagate to its partitions.
            self.health.put(self._device_type(ID=name, health=UNHEALTHY))

    def _mark_unhealthy(self, dev_id: str) -> None:
        d = self._device_type(ID=dev_id, health=UNHEALTHY)
        with self._devices_lock:
            self.devices[dev_id] = d
        self.health.put(d)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * WAIT_TIMEOUT_MS / 1000)
        if self._source is not None:
            self._source.close()
