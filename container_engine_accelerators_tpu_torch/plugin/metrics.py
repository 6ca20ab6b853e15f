"""Prometheus metrics exporter with per-container GPU attribution.  The
port of container_engine_accelerators_tpu/plugin/metrics.py.

  - the seven-gauge surface: per container duty_cycle / memory_total /
    memory_used / request, and the node trio duty_cycle_node_gpu /
    memory_total_node_gpu / memory_used_node_gpu;
  - a collection pass every interval (30 s by default), the label reset
    every 60 s, per-container attribution through the kubelet's
    PodResources API (podresources.py);
  - the `Collector` seam: tests pass their own collector; the daemon's is
    `make_collector`'s: `NvmlCollector` (duty cycle, total and used
    memory from native/nvml.py) with, on "auto" where NVML serves it,
    the nvml-fields layer `NvmlFieldsCollector` over it;
  - `register_external_provider` and `attach_external_registry` put
    serving-side series (the port's serving/observe.py Registry) on the
    same scrape.

SDK_NODE_METRICS keeps the reference's vendor-only node gauges, renamed
`*_node_gpu`.  No NVML read serves any of them on an H100 (ROADMAP §C
says what each would need), so each gauge stays absent, as the
reference leaves a gauge absent until its runtime serves it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from prometheus_client import CollectorRegistry, Gauge, start_http_server
from prometheus_client.core import (
    CounterMetricFamily,
    GaugeMetricFamily,
    HistogramMetricFamily,
)

from ..native import nvml as nvml_mod
from . import podresources, slices, topology, util
from .api import RESOURCE_NAME

log = logging.getLogger(__name__)

MAKE_LABEL = "nvidia"
DUTY_CYCLE_WINDOW_S = 10
METRICS_RESET_INTERVAL_S = 60.0
# How long a card that stayed unknown after a rediscovery is suppressed
# before rediscovery is tried for it again.
UNRESOLVABLE_RETRY_S = 300.0

# The reference's vendor-only node gauges: absent on this card (module
# docstring).
SDK_NODE_METRICS = {
    "tensorcore_util": (
        "tensorcore_util_node_gpu",
        "Percent of time the tensor cores were computing (vendor layer)",
    ),
    "collective_e2e_latency": (
        "collective_e2e_latency_node_gpu",
        "End-to-end collective latency as served by the vendor layer",
    ),
    "hlo_queue_size": (
        "hlo_queue_size_node_gpu",
        "Depth of the execution queue as served by the vendor layer",
    ),
    "buffer_transfer_latency": (
        "buffer_transfer_latency_node_gpu",
        "Buffer transfer latency as served by the vendor layer",
    ),
    "host_to_device_transfer_latency": (
        "host_to_device_transfer_latency_node_gpu",
        "Host-to-device transfer latency as served by the vendor layer",
    ),
    "device_to_host_transfer_latency": (
        "device_to_host_transfer_latency_node_gpu",
        "Device-to-host transfer latency as served by the vendor layer",
    ),
}
SDK_STATES = util.SDK_STATES
SOURCES = ("auto", "native", "nvml-fields")


class Collector:
    """Seam over the device metric sources."""

    def device_names(self) -> List[str]:
        raise NotImplementedError

    def model(self, name: str) -> str:
        raise NotImplementedError

    def memory_total_bytes(self, name: str) -> int:
        raise NotImplementedError

    def memory_used_bytes(self, name: str) -> int:
        raise NotImplementedError

    def duty_cycle(self, name: str, window_s: float) -> float:
        """The card's busy percentage, 0..100.  Raises on unavailable
        data."""
        raise NotImplementedError

    def sdk_metric(self, metric: str, name: str) -> float:
        """A SDK_NODE_METRICS entry for one card.  Raises where no vendor
        layer serves it."""
        raise NotImplementedError(f"no vendor layer serves {metric}")

    def sdk_state(self) -> str:
        """Liveness of the vendor layer, one of util.SDK_STATES
        ("absent" without one)."""
        return "absent"

    def rediscover(self) -> None:
        """Refresh the device list (hotplug).  Default: no-op."""


class NvmlCollector(Collector):
    """The production collector over NVML (the reference's
    NativeCollector over libtpuinfo): duty cycle from
    nvmlDeviceGetUtilizationRates (NVML's own sample period stands in
    for the trailing window), total and used memory from
    nvmlDeviceGetMemoryInfo.  Opens NVML where none is given
    (NvmlUnavailable without the library); raises where NVML lists no
    card, rather than export nothing."""

    def __init__(self, nvml=None, platform: Optional[topology.Platform] = None):
        self._nv = nvml_mod.Nvml() if nvml is None else nvml
        self._names = self._nv.device_names()
        if not self._names:
            raise RuntimeError("NVML lists no GPU to export metrics for")
        self._index = {n: i for i, n in enumerate(self._names)}
        self._explicit_platform = platform
        self.platform = platform or topology.detect_platform(len(self._names))

    def device_names(self) -> List[str]:
        return self._names

    def model(self, name: str) -> str:
        return self.platform.accelerator_type

    def _resolve(self, name: str) -> int:
        """A card name's current NVML index.  The session's device list
        may change under a hotplug, so a cached index is trusted only
        while it still maps back to the name."""
        idx = self._index.get(name)
        if idx is not None and idx < self._nv.device_count:
            if self._nv.device_name(idx) == name:
                return idx
        self.rediscover()
        idx = self._index.get(name)
        if idx is None:
            raise RuntimeError(f"device {name} not listed by NVML")
        return idx

    def memory_total_bytes(self, name: str) -> int:
        return self._nv.memory_total_bytes(self._resolve(name))

    def memory_used_bytes(self, name: str) -> int:
        return self._nv.memory_used_bytes(self._resolve(name))

    def duty_cycle(self, name: str, window_s: float) -> float:
        v = self._nv.average_duty_cycle(self._resolve(name))
        if v is None:
            raise RuntimeError(f"NVML serves no utilization for {name}")
        return v

    def memory_allocated_bytes(self, name: str) -> int:
        return self._nv.memory_allocated_bytes(self._resolve(name))

    def rediscover(self) -> None:
        """Hotplug: re-read NVML's device list."""
        self._nv.sync_device_count()
        self._names = self._nv.device_names()
        self._index = {n: i for i, n in enumerate(self._names)}
        # An explicit platform is permanent; a detected one tracks the
        # card count.
        if self._explicit_platform is None:
            self.platform = topology.detect_platform(len(self._names))


class NvmlFieldsCollector(Collector):
    """The vendor layer over NvmlCollector (the reference's
    LibtpuSdkCollector with NVML's reads in place of the libtpu SDK's):
    used memory through nvmlDeviceGetMemoryInfo_v2, whose used bytes
    leave out the NVIDIA driver's reservation (NVML's plain read counts
    it in), and the SDK_NODE_METRICS entries, none of which NVML serves
    on an H100.  A failed read falls back to the base collector for that
    read, and each read's liveness ("active", or "absent" for a failed
    or unserved read) aggregates into `sdk_state`."""

    MEMORY = "memory_info_v2"

    def __init__(self, base: NvmlCollector):
        self._base = base
        self._metric_state: Dict[str, str] = {}

    @classmethod
    def probe(cls, base: NvmlCollector, nvml):
        """An instance where `nvml` exports the v2 memory read, else
        None."""
        if not nvml.serves_memory_v2:
            return None
        return cls(base)

    def sdk_state(self) -> str:
        return util.aggregate_sdk_state(self._metric_state.values())

    def sdk_metric(self, metric: str, name: str) -> float:
        self._metric_state[metric] = "absent"
        raise RuntimeError(f"no NVML read serves {metric} on this card")

    def device_names(self) -> List[str]:
        return self._base.device_names()

    def model(self, name: str) -> str:
        return self._base.model(name)

    def memory_total_bytes(self, name: str) -> int:
        return self._base.memory_total_bytes(name)

    def memory_used_bytes(self, name: str) -> int:
        try:
            used = self._base.memory_allocated_bytes(name)
        except nvml_mod.NvmlError as e:
            log.debug("metrics: %s unreadable for %s: %s", self.MEMORY, name, e)
            self._metric_state[self.MEMORY] = "absent"
            return self._base.memory_used_bytes(name)
        self._metric_state[self.MEMORY] = "active"
        return used

    def duty_cycle(self, name: str, window_s: float) -> float:
        return self._base.duty_cycle(name, window_s)

    def rediscover(self) -> None:
        self._base.rediscover()


def make_collector(
    nvml=None,
    platform: Optional[topology.Platform] = None,
    source: str = "auto",
) -> Collector:
    """The production collector: "native" NvmlCollector alone,
    "nvml-fields" the vendor layer over it (RuntimeError where NVML
    exports no v2 memory read), "auto" the vendor layer where NVML
    serves it.  `nvml`: an open nvml.Nvml (default: open the NVIDIA
    driver's)."""
    if source not in SOURCES:
        raise ValueError(f"unknown metrics source {source!r}")
    if nvml is None:
        nvml = nvml_mod.Nvml()
    base = NvmlCollector(nvml, platform)
    if source == "native":
        return base
    vendor = NvmlFieldsCollector.probe(base, nvml)
    if vendor is not None:
        log.info(
            "metrics: nvml-fields layer installed over the NVML collector "
            "(liveness exported as gpu_sdk_source_state{layer=metrics})"
        )
        return vendor
    if source == "nvml-fields":
        raise RuntimeError(
            "nvml-fields metrics required but this NVML exports no "
            "nvmlDeviceGetMemoryInfo_v2"
        )
    return base


class ExternalRegistryCollector:
    """Bridges a serving observe.Registry (the port's serving/observe.py
    registry of the continuous-batching engine) into a
    prometheus_client scrape: engine TTFT/ITL histograms and counters
    ride the SAME /metrics response as the device duty-cycle/HBM
    gauges, the way the paper's exporter publishes one node-wide
    surface.  collect() is crash-isolated — prometheus_client renders
    collectors inline during the scrape, so an exception here would
    500 the whole endpoint and take the DEVICE series down with it;
    instead a broken external registry drops only its own families
    (logged once per distinct error)."""

    def __init__(self, name: str, external_registry):
        self._name = name
        self._ext = external_registry
        self._logged: Optional[str] = None

    def _family(self, snap):
        labels, _ = snap.samples[0] if snap.samples else ({}, None)
        labelnames = list(labels.keys())

        def values(sample_labels):
            return [str(sample_labels.get(k, "")) for k in labelnames]

        if snap.mtype == "counter":
            fam = CounterMetricFamily(snap.name, snap.help,
                                      labels=labelnames)
            for lv, v in snap.samples:
                fam.add_metric(values(lv), float(v))
            return fam
        if snap.mtype == "gauge":
            fam = GaugeMetricFamily(snap.name, snap.help,
                                    labels=labelnames)
            for lv, v in snap.samples:
                fam.add_metric(values(lv), float(v))
            return fam
        if snap.mtype == "histogram":
            fam = HistogramMetricFamily(snap.name, snap.help,
                                        labels=labelnames)
            for lv, s in snap.samples:
                cum = 0
                buckets = []
                for i, bound in enumerate(snap.bounds):
                    cum += s.counts[i]
                    buckets.append((str(float(bound)), cum))
                buckets.append(("+Inf", cum + s.counts[-1]))
                fam.add_metric(values(lv), buckets, s.sum)
            return fam
        return None

    def collect(self):
        try:
            snaps = self._ext.collect()
        except Exception as e:  # pylint: disable=broad-except
            msg = repr(e)
            if self._logged != msg:
                self._logged = msg
                log.warning(
                    "external registry %r failed to collect (its "
                    "families are dropped; device metrics serve): %s",
                    self._name, msg,
                )
            return []
        self._logged = None
        fams = []
        for snap in snaps:
            try:
                fam = self._family(snap)
            except Exception:  # pylint: disable=broad-except
                continue  # one malformed family must not drop the rest
            if fam is not None:
                fams.append(fam)
        return fams


class MetricServer:
    """Exposes GPU metrics for all containers and the node in Prometheus
    format.

    Beyond the device surface, two extension seams let serving-side
    series ride the same scrape:
    `register_external_provider` adds per-pass gauge providers with
    PER-PROVIDER containment (an engine provider crash must not drop
    device metrics — the same rule as the per-card try/except), and
    `attach_external_registry` bridges a whole serving
    observe.Registry (histograms included) into the scrape."""

    def __init__(
        self,
        collection_interval_ms: int = 30000,
        port: int = 2112,
        collector: Optional[Collector] = None,
        pod_resources_fn: Optional[Callable[[], Dict]] = None,
        registry: Optional[CollectorRegistry] = None,
        device_resolver: Optional[Callable[[str], Sequence[str]]] = None,
        metrics_source: str = "auto",
    ):
        self.collection_interval_ms = collection_interval_ms
        self.port = port
        self.collector = collector
        self.metrics_source = metrics_source
        self.pod_resources_fn = pod_resources_fn or (
            lambda: podresources.get_devices_for_all_containers(
                resource_name=RESOURCE_NAME
            )
        )
        # Maps a schedulable device ID to the card names it covers
        # (slices span several cards).  Default: identity for nvidiaN,
        # drop others.
        self.device_resolver = device_resolver or (
            lambda d: [d] if slices.CARD_DEVICE_RE.match(d) else []
        )
        self.registry = registry or CollectorRegistry()
        # Collection-pass state below is serialized by _collect_lock:
        # the collector thread owns the periodic passes, but tests and
        # operator debug hooks call collect_once/update_metrics
        # directly, and two interleaved passes would corrupt the
        # suppression map mid-iteration.
        self._collect_lock = threading.Lock()
        # Chips that stayed unknown after a rediscovery, mapped to the
        # monotonic deadline when rediscovery may be retried for them —
        # a dead-but-still-assigned card must not trigger an NVML re-read
        # on every pass, but one that comes back should recover eventually.
        self._unresolvable: Dict[str, float] = {}  # guarded-by: _collect_lock
        self._last_reset = time.monotonic()  # guarded-by: _collect_lock
        # External gauge providers (class docstring): name -> callable
        # returning {metric_name: value} (or None when the provider
        # updates its own gauges).  Run once per collection pass, each
        # inside its own try/except.
        self._external_providers: Dict[str, Callable] = {}  # guarded-by: _collect_lock
        self._external_gauges: Dict[str, Gauge] = {}  # guarded-by: _collect_lock
        self._provider_logged: Dict[str, str] = {}  # guarded-by: _collect_lock
        # Attached registry bridges: name -> ExternalRegistryCollector,
        # retained so re-attach/detach can unregister the old one.
        self._external_registries: Dict[str, object] = {}  # guarded-by: _collect_lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._httpd = None

        common = ["make", "accelerator_id", "model"]
        container = ["namespace", "pod", "container"] + common
        g = lambda name, doc, labels: Gauge(  # noqa: E731
            name, doc, labels, registry=self.registry
        )
        self.duty_cycle_node = g(
            "duty_cycle_node_gpu",
            "Percent of time when the GPU was actively processing, per node",
            common,
        )
        self.memory_total_node = g(
            "memory_total_node_gpu",
            "Total GPU memory available in bytes, per node",
            common,
        )
        self.memory_used_node = g(
            "memory_used_node_gpu",
            "Allocated GPU memory in bytes, per node",
            common,
        )
        self.duty_cycle = g(
            "duty_cycle",
            "Percent of time when the GPU was actively processing",
            container,
        )
        self.memory_total = g(
            "memory_total", "Total GPU memory available in bytes", container
        )
        self.memory_used = g(
            "memory_used", "Allocated GPU memory in bytes", container
        )
        self.accelerator_requests = Gauge(
            "request",
            "Number of accelerator devices requested by the container",
            ["namespace", "pod", "container", "resource_name"],
            registry=self.registry,
        )
        self.sdk_node_gauges = {
            metric: g(gname, doc, common)
            for metric, (gname, doc) in SDK_NODE_METRICS.items()
        }
        # Vendor-layer liveness as an enum gauge, so a layer that serves
        # nothing is visible.  layer=metrics is this exporter's
        # collector; layer=health is wired by the daemon when health
        # monitoring runs in the same process.
        self.sdk_source_state = Gauge(
            "gpu_sdk_source_state",
            "Liveness of the nvml-fields layer (1 on the current state)",
            ["layer", "state"],
            registry=self.registry,
        )
        self.health_sdk_state_fn: Optional[Callable[[], str]] = None
        self._sdk_state_logged: Dict[str, str] = {}

    def register_external_provider(
        self, name: str,
        provider: Callable[[], Optional[Dict[str, float]]],
    ) -> None:
        """Add (or replace) a per-pass gauge provider.  The provider
        is called once per collection pass; a returned
        {metric_name: value} mapping is exported as one Gauge per
        metric name, labeled by provider.  A provider that raises is
        SKIPPED for that pass (logged once per distinct error) —
        device metrics and every other provider still collect, the
        per-card containment rule applied one layer up."""
        with self._collect_lock:
            self._external_providers[name] = provider

    def unregister_external_provider(self, name: str) -> None:
        with self._collect_lock:
            self._external_providers.pop(name, None)

    def attach_external_registry(self, name: str,
                                 external_registry) -> None:
        """Bridge a serving observe.Registry into this exporter's
        scrape (ExternalRegistryCollector): engine histograms and
        counters render next to the device gauges.  Crash-isolated
        per scrape.  Re-attaching under the same name REPLACES the
        previous bridge (an engine rebuild must not strand a collector
        serving the dead engine's frozen series, and a second
        register of the same family names would raise out of
        prometheus_client)."""
        collector = ExternalRegistryCollector(name, external_registry)
        with self._collect_lock:
            old = self._external_registries.pop(name, None)
            if old is not None:
                try:
                    self.registry.unregister(old)
                except KeyError:
                    pass
            self.registry.register(collector)
            self._external_registries[name] = collector

    def detach_external_registry(self, name: str) -> None:
        with self._collect_lock:
            collector = self._external_registries.pop(name, None)
        if collector is not None:
            try:
                self.registry.unregister(collector)
            except KeyError:
                pass

    def _collect_external_locked(self) -> None:  # holds-lock: _collect_lock
        for name, provider in list(self._external_providers.items()):
            try:
                values = provider()
            except Exception as e:  # pylint: disable=broad-except
                msg = repr(e)
                if self._provider_logged.get(name) != msg:
                    self._provider_logged[name] = msg
                    log.warning(
                        "external metrics provider %r failed (skipped "
                        "this pass; device metrics unaffected): %s",
                        name, msg,
                    )
                continue
            self._provider_logged.pop(name, None)
            if not values:
                continue
            for gname, value in values.items():
                gauge = self._external_gauges.get(gname)
                if gauge is None:
                    try:
                        gauge = Gauge(
                            gname,
                            f"External provider gauge ({gname})",
                            ["provider"],
                            registry=self.registry,
                        )
                    except Exception as e:  # pylint: disable=broad-except
                        log.warning(
                            "external provider %r gauge %r rejected: "
                            "%s", name, gname, e,
                        )
                        continue
                    self._external_gauges[gname] = gauge
                gauge.labels(name).set(float(value))

    def start(self) -> None:
        log.info("Starting metrics server")
        if self.collector is None:
            self.collector = make_collector(source=self.metrics_source)
        log.info(
            "metrics: found %d GPU devices", len(self.collector.device_names())
        )
        # Port 0 binds a free port; self.port is then the bound one.
        self._httpd, _ = start_http_server(self.port, registry=self.registry)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._collect_loop, daemon=True)
        self._thread.start()

    def _collect_loop(self) -> None:
        interval = self.collection_interval_ms / 1000.0
        while not self._stop.wait(interval):
            self.collect_once()

    def collect_once(self) -> None:
        try:
            container_devices = self.pod_resources_fn()
        except Exception as e:
            log.error("Failed to get devices for containers: %s", e)
            # The vendor liveness enum AND the external providers are
            # kubelet-independent: a broken PodResources socket must
            # not ALSO blind operators to the vendor-layer state or
            # the serving-engine gauges.
            self._export_sdk_states()
            with self._collect_lock:
                self._collect_external_locked()
            return
        self.update_metrics(container_devices)

    def update_metrics(self, container_devices: Dict) -> None:
        """One collection pass.  Serialized under _collect_lock (the
        collector thread, tests, and debug hooks may race here)."""
        with self._collect_lock:
            self._update_metrics_locked(container_devices)

    def _update_metrics_locked(self, container_devices: Dict) -> None:  # holds-lock: _collect_lock
        self._reset_metrics_if_needed()
        c = self.collector
        # Device rediscovery: a card the kubelet attributes that the
        # collector has never seen (hotplug after start) refreshes the
        # device list once before this pass.  Cards still unknown after
        # a refresh are remembered, so a dead but still assigned card
        # does not re-read NVML's device list on every pass.
        known = set(c.device_names())
        unknown = {
            card
            for devices in container_devices.values()
            for device_id in devices
            for card in self.device_resolver(device_id)
            if card not in known
        }
        now = time.monotonic()
        suppressed = {n for n, until in self._unresolvable.items() if until > now}
        if unknown - suppressed:
            log.info("metrics: unknown devices %s; rediscovering", sorted(unknown))
            try:
                c.rediscover()
            except Exception as e:
                # Transient failure: leave the suppression map alone so the
                # rediscovery is retried on the next pass.
                log.error("metrics: device rediscovery failed: %s", e)
            else:
                known = set(c.device_names())
                # Keep unexpired deadlines: a still-dead suppressed card must
                # not have its retry clock reset by rediscoveries triggered by
                # unrelated cards (that could postpone its retry forever under
                # hotplug churn).  An EXPIRED deadline is re-armed — the card
                # just got its retry via this rediscovery — so it doesn't
                # trigger a rediscovery storm on every following pass.
                self._unresolvable = {
                    n: (
                        self._unresolvable[n]
                        if self._unresolvable.get(n, 0) > now
                        else now + UNRESOLVABLE_RETRY_S
                    )
                    for n in unknown - known
                }
        elif not unknown:
            self._unresolvable.clear()
        for cid, devices in container_devices.items():
            self.accelerator_requests.labels(
                cid.namespace, cid.pod, cid.container, RESOURCE_NAME
            ).set(len(devices))
            for device_id in devices:
                for card in self.device_resolver(device_id):
                    # The WHOLE per-card section sits in one
                    # try/except-continue: model()/memory_*() raise on
                    # NVML hiccups just like duty_cycle() does,
                    # and an exception escaping update_metrics would
                    # kill the collector thread permanently (the loop
                    # has no catch) — one flaky card must cost one
                    # card-pass, not the whole exporter.
                    try:
                        duty = c.duty_cycle(card, DUTY_CYCLE_WINDOW_S)
                        model = c.model(card)
                        mem_total = c.memory_total_bytes(card)
                        mem_used = c.memory_used_bytes(card)
                    except Exception as e:  # pylint: disable=broad-except
                        log.info(
                            "Error collecting metrics for %s: %s; "
                            "skipping this device",
                            card,
                            e,
                        )
                        continue
                    labels = (cid.namespace, cid.pod, cid.container,
                              MAKE_LABEL, card, model)
                    self.duty_cycle.labels(*labels).set(duty)
                    self.memory_total.labels(*labels).set(mem_total)
                    self.memory_used.labels(*labels).set(mem_used)
        for card in c.device_names():
            # Same containment rule for the node loop: model() and the
            # sdk-gauge section run inside the per-card try so one
            # raising card (or a collapsing vendor layer) skips the card
            # instead of killing the collector thread.
            try:
                model = c.model(card)
                labels = (MAKE_LABEL, card, model)
                # Vendor-only inventory first: it must not depend on
                # the duty-cycle read below succeeding.
                for metric, gauge in self.sdk_node_gauges.items():
                    try:
                        val = c.sdk_metric(metric, card)
                    except Exception:  # pylint: disable=broad-except
                        # Absent until a vendor layer serves it.  The
                        # value is read before touching .labels(), so an
                        # unserved metric exports no series, not a zero.
                        continue
                    gauge.labels(*labels).set(val)
                duty = c.duty_cycle(card, DUTY_CYCLE_WINDOW_S)
                mem_total = c.memory_total_bytes(card)
                mem_used = c.memory_used_bytes(card)
            except Exception as e:  # pylint: disable=broad-except
                log.info(
                    "Error collecting node metrics for %s: %s; "
                    "skipping",
                    card,
                    e,
                )
                continue
            self.duty_cycle_node.labels(*labels).set(duty)
            self.memory_total_node.labels(*labels).set(mem_total)
            self.memory_used_node.labels(*labels).set(mem_used)
        self._collect_external_locked()
        self._export_sdk_states()

    def _export_sdk_states(self) -> None:
        if self.collector is not None:
            self._set_sdk_state("metrics", self.collector.sdk_state())
        if self.health_sdk_state_fn is not None:
            try:
                self._set_sdk_state("health", self.health_sdk_state_fn())
            except Exception:  # pylint: disable=broad-except
                log.exception("health sdk state read failed")

    def _set_sdk_state(self, layer: str, state: str) -> None:
        prev = self._sdk_state_logged.get(layer)
        if prev != state:
            # Transition log, the greppable counterpart of the enum
            # gauge; the health event source logs its own transitions.
            log.info(
                "gpu sdk source state: layer=%s %s -> %s",
                layer, prev or "(start)", state,
            )
            self._sdk_state_logged[layer] = state
        for s in SDK_STATES:
            self.sdk_source_state.labels(layer, s).set(
                1.0 if s == state else 0.0
            )

    def _reset_metrics_if_needed(self) -> None:  # holds-lock: _collect_lock
        if time.monotonic() - self._last_reset > METRICS_RESET_INTERVAL_S:
            for gauge in (
                self.accelerator_requests,
                self.duty_cycle,
                self.memory_total,
                self.memory_used,
                self.duty_cycle_node,
                self.memory_total_node,
                self.memory_used_node,
                *self.sdk_node_gauges.values(),
                # External provider gauges join the label GC: a
                # provider that unregisters (engine torn down) must
                # not leave stale series forever.
                *self._external_gauges.values(),
            ):
                gauge.clear()
            self._last_reset = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
