"""The port's metrics exporter (plugin/metrics.py) against the
reference's: both MetricServers run the same passes over the same card
readings (the port's NvmlCollector over the fake NVML of
tests/torch_fake_nvml.py; the reference's through an adapter that hands
it those readings under its names) and must export the same series,
names mapped (*_node_tpu -> *_node_gpu, make tpu -> nvidia, accelN ->
nvidiaN, google.com/tpu -> nvidia.com/gpu): node gauges, per-container
attribution, a failing card, a slice resolved to its cards, rediscovery
of an unknown card, the 60 s label reset, external providers and
registries (each package's serving/observe.py Registry).  Both packages'
PodResources clients against one kubelet stub on a unix socket.  Then
what is the port's own: the nvml-fields layer (used memory without the
NVIDIA driver's reservation, the fall-back, its state), make_collector's
sources, the vendor-only gauges absent, no NVML raising, and the HTTP
endpoint on a free port."""

import os
import re
import shutil
import tempfile
import time
import urllib.request
from concurrent import futures

import grpc
import pytest
from prometheus_client import CollectorRegistry

from torch_fake_nvml import FakeNvml
from container_engine_accelerators_tpu.plugin import metrics as ref_metrics
from container_engine_accelerators_tpu.plugin import (
    podresources as ref_podresources,
)
from container_engine_accelerators_tpu.plugin.api import (
    grpc_api as ref_grpc_api,
)
from container_engine_accelerators_tpu.serving import observe as ref_observe
from container_engine_accelerators_tpu_torch.native import nvml as N
from container_engine_accelerators_tpu_torch.plugin import metrics as MT
from container_engine_accelerators_tpu_torch.plugin import podresources as PR
from container_engine_accelerators_tpu_torch.plugin import topology as T
from container_engine_accelerators_tpu_torch.plugin.api import grpc_api
from container_engine_accelerators_tpu_torch.plugin.api import (
    podresources_pb2 as pr_pb2,
)
from container_engine_accelerators_tpu_torch.serving import observe

PLATFORM = T.PLATFORMS["nvidia-h100-80gb-2"]


def to_gpu(text):
    text = re.sub(r"accel(\d+)", r"nvidia\1", str(text))
    return (text.replace("_node_tpu", "_node_gpu")
            .replace("google.com/tpu", "nvidia.com/gpu")
            .replace("tpu_sdk_source_state", "gpu_sdk_source_state"))


def to_tpu(name):
    return name.replace("nvidia", "accel")


class RefAdapter(ref_metrics.Collector):
    """The reference's collector seam over the port's readings."""

    def __init__(self, port):
        self.port = port

    def device_names(self):
        return [to_tpu(n) for n in self.port.device_names()]

    def model(self, name):
        return self.port.model(to_gpu(name))

    def memory_total_bytes(self, name):
        return self.port.memory_total_bytes(to_gpu(name))

    def memory_used_bytes(self, name):
        return self.port.memory_used_bytes(to_gpu(name))

    def duty_cycle(self, name, window_s):
        return self.port.duty_cycle(to_gpu(name), window_s)

    def rediscover(self):
        self.port.rediscover()


def servers(fake, resolver=None):
    port_c = MT.NvmlCollector(N.Nvml(lib=fake), PLATFORM)
    ref = ref_metrics.MetricServer(
        collector=RefAdapter(port_c), registry=CollectorRegistry(),
        pod_resources_fn=dict,
        device_resolver=resolver and (
            lambda d: [to_tpu(n) for n in resolver(to_gpu(d))]))
    port = MT.MetricServer(collector=port_c, registry=CollectorRegistry(),
                           pod_resources_fn=dict, device_resolver=resolver)
    return ref, port


def series(server, mapped=False):
    out = set()
    for metric in server.registry.collect():
        for s in metric.samples:
            labels = {k: (to_gpu(v) if mapped else v)
                      for k, v in s.labels.items()}
            if mapped and labels.get("make") == "tpu":
                labels["make"] = "nvidia"
            name = to_gpu(s.name) if mapped else s.name
            out.add((name, tuple(sorted(labels.items())), s.value))
    return out


def same(ref, port):
    assert series(port) == series(ref, mapped=True)
    return series(port)


def passes(ref, port, attribution):
    ref.update_metrics({ref_podresources.ContainerID(*k): [to_tpu(d) for d in v]
                        for k, v in attribution.items()})
    port.update_metrics({PR.ContainerID(*k): v
                         for k, v in attribution.items()})
    return same(ref, port)


CID = ("default", "trainer-0", "main")


def test_node_and_container_gauges_match():
    fake = FakeNvml(n=2)
    fake.util = [75, 12]
    fake.used = [4 << 30, 9 << 30]
    ref, port = servers(fake)
    got = passes(ref, port, {})
    assert ("duty_cycle_node_gpu", (("accelerator_id", "nvidia0"),
            ("make", "nvidia"), ("model", "nvidia-h100-80gb-2")), 75.0) in got
    got = passes(ref, port, {CID: ["nvidia1"]})
    labels = (("accelerator_id", "nvidia1"), ("container", "main"),
              ("make", "nvidia"), ("model", "nvidia-h100-80gb-2"),
              ("namespace", "default"), ("pod", "trainer-0"))
    assert ("memory_used", labels, float(9 << 30)) in got
    assert ("request", (("container", "main"), ("namespace", "default"),
                        ("pod", "trainer-0"),
                        ("resource_name", "nvidia.com/gpu")), 1.0) in got


def test_a_failing_card_is_skipped_alike():
    fake = FakeNvml(n=2)
    ref, port = servers(fake)
    fake.rc["nvmlDeviceGetUtilizationRates"] = 999
    got = passes(ref, port, {CID: ["nvidia0"]})
    assert not any(n == "duty_cycle_node_gpu" for n, _, _ in got)
    assert any(n == "request" for n, _, _ in got)
    fake.rc["nvmlDeviceGetUtilizationRates"] = N.NVML_ERROR_NOT_SUPPORTED
    passes(ref, port, {CID: ["nvidia0"]})  # no utilization: skipped too


def test_a_slice_resolves_to_its_cards_alike():
    fake = FakeNvml(n=2)
    ref, port = servers(fake, resolver=lambda d: (
        ["nvidia0", "nvidia1"] if d == "slice0" else [d]))
    got = passes(ref, port, {CID: ["slice0"]})
    assert {dict(lb)["accelerator_id"] for n, lb, _ in got
            if n == "duty_cycle"} == {"nvidia0", "nvidia1"}


def test_unknown_card_rediscovers_once_alike():
    fake = FakeNvml(n=2)
    ref, port = servers(fake)
    fake.n, fake.minors = 3, [0, 1, 2]
    for attr in ("total", "used", "util", "pci", "uuids"):
        getattr(fake, attr).append(getattr(fake, attr)[-1])
    got = passes(ref, port, {CID: ["nvidia2"]})
    assert any(dict(lb).get("accelerator_id") == "nvidia2"
               for n, lb, _ in got if n == "duty_cycle")
    # A card that stays unknown is suppressed: no rediscovery next pass.
    passes(ref, port, {CID: ["nvidia9"]})
    until = dict(port._unresolvable)
    passes(ref, port, {CID: ["nvidia9"]})
    assert port._unresolvable == until and set(until) == {"nvidia9"}
    assert set(ref._unresolvable) == {"accel9"}


def test_label_reset_alike():
    fake = FakeNvml(n=2)
    ref, port = servers(fake)
    passes(ref, port, {CID: ["nvidia0"]})
    for s in (ref, port):
        s._last_reset -= ref_metrics.METRICS_RESET_INTERVAL_S + 1
    got = passes(ref, port, {})
    assert not any(n in ("duty_cycle", "request") for n, _, _ in got)


def test_external_seams_alike():
    fake = FakeNvml(n=2)
    ref, port = servers(fake)
    for s, mod in ((ref, ref_observe), (port, observe)):
        ext = mod.Registry()
        ext.counter("serve_req_total", "requests",
                    labelnames=("route",)).inc(4.0, "generate")
        ext.gauge("serve_depth", "queue depth").set(2.0)
        h = ext.histogram("serve_ttft_seconds", "ttft", buckets=(0.1, 1.0))
        h.observe(0.05)
        h.observe(0.5)
        s.attach_external_registry("engine0", ext)
        s.register_external_provider(
            "engine0", lambda: {"serve_engine_queue_depth": 3.0})
        s.register_external_provider("broken", lambda: 1 / 0)
    got = passes(ref, port, {})
    assert ("serve_ttft_seconds_bucket", (("le", "1.0"),), 2.0) in got
    assert ("serve_engine_queue_depth", (("provider", "engine0"),),
            3.0) in got
    for s, mod in ((ref, ref_observe), (port, observe)):
        new = mod.Registry()
        new.gauge("serve_depth", "queue depth").set(7.0)
        s.attach_external_registry("engine0", new)
    assert ("serve_depth", (), 7.0) in same(ref, port)
    for s in (ref, port):
        s.detach_external_registry("engine0")
        s.unregister_external_provider("engine0")
    assert not any(n.startswith("serve_depth") for n, _, _ in
                   same(ref, port))


def test_pod_resources_clients_match_on_a_socket():
    root = tempfile.mkdtemp(dir="/tmp")
    sock = os.path.join(root, "pr.sock")
    assert len(sock) < 108

    class Stub(grpc_api.PodResourcesListerServicer):
        def List(self, request, context):
            def devs(resource, ids):
                return pr_pb2.ContainerDevices(resource_name=resource,
                                               device_ids=ids)

            return pr_pb2.ListPodResourcesResponse(pod_resources=[
                pr_pb2.PodResources(name="p", namespace="ns", containers=[
                    pr_pb2.ContainerResources(name="a", devices=[
                        devs("google.com/tpu", ["accel0", "accel1/vtpu0"]),
                        devs("nvidia.com/gpu", ["nvidia0", "nvidia1/vgpu0"]),
                        devs("example.com/nic", ["nic0"])]),
                    pr_pb2.ContainerResources(name="b", devices=[
                        devs("google.com/tpu", ["slice1"]),
                        devs("nvidia.com/gpu", ["slice1"])]),
                    pr_pb2.ContainerResources(name="c", devices=[])])])

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    grpc_api.add_pod_resources_servicer(server, Stub())
    assert ref_grpc_api.POD_RESOURCES_SERVICE == grpc_api.POD_RESOURCES_SERVICE
    server.add_insecure_port(f"unix:{sock}")
    server.start()
    try:
        want = ref_podresources.get_devices_for_all_containers(sock)
        got = PR.get_devices_for_all_containers(sock)
    finally:
        server.stop(grace=0)
        shutil.rmtree(root, ignore_errors=True)
    assert {(c.namespace, c.pod, c.container): v for c, v in got.items()} == {
        (c.namespace, c.pod, c.container): [to_gpu(d) for d in v]
        for c, v in want.items()}
    assert got[PR.ContainerID("ns", "p", "a")] == ["nvidia0"]


# -- the port's own --------------------------------------------------------
class NvmlMemory(FakeNvml):
    """v1's used bytes count the driver's reservation in, as NVML's do."""

    def nvmlDeviceGetMemoryInfo(self, h, out):
        rc = FakeNvml.nvmlDeviceGetMemoryInfo(self, h, out)
        out._obj.used += self.reserved[self._card(h)]
        return rc


def test_nvml_fields_layer_reads_memory_v2_and_falls_back():
    fake = NvmlMemory(n=2)
    nv = N.Nvml(lib=fake)
    c = MT.make_collector(nv, PLATFORM, "auto")
    assert isinstance(c, MT.NvmlFieldsCollector)
    assert c.sdk_state() == "absent"  # nothing read yet
    s = MT.MetricServer(collector=c, registry=CollectorRegistry(),
                        pod_resources_fn=dict)
    s.update_metrics({})
    labels = {"make": "nvidia", "accelerator_id": "nvidia1",
              "model": "nvidia-h100-80gb-2"}
    get = s.registry.get_sample_value
    assert get("memory_used_node_gpu", labels) == fake.used[1]
    assert get("memory_total_node_gpu", labels) == fake.total[1]
    assert get("gpu_sdk_source_state",
               {"layer": "metrics", "state": "active"}) == 1.0
    for metric, (gauge, _) in MT.SDK_NODE_METRICS.items():
        assert gauge.endswith("_node_gpu")
        assert get(gauge, labels) is None  # absent: no NVML read serves it
        assert c._metric_state[metric] == "absent"
    fake.rc["nvmlDeviceGetMemoryInfo_v2"] = 999
    s.update_metrics({})
    assert get("memory_used_node_gpu", labels) == (
        fake.used[1] + fake.reserved[1])
    assert c.sdk_state() == "absent"
    assert get("gpu_sdk_source_state",
               {"layer": "metrics", "state": "absent"}) == 1.0
    native = MT.make_collector(nv, PLATFORM, "native")
    assert type(native) is MT.NvmlCollector
    assert native.memory_used_bytes("nvidia1") == (
        fake.used[1] + fake.reserved[1])


def test_make_collector_sources():
    fake = FakeNvml(n=1)
    fake.missing.add("nvmlDeviceGetMemoryInfo_v2")
    nv = N.Nvml(lib=fake)
    assert type(MT.make_collector(nv, source="auto")) is MT.NvmlCollector
    with pytest.raises(RuntimeError, match="nvml-fields"):
        MT.make_collector(nv, source="nvml-fields")
    with pytest.raises(ValueError, match="unknown metrics source"):
        MT.make_collector(nv, source="libtpu-sdk")
    assert MT.make_collector(nv).platform.accelerator_type == \
        "nvidia-h100-80gb-1"
    with pytest.raises(RuntimeError, match="lists no GPU"):
        MT.make_collector(N.Nvml(lib=FakeNvml(n=0)))
    with pytest.raises(N.NvmlUnavailable):
        MT.make_collector()
    with pytest.raises(N.NvmlUnavailable):
        MT.MetricServer(port=0, registry=CollectorRegistry()).start()


def test_metric_server_serves_http_on_a_free_port():
    fake = FakeNvml(n=2)
    s = MT.MetricServer(collection_interval_ms=50, port=0,
                        collector=MT.make_collector(N.Nvml(lib=fake)),
                        registry=CollectorRegistry(), pod_resources_fn=dict)
    s.start()
    try:
        assert s.port > 0
        url = f"http://127.0.0.1:{s.port}/metrics"
        deadline = time.monotonic() + 10
        text = ""
        while "duty_cycle_node_gpu{" not in text:
            assert time.monotonic() < deadline, text
            time.sleep(0.05)
            text = urllib.request.urlopen(url, timeout=5).read().decode()
        assert 'accelerator_id="nvidia1"' in text
    finally:
        s.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(url, timeout=2)
