"""The port's device-plugin daemon end to end over real unix-socket gRPC,
mirroring the reference's nine (tests/test_beta_plugin_e2e.py): a fake
kubelet records the registration, and a DevicePlugin client drives
ListAndWatch, Allocate (valid, virtual, invalid), GetPreferredAllocation,
the hotplug watchdog, socket deletion, a refused registration and a late
kubelet, over a fake node (utils/fake_node.py) and the fake NVML
(tests/torch_fake_nvml.py).  Then the daemon as its entry point builds
it (device_plugin.start): an Xid from NVML reaches ListAndWatch through
GPUHealthChecker and the manager's queue, and /metrics serves the cards.

Every socket lives under a short tempfile.mkdtemp(dir="/tmp"), each path
under the 108 bytes a unix socket path may hold: pytest's tmp_path under
xdist workers runs past that, which is why the reference's e2e tests
fail there."""

import os
import queue
import shutil
import tempfile
import threading
import time
import urllib.request
from concurrent import futures

import grpc
import pytest

from torch_fake_nvml import FakeNvml
from container_engine_accelerators_tpu_torch import device_plugin
from container_engine_accelerators_tpu_torch.native import nvml as N
from container_engine_accelerators_tpu_torch.plugin import health as H
from container_engine_accelerators_tpu_torch.plugin import manager as M
from container_engine_accelerators_tpu_torch.plugin import sharing
from container_engine_accelerators_tpu_torch.plugin.api import (
    HEALTHY, UNHEALTHY, grpc_api,
)
from container_engine_accelerators_tpu_torch.plugin.api import (
    deviceplugin_pb2 as dp_pb2,
    podresources_pb2 as pr_pb2,
)
from container_engine_accelerators_tpu_torch.plugin.config import (
    GPUConfig, GPUSharingConfig,
)
from container_engine_accelerators_tpu_torch.utils.fake_node import (
    make_fake_node,
)

ENDPOINT = "gpuDevicePlugin-test.sock"
SOCKET_PATH_MAX = 108


def short(path):
    assert len(path) < SOCKET_PATH_MAX, path
    return path


class KubeletStub(grpc_api.RegistrationServicer):
    """A fake kubelet: Register only, on a unix socket."""

    def __init__(self, socket_path):
        self.requests = queue.Queue()
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        grpc_api.add_registration_servicer(self.server, self)
        self.server.add_insecure_port(f"unix:{short(socket_path)}")

    def Register(self, request, context):
        self.requests.put(request)
        return dp_pb2.Empty()

    def start(self):
        self.server.start()

    def stop(self):
        self.server.stop(grace=0)


@pytest.fixture
def node(monkeypatch):
    """A short root under /tmp: a fake node of 8 cards and a plugin
    directory, with fast watchdog intervals."""
    monkeypatch.setattr(M, "GPU_CHECK_INTERVAL_S", 0.4)
    monkeypatch.setattr(M, "PLUGIN_SOCKET_CHECK_INTERVAL_S", 0.05)
    root = tempfile.mkdtemp(dir="/tmp")
    dev = make_fake_node(root, 8)
    plugin_dir = os.path.join(root, "dp")
    os.mkdir(plugin_dir)
    short(os.path.join(plugin_dir, ENDPOINT))
    yield dev, plugin_dir, FakeNvml(n=8)
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture
def kubelet(node):
    k = KubeletStub(os.path.join(node[1], "kubelet.sock"))
    k.start()
    yield k
    k.stop()


class PodResourcesStub(grpc_api.PodResourcesListerServicer):
    """The kubelet's pod-resources service: one pod holding `ids`."""

    def __init__(self, socket_path, ids):
        self.ids = ids
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        grpc_api.add_pod_resources_servicer(self.server, self)
        self.server.add_insecure_port(f"unix:{short(socket_path)}")
        self.server.start()

    def List(self, request, context):
        return pr_pb2.ListPodResourcesResponse(pod_resources=[
            pr_pb2.PodResources(name="trainer-0", namespace="default",
                                containers=[pr_pb2.ContainerResources(
                                    name="main", devices=[
                                        pr_pb2.ContainerDevices(
                                            resource_name=M.RESOURCE_NAME,
                                            device_ids=self.ids)])])])


def started_manager(node, config=None):
    dev, _, fake = node
    m = M.GPUManager(
        dev_directory=dev,
        mount_paths=[dp_pb2.Mount(host_path="/home/kubernetes/bin/nvidia",
                                  container_path="/usr/local/nvidia",
                                  read_only=True)],
        gpu_config=config or GPUConfig(),
        nvml=N.Nvml(lib=fake),
    )
    m.start()
    return m


def wait_ready(socket_path, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(socket_path):
            try:
                with grpc.insecure_channel(f"unix:{socket_path}") as ch:
                    grpc.channel_ready_future(ch).result(timeout=1)
                return socket_path
            except grpc.FutureTimeoutError:
                pass
        time.sleep(0.02)
    raise TimeoutError("plugin socket never became ready")


def serving(m, plugin_dir):
    t = threading.Thread(target=m.serve, args=(plugin_dir, "kubelet.sock",
                                               ENDPOINT), daemon=True)
    t.start()
    return t, wait_ready(os.path.join(plugin_dir, ENDPOINT))


def stopped(m, t):
    m.stop()
    t.join(timeout=5)
    assert not t.is_alive()


def allocate(stub, ids):
    return stub.Allocate(dp_pb2.AllocateRequest(container_requests=[
        dp_pb2.ContainerAllocateRequest(devicesIDs=ids)]))


def test_registration_and_allocate(node, kubelet):
    dev, plugin_dir, _ = node
    m = started_manager(node)
    t, sock = serving(m, plugin_dir)
    try:
        req = kubelet.requests.get(timeout=5)
        assert req.resource_name == "nvidia.com/gpu" == M.RESOURCE_NAME
        assert req.version == grpc_api.DEVICE_PLUGIN_VERSION
        assert req.endpoint == ENDPOINT
        assert req.options.get_preferred_allocation_available
        with grpc.insecure_channel(f"unix:{sock}") as ch:
            stub = grpc_api.DevicePluginStub(ch)
            stream = stub.ListAndWatch(dp_pb2.Empty())
            got = {d.ID: d.health for d in next(stream).devices}
            assert got == {f"nvidia{i}": HEALTHY for i in range(8)}
            cresp = allocate(stub, ["nvidia0", "nvidia1"]).container_responses
            assert len(cresp) == 1
            assert [d.host_path for d in cresp[0].devices] == [
                f"{dev}/nvidia0", f"{dev}/nvidia1", f"{dev}/nvidiactl",
                f"{dev}/nvidia-uvm"]
            assert all(d.permissions == "mrw" for d in cresp[0].devices)
            assert [x.container_path for x in cresp[0].mounts] == [
                "/usr/local/nvidia"]
            envs = dict(cresp[0].envs)
            assert envs["TPU_VISIBLE_DEVICES"] == "0,1"
            assert envs["TPU_WORKER_ID"] == "0"
            assert envs["TPU_CHIPS_PER_PROCESS_BOUNDS"] == "2,1,1"
            assert envs["TPU_ACCELERATOR_TYPE"] == "nvidia-h100-80gb-2"
            stream.cancel()
    finally:
        stopped(m, t)


def test_allocate_invalid_device_rejected(node, kubelet):
    m = started_manager(node)
    t, sock = serving(m, node[1])
    try:
        with grpc.insecure_channel(f"unix:{sock}") as ch:
            stub = grpc_api.DevicePluginStub(ch)
            for ids in (["nvidia99"], ["accel0"]):
                with pytest.raises(grpc.RpcError) as exc:
                    allocate(stub, ids)
                assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        stopped(m, t)


def test_time_sharing_allocate(node, kubelet):
    dev, plugin_dir, fake = node
    cfg = GPUConfig(gpu_sharing_config=GPUSharingConfig(
        gpu_sharing_strategy=sharing.TIME_SHARING,
        max_shared_clients_per_gpu=2))
    m = started_manager(node, cfg)
    t, sock = serving(m, plugin_dir)
    try:
        with grpc.insecure_channel(f"unix:{sock}") as ch:
            stub = grpc_api.DevicePluginStub(ch)
            stream = stub.ListAndWatch(dp_pb2.Empty())
            assert len(next(stream).devices) == 16  # 8 cards x 2 clients
            cresp = allocate(stub, ["nvidia3/vgpu1"]).container_responses[0]
            assert [d.host_path for d in cresp.devices] == [
                f"{dev}/nvidia3", f"{dev}/nvidiactl", f"{dev}/nvidia-uvm"]
            assert cresp.envs["TPU_VISIBLE_DEVICES"] == "3"
            assert cresp.envs["GPU_HBM_TOTAL_BYTES"] == str(fake.total[3])
            assert cresp.envs["GPU_HBM_LIMIT_BYTES"] == str(fake.total[3] // 2)
            assert cresp.envs["GPU_DUTY_CYCLE_LIMIT_PCT"] == "50"
            with pytest.raises(grpc.RpcError) as exc:
                allocate(stub, ["nvidia0/vgpu0", "nvidia1/vgpu0"])
            assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            stream.cancel()
    finally:
        stopped(m, t)


def test_health_event_flows_to_stream(node, kubelet):
    m = started_manager(node)
    t, sock = serving(m, node[1])
    try:
        with grpc.insecure_channel(f"unix:{sock}") as ch:
            stream = grpc_api.DevicePluginStub(ch).ListAndWatch(dp_pb2.Empty())
            next(stream)
            m.health.put(dp_pb2.Device(ID="nvidia2", health=UNHEALTHY))
            got = {d.ID: d.health for d in next(stream).devices}
            assert got["nvidia2"] == UNHEALTHY
            assert got["nvidia0"] == HEALTHY
            assert m.devices["nvidia2"].health == UNHEALTHY
            stream.cancel()
    finally:
        stopped(m, t)


def test_get_preferred_allocation_contiguous(node, kubelet):
    m = started_manager(node)
    t, sock = serving(m, node[1])
    try:
        with grpc.insecure_channel(f"unix:{sock}") as ch:
            stub = grpc_api.DevicePluginStub(ch)

            def preferred(avail, size, must=()):
                resp = stub.GetPreferredAllocation(
                    dp_pb2.PreferredAllocationRequest(container_requests=[
                        dp_pb2.ContainerPreferredAllocationRequest(
                            available_deviceIDs=avail,
                            must_include_deviceIDs=list(must),
                            allocation_size=size)]))
                return list(resp.container_responses[0].deviceIDs)

            cards = [f"nvidia{i}" for i in range(8)]
            assert preferred(cards, 4) == cards[:4]
            assert preferred(cards, 2, ["nvidia5"]) == ["nvidia4", "nvidia5"]
            with pytest.raises(grpc.RpcError) as exc:
                preferred(cards[:2], 4)
            assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        stopped(m, t)


def test_hotplug_restarts_server_with_new_device(node, kubelet):
    dev, plugin_dir, fake = node
    m = started_manager(node)
    t, _ = serving(m, plugin_dir)
    try:
        kubelet.requests.get(timeout=5)
        open(os.path.join(dev, "nvidia8"), "w").close()
        assert kubelet.requests.empty()  # a node NVML does not list
        fake.minors.append(8)
        for attr in ("total", "used", "util", "pci", "uuids"):
            getattr(fake, attr).append(getattr(fake, attr)[-1])
        fake.n = 9
        req = kubelet.requests.get(timeout=5)
        assert req.resource_name == M.RESOURCE_NAME
        deadline = time.monotonic() + 5
        while "nvidia8" not in m.list_devices() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert "nvidia8" in m.list_devices()
    finally:
        stopped(m, t)


def test_registration_failure_raises(node):
    class RejectingKubelet(KubeletStub):
        def Register(self, request, context):
            self.requests.put(request)
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "unsupported plugin version")

    plugin_dir = node[1]
    kubelet = RejectingKubelet(os.path.join(plugin_dir, "kubelet.sock"))
    kubelet.start()
    m = started_manager(node)
    try:
        with pytest.raises(RuntimeError, match="cannot register"):
            m.serve(plugin_dir, "kubelet.sock", ENDPOINT)
        assert kubelet.requests.get(timeout=1) is not None
        # The plugin's server was torn down, not left serving.
        with grpc.insecure_channel(f"unix:{plugin_dir}/{ENDPOINT}") as ch:
            with pytest.raises(grpc.FutureTimeoutError):
                grpc.channel_ready_future(ch).result(timeout=0.5)
    finally:
        m.stop()
        kubelet.stop()


def test_socket_deletion_restarts_server(node, kubelet):
    m = started_manager(node)
    t, sock = serving(m, node[1])
    try:
        kubelet.requests.get(timeout=5)
        os.unlink(sock)  # a kubelet restart wipes the plugin directory
        req = kubelet.requests.get(timeout=5)
        assert req.resource_name == M.RESOURCE_NAME
        wait_ready(sock)
    finally:
        stopped(m, t)
    m.stop()  # idempotent


def test_kubelet_appearing_late_gets_registration(node, monkeypatch):
    monkeypatch.setattr(M, "GPU_CHECK_INTERVAL_S", 10)
    m = started_manager(node)
    t, _ = serving(m, node[1])  # no kubelet yet: serving unregistered
    try:
        kubelet = KubeletStub(os.path.join(node[1], "kubelet.sock"))
        kubelet.start()
        try:
            req = kubelet.requests.get(timeout=5)
            assert req.resource_name == M.RESOURCE_NAME
        finally:
            kubelet.stop()
    finally:
        stopped(m, t)


def test_daemon_health_and_metrics_end_to_end(node, kubelet, monkeypatch):
    # The daemon as device_plugin.main builds it, over the fake NVML: an
    # Xid 48 on card 5 reaches ListAndWatch through GPUHealthChecker and
    # the manager's queue, and /metrics serves every card.
    monkeypatch.setattr(H, "WAIT_TIMEOUT_MS", 100)
    dev, plugin_dir, fake = node
    args = device_plugin.parse_args([
        "--dev-directory", dev, "--plugin-directory", plugin_dir,
        "--gpu-config", os.path.join(plugin_dir, "absent.json"),
        "--enable-container-gpu-metrics", "--enable-health-monitoring",
        "--gpu-metrics-port", "0", "--gpu-metrics-collection-interval", "100",
        "--pod-resources-socket", os.path.join(plugin_dir, "pr.sock"),
    ])
    pods = PodResourcesStub(os.path.join(plugin_dir, "pr.sock"), ["nvidia3"])
    daemon = device_plugin.start(args, N.Nvml(lib=fake))
    t = threading.Thread(target=daemon.serve, daemon=True)
    t.start()
    try:
        assert kubelet.requests.get(timeout=5).resource_name == M.RESOURCE_NAME
        sock = wait_ready(daemon.manager.socket)
        with grpc.insecure_channel(f"unix:{sock}") as ch:
            stream = grpc_api.DevicePluginStub(ch).ListAndWatch(dp_pb2.Empty())
            assert {d.health for d in next(stream).devices} == {HEALTHY}
            fake.events.put((5, 48))
            got = {d.ID: d.health for d in next(stream).devices}
            assert got["nvidia5"] == UNHEALTHY
            assert sum(h == UNHEALTHY for h in got.values()) == 1
            stream.cancel()
        url = f"http://127.0.0.1:{daemon.metrics.port}/metrics"
        deadline = time.monotonic() + 10
        while True:
            text = urllib.request.urlopen(url, timeout=5).read().decode()
            if "duty_cycle{" in text or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        for i in range(8):
            assert (f'duty_cycle_node_gpu{{accelerator_id="nvidia{i}",'
                    f'make="nvidia",model="nvidia-h100-80gb-8"}} 37.0') in text
        assert ('gpu_sdk_source_state{layer="health",state="active"} 1.0'
                in text)
        assert 'gpu_sdk_source_state{layer="metrics",state="active"}' in text
        assert ('duty_cycle{accelerator_id="nvidia3",container="main",'
                'make="nvidia",model="nvidia-h100-80gb-8",namespace="default"'
                ',pod="trainer-0"} 37.0') in text
        assert ('request{container="main",namespace="default",pod="trainer-0"'
                ',resource_name="nvidia.com/gpu"} 1.0') in text
    finally:
        pods.server.stop(grace=0)
        daemon.stop()
        t.join(timeout=5)
        assert not t.is_alive()
