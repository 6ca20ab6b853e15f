"""The port's NVML seam (native/nvml.py) over a fake NVML function table
(tests/torch_fake_nvml.py): the device reads, the event wait's codes
(NVML_ERROR_TIMEOUT is no event, NVML_ERROR_GPU_IS_LOST the host-wide
EVENT_DEVICE_REMOVED 1000, any other failure raises), a refused event
registration raises naming the refusal, a missing library raises
NvmlUnavailable, and the Xid table row by row against the reference's
error-code taxonomy."""

import pytest

from torch_fake_nvml import (
    GPU_IS_LOST, INVALID_ARGUMENT, NOT_SUPPORTED, TIMEOUT, FakeNvml,
)
from container_engine_accelerators_tpu.native import tpuinfo as ref_tpuinfo
from container_engine_accelerators_tpu.plugin import health as ref_health
from container_engine_accelerators_tpu_torch import server as S
from container_engine_accelerators_tpu_torch.native import nvml as N
from container_engine_accelerators_tpu_torch.plugin import health as H


def _nvml(**kw):
    fake = FakeNvml(**kw)
    return N.Nvml(lib=fake), fake


def test_device_reads():
    nv, fake = _nvml(n=2, minors=[3, 7])
    fake.used[1] = 5 << 30
    assert nv.device_count == 2
    assert nv.device_names() == ["nvidia3", "nvidia7"]
    assert nv.uuid(1) == fake.uuids[1]
    assert nv.memory_total_bytes(0) == 80 << 30
    assert nv.memory_used_bytes(1) == 5 << 30
    assert nv.memory_reserved_bytes(0) == 480 << 20
    fake.missing.add("nvmlDeviceGetMemoryInfo_v2")
    with pytest.raises(N.NvmlError, match="no memory reservation"):
        nv.memory_reserved_bytes(0)
    assert nv.average_duty_cycle(0) == 37.0
    with pytest.raises(N.NvmlError, match="no NVML device 2"):
        nv.uuid(2)
    nv.shutdown()


def test_library_absent_raises_unavailable(monkeypatch):
    monkeypatch.setattr(N, "LIBRARY", "libnvidia-ml-absent.so.1")
    with pytest.raises(N.NvmlUnavailable, match="libnvidia-ml-absent"):
        N.Nvml()
    with pytest.raises(N.NvmlUnavailable):
        H.make_event_source(source="auto")
    # The reference's counterpart is the same kind of error.
    assert issubclass(N.NvmlUnavailable, RuntimeError)
    assert issubclass(ref_tpuinfo.TpuInfoUnavailable, RuntimeError)


def test_init_failure_raises_with_the_code_name():
    fake = FakeNvml()
    fake.rc["nvmlInit_v2"] = 9
    with pytest.raises(N.NvmlError, match="NVML_ERROR_DRIVER_NOT_LOADED"):
        N.Nvml(lib=fake)


@pytest.mark.parametrize("item,want", [
    (TIMEOUT, None),
    (GPU_IS_LOST, (-1, N.EVENT_DEVICE_REMOVED, 0)),
    ((1, 48), (1, 1, 48)),
    ((None, 48), (-1, 1, 48)),
    ((0, 31), (0, N.XID_CODE_BASE + 31, 31)),
])
def test_event_wait_codes(item, want):
    nv, fake = _nvml()
    es = nv.event_set_create()
    nv.register_event(es, 0)
    if item != TIMEOUT:
        fake.events.put(item)
    ev = nv.wait_for_event(es, 10)
    if want is None:
        assert ev is None
        return
    assert (ev.device_index, ev.error_code, ev.xid) == want
    assert ev.is_host_event == (want[0] < 0)
    assert ev.timestamp_us > 0


def test_event_wait_failure_raises():
    nv, fake = _nvml()
    es = nv.event_set_create()
    fake.events.put(999)
    with pytest.raises(N.NvmlError, match="NVML_ERROR_UNKNOWN") as e:
        nv.wait_for_event(es, 10)
    assert e.value.code == 999


def test_refused_registration_names_the_refusal():
    nv, fake = _nvml()
    fake.rc["nvmlDeviceRegisterEvents"] = NOT_SUPPORTED
    es = nv.event_set_create()
    with pytest.raises(N.NvmlError, match="refused: NVML_ERROR_NOT_SUPPORTED"):
        nv.register_event(es, 0)
    # The health source built over it raises too, and frees its set.
    with pytest.raises(N.NvmlError, match="XidCriticalError"):
        H.NvmlEventSource(nv)
    assert fake.sets_freed


def test_registration_watches_xid_critical_errors_on_every_card():
    nv, fake = _nvml(n=3)
    src = H.NvmlEventSource(nv)
    assert [(c, t) for c, t, _ in fake.registered] == [
        (i, N.EVENT_TYPE_XID_CRITICAL) for i in range(3)]
    src.close()
    assert len(fake.sets_freed) == 1


# NVIDIA's Xid catalog rows the table maps, and the reference code each
# must carry (plugin/health.py's names in both packages).
XID_ROWS = [
    (48, "HBM_UNCORRECTABLE_ECC"), (95, "HBM_UNCORRECTABLE_ECC"),
    (64, "HBM_UNCORRECTABLE_ECC"), (74, "ICI_LINK_FATAL"),
    (8, "TENSORCORE_HANG"), (119, "TENSORCORE_HANG"),
    (79, "FIRMWARE_PANIC"), (62, "FIRMWARE_PANIC"), (120, "FIRMWARE_PANIC"),
]


@pytest.mark.parametrize("xid,ref_name", XID_ROWS)
def test_xid_table_row(xid, ref_name):
    code = N.code_for_xid(xid)
    assert code == getattr(ref_health, ref_name)
    assert code in S.HEALTH_CRITICAL
    nv, fake = _nvml()
    es = nv.event_set_create()
    fake.events.put((1, xid))
    ev = nv.wait_for_event(es, 10)
    assert (ev.device_index, ev.error_code, ev.xid) == (1, code, xid)


@pytest.mark.parametrize("xid", [13, 31, 43, 45, 68, 109, 94, 1, 4, 1000])
def test_other_xids_are_never_critical_by_default(xid):
    code = N.code_for_xid(xid)
    assert code == N.XID_CODE_BASE + xid
    assert code not in S.HEALTH_CRITICAL
    assert code not in H.ALWAYS_CRITICAL_ERRORS
    assert code not in range(0, 7) and code != N.EVENT_DEVICE_REMOVED


def test_table_is_the_only_map_and_never_gives_overtemp():
    assert dict(N.XID_CODES) == {x: N.code_for_xid(x) for x, _ in XID_ROWS}
    assert H.OVERTEMP_SHUTDOWN not in N.XID_CODES.values()
    assert H.OVERTEMP_SHUTDOWN == ref_health.OVERTEMP_SHUTDOWN
    assert H.LINK_FATAL == ref_health.ICI_LINK_FATAL
    assert H.ENGINE_HANG == ref_health.TENSORCORE_HANG
    assert H.THROTTLE_SEVERE == ref_health.THROTTLE_SEVERE
    assert H.EVENT_DEVICE_REMOVED == ref_health.EVENT_DEVICE_REMOVED


def test_vendor_reads():
    nv, fake = _nvml(links=[{0: 1, 1: 0, 5: 1}, {}], clocks=[0x48, 0x1])
    assert nv.serves_vendor_reads
    assert nv.nvlink_states(0) == {0: 1, 1: 0, 5: 1}
    assert nv.nvlink_states(1) == {}
    assert nv.clocks_event_reasons(0) == 0x48
    assert nv.clocks_event_reasons(0) & N.SEVERE_CLOCKS_EVENTS
    assert not nv.clocks_event_reasons(1) & N.SEVERE_CLOCKS_EVENTS
    fake.rc["nvmlDeviceGetNvLinkState"] = 999
    with pytest.raises(N.NvmlError, match="link 0"):
        nv.nvlink_states(0)
    fake.rc["nvmlDeviceGetNvLinkState"] = INVALID_ARGUMENT
    assert nv.nvlink_states(0) == {}


def test_older_driver_clocks_name_and_a_library_without_vendor_reads():
    fake = FakeNvml(clocks=[0x40, 0])
    fake.missing.add("nvmlDeviceGetCurrentClocksEventReasons")

    def throttle(h, out):
        out._obj.value = fake.clocks[fake._card(h)]
        return 0

    fake.nvmlDeviceGetCurrentClocksThrottleReasons = throttle
    assert N.Nvml(lib=fake).clocks_event_reasons(0) == 0x40
    nv = N.Nvml(lib=FakeNvml(vendor=False))
    assert not nv.serves_vendor_reads
    with pytest.raises(N.NvmlError, match="no clocks-event reasons"):
        nv.clocks_event_reasons(0)


def test_duty_cycle_not_supported_is_none():
    nv, fake = _nvml()
    fake.rc["nvmlDeviceGetUtilizationRates"] = NOT_SUPPORTED
    assert nv.average_duty_cycle(0) is None
    fake.rc["nvmlDeviceGetUtilizationRates"] = 999
    with pytest.raises(N.NvmlError):
        nv.average_duty_cycle(0)
