"""ctypes binding to the NVIDIA driver's NVML library (libnvidia-ml.so.1): the
port of container_engine_accelerators_tpu/native/tpuinfo.py (`Event`
:53, `TpuInfoUnavailable` :36, `TpuInfo` :127-262).

The reference's native core is a mirror of NVML: event sets, per-device
registration for critical errors and a blocking wait.  On the card the
core is NVML itself, so nothing is built: `Nvml` binds
  - nvmlInit_v2 / nvmlShutdown;
  - nvmlDeviceGetCount_v2, nvmlDeviceGetHandleByIndex_v2,
    nvmlDeviceGetUUID, nvmlDeviceGetMinorNumber (devices are named
    `nvidia<minor>`, their /dev node), nvmlDeviceGetMemoryInfo and
    nvmlDeviceGetMemoryInfo_v2 (the NVIDIA driver's reservation: CUDA's total
    is NVML's total less it);
  - nvmlEventSetCreate / nvmlEventSetFree, nvmlDeviceRegisterEvents for
    nvmlEventTypeXidCriticalError, nvmlEventSetWait_v2 (NVML_ERROR_TIMEOUT
    is no event; NVML_ERROR_GPU_IS_LOST becomes the host-wide
    EVENT_DEVICE_REMOVED, as tpuinfo.py :30-33 defines it);
  - nvmlDeviceGetUtilizationRates (the duty cycle, averaged by NVML
    over its own sample period);
  - nvmlDeviceGetPciInfo_v3 (the card's PCI address: the device
    plugin's slices order the cards by it);
  - for the health layer's vendor reads (plugin/health.py
    `NvmlFieldsEventSource`): nvmlDeviceGetCurrentClocksEventReasons
    (nvmlDeviceGetCurrentClocksThrottleReasons on older NVIDIA drivers) and
    nvmlDeviceGetNvLinkState.

An Xid arrives as the event's data and maps onto the reference's
error-code taxonomy through XID_CODES, the one table of it (plugin/
health.py names the codes).  Every other Xid travels as XID_CODE_BASE +
xid: outside 0-6 and 1000, so it is critical only where a caller lists
that code.

`Nvml(lib=...)` takes any object with the NVML functions as attributes
(tests pass a table of Python functions that return NVML's codes and
fill the by-reference outputs); by default the system loader finds the
library, and NvmlUnavailable raises without it.  Nothing here carries on
without the library.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import List, Optional

LIBRARY = "libnvidia-ml.so.1"

# nvmlReturn_t values this module acts on, and names for the rest.
NVML_SUCCESS = 0
NVML_ERROR_INVALID_ARGUMENT = 2
NVML_ERROR_NOT_SUPPORTED = 3
NVML_ERROR_TIMEOUT = 10
NVML_ERROR_GPU_IS_LOST = 15
_ERROR_NAMES = {
    0: "NVML_SUCCESS", 1: "NVML_ERROR_UNINITIALIZED",
    2: "NVML_ERROR_INVALID_ARGUMENT", 3: "NVML_ERROR_NOT_SUPPORTED",
    4: "NVML_ERROR_NO_PERMISSION", 5: "NVML_ERROR_ALREADY_INITIALIZED",
    6: "NVML_ERROR_NOT_FOUND", 7: "NVML_ERROR_INSUFFICIENT_SIZE",
    9: "NVML_ERROR_DRIVER_NOT_LOADED", 10: "NVML_ERROR_TIMEOUT",
    12: "NVML_ERROR_LIBRARY_NOT_FOUND", 13: "NVML_ERROR_FUNCTION_NOT_FOUND",
    15: "NVML_ERROR_GPU_IS_LOST", 16: "NVML_ERROR_RESET_REQUIRED",
    18: "NVML_ERROR_LIB_RM_VERSION_MISMATCH", 999: "NVML_ERROR_UNKNOWN",
}

EVENT_TYPE_XID_CRITICAL = 0x8  # nvmlEventTypeXidCriticalError
NVLINK_MAX_LINKS = 18  # NVML_NVLINK_MAX_LINKS
# nvmlClocksEventReason* bits that slow the card for a hardware cause:
# HW slowdown, HW thermal slowdown, HW power brake.
CLOCKS_EVENT_HW_SLOWDOWN = 0x8
CLOCKS_EVENT_HW_THERMAL = 0x40
CLOCKS_EVENT_HW_POWER_BRAKE = 0x80
SEVERE_CLOCKS_EVENTS = (CLOCKS_EVENT_HW_SLOWDOWN | CLOCKS_EVENT_HW_THERMAL
                        | CLOCKS_EVENT_HW_POWER_BRAKE)

# tpuinfo.h TPUINFO_EVENT_DEVICE_REMOVED: delivered host-wide when NVML
# reports the card lost.
EVENT_DEVICE_REMOVED = 1000
# An Xid outside XID_CODES travels as this base plus the Xid.
XID_CODE_BASE = 100000
# Xid -> the reference's error code (plugin/health.py names them), from
# NVIDIA's "Xid Errors" catalog: 1 HBM uncorrectable ECC (48 double-bit
# ECC, 95 uncontained ECC, 64 ECC page retirement / row remap failure);
# 2 link fatal (74 NVLink error); 3 engine hang (8 GPU stopped
# processing, 119 GSP RPC timeout); 5 firmware panic (79 fallen off the
# bus, 62 internal micro-controller halt, 120 GSP error).  Application
# faults (13, 31, 43, 45, 68 and 109, whose catalogued causes include
# the user's program) stay outside: they must never drain a card.
XID_CODES = {48: 1, 95: 1, 64: 1, 74: 2, 8: 3, 119: 3, 79: 5, 62: 5,
             120: 5}


def code_for_xid(xid: int) -> int:
    """The error code an Xid event carries."""
    return XID_CODES.get(int(xid), XID_CODE_BASE + int(xid))


class NvmlUnavailable(RuntimeError):
    """libnvidia-ml.so.1 could not be loaded."""


class NvmlError(RuntimeError):
    """An NVML call failed; `.code` is its nvmlReturn_t."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


def error_name(code: int) -> str:
    return _ERROR_NAMES.get(int(code), f"nvmlReturn_t {int(code)}")


class _Memory(ctypes.Structure):  # nvmlMemory_t
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _MemoryV2(ctypes.Structure):  # nvmlMemory_v2_t
    _fields_ = [("version", ctypes.c_uint), ("total", ctypes.c_ulonglong),
                ("reserved", ctypes.c_ulonglong),
                ("free", ctypes.c_ulonglong), ("used", ctypes.c_ulonglong)]


# NVML_STRUCT_VERSION(Memory, 2): the struct's size, version 2 on top.
_MEMORY_V2 = ctypes.sizeof(_MemoryV2) | (2 << 24)


class _Utilization(ctypes.Structure):  # nvmlUtilization_t
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class _PciInfo(ctypes.Structure):  # nvmlPciInfo_t
    _fields_ = [("busIdLegacy", ctypes.c_char * 16),
                ("domain", ctypes.c_uint), ("bus", ctypes.c_uint),
                ("device", ctypes.c_uint), ("pciDeviceId", ctypes.c_uint),
                ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * 32)]


class _EventData(ctypes.Structure):  # nvmlEventData_t
    _fields_ = [("device", ctypes.c_void_p),
                ("eventType", ctypes.c_ulonglong),
                ("eventData", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


@dataclasses.dataclass(frozen=True)
class Event:
    device_index: int  # -1 => host-wide (all devices)
    error_code: int
    timestamp_us: int
    xid: int = 0  # the raw Xid; 0 for a synthetic event

    @property
    def is_host_event(self) -> bool:
        return self.device_index < 0


_P = ctypes.POINTER
_H = ctypes.c_void_p  # nvmlDevice_t, nvmlEventSet_t
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [_P(ctypes.c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint, _P(_H)],
    "nvmlDeviceGetUUID": [_H, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetMinorNumber": [_H, _P(ctypes.c_uint)],
    "nvmlDeviceGetMemoryInfo": [_H, _P(_Memory)],
    "nvmlDeviceGetMemoryInfo_v2": [_H, _P(_MemoryV2)],
    "nvmlEventSetCreate": [_P(_H)],
    "nvmlEventSetFree": [_H],
    "nvmlDeviceRegisterEvents": [_H, ctypes.c_ulonglong, _H],
    "nvmlEventSetWait_v2": [_H, _P(_EventData), ctypes.c_uint],
    "nvmlDeviceGetUtilizationRates": [_H, _P(_Utilization)],
    "nvmlDeviceGetPciInfo_v3": [_H, _P(_PciInfo)],
    "nvmlDeviceGetCurrentClocksEventReasons": [_H, _P(ctypes.c_ulonglong)],
    "nvmlDeviceGetCurrentClocksThrottleReasons": [
        _H, _P(ctypes.c_ulonglong)],
    "nvmlDeviceGetNvLinkState": [_H, ctypes.c_uint, _P(ctypes.c_int)],
}


def load_library():
    """The NVIDIA driver's NVML, through the system loader, with the bound
    functions' signatures declared."""
    try:
        lib = ctypes.CDLL(LIBRARY)
    except OSError as e:
        raise NvmlUnavailable(f"cannot load {LIBRARY}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


class Nvml:
    """An initialized NVML session over `lib` (default: the NVIDIA driver's
    library).  Device indices are NVML's."""

    def __init__(self, lib=None):
        self._lib = load_library() if lib is None else lib
        self._call("nvmlInit_v2")
        self._clocks_fn = next(
            (n for n in ("nvmlDeviceGetCurrentClocksEventReasons",
                         "nvmlDeviceGetCurrentClocksThrottleReasons")
             if hasattr(self._lib, n)), None)
        self._handles: List[_H] = []
        self.device_count = 0
        self.sync_device_count()

    def _call(self, name, *args) -> int:
        rc = int(getattr(self._lib, name)(*args))
        if rc != NVML_SUCCESS:
            raise NvmlError(f"{name} failed: {error_name(rc)}", rc)
        return rc

    def shutdown(self) -> None:
        self._call("nvmlShutdown")

    def sync_device_count(self) -> int:
        """Re-read the device count and the device handles."""
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        handles = []
        for i in range(n.value):
            h = _H()
            self._call("nvmlDeviceGetHandleByIndex_v2", i, ctypes.byref(h))
            handles.append(h)
        self._handles = handles
        self.device_count = n.value
        return self.device_count

    def _handle(self, index: int) -> _H:
        if not 0 <= index < self.device_count:
            raise NvmlError(f"no NVML device {index}",
                            NVML_ERROR_INVALID_ARGUMENT)
        return self._handles[index]

    def _index_of(self, handle_value) -> int:
        for i, h in enumerate(self._handles):
            if h.value == handle_value:
                return i
        return -1

    def device_name(self, index: int) -> str:
        """`nvidia<minor>`: the card's /dev node."""
        minor = ctypes.c_uint()
        self._call("nvmlDeviceGetMinorNumber", self._handle(index),
                   ctypes.byref(minor))
        return f"nvidia{minor.value}"

    def device_names(self) -> List[str]:
        return [self.device_name(i) for i in range(self.device_count)]

    def uuid(self, index: int) -> str:
        buf = ctypes.create_string_buffer(96)
        self._call("nvmlDeviceGetUUID", self._handle(index), buf, 96)
        return buf.value.decode()

    def _memory(self, index: int) -> _Memory:
        mem = _Memory()
        self._call("nvmlDeviceGetMemoryInfo", self._handle(index),
                   ctypes.byref(mem))
        return mem

    def memory_total_bytes(self, index: int) -> int:
        return int(self._memory(index).total)

    def memory_used_bytes(self, index: int) -> int:
        return int(self._memory(index).used)

    @property
    def serves_memory_v2(self) -> bool:
        """Whether the library exports nvmlDeviceGetMemoryInfo_v2."""
        return hasattr(self._lib, "nvmlDeviceGetMemoryInfo_v2")

    def _memory_v2(self, index: int) -> _MemoryV2:
        if not self.serves_memory_v2:
            raise NvmlError("this NVML serves no memory reservation",
                            NVML_ERROR_NOT_SUPPORTED)
        mem = _MemoryV2(version=_MEMORY_V2)
        self._call("nvmlDeviceGetMemoryInfo_v2", self._handle(index),
                   ctypes.byref(mem))
        return mem

    def memory_reserved_bytes(self, index: int) -> int:
        """What the NVIDIA driver reserves of the device memory (CUDA's total
        is NVML's total less this)."""
        return int(self._memory_v2(index).reserved)

    def memory_allocated_bytes(self, index: int) -> int:
        """The device memory processes hold: NVML's used bytes less the
        driver's reservation, which memory_used_bytes counts in."""
        return int(self._memory_v2(index).used)

    def event_set_create(self) -> _H:
        es = _H()
        self._call("nvmlEventSetCreate", ctypes.byref(es))
        return es

    def event_set_free(self, event_set) -> None:
        self._call("nvmlEventSetFree", event_set)

    def register_event(self, event_set, device_index: int) -> None:
        """Watch the device's Xid critical errors.  A refusal
        (NVML_ERROR_NOT_SUPPORTED on some passthrough and vGPU setups)
        raises NvmlError naming it."""
        rc = int(self._lib.nvmlDeviceRegisterEvents(
            self._handle(device_index), EVENT_TYPE_XID_CRITICAL, event_set))
        if rc != NVML_SUCCESS:
            raise NvmlError(
                f"nvmlDeviceRegisterEvents(device {device_index}, "
                f"XidCriticalError) refused: {error_name(rc)}", rc)

    def wait_for_event(self, event_set, timeout_ms: int) -> Optional[Event]:
        """Block up to timeout_ms; None on timeout.  A lost card is the
        host-wide EVENT_DEVICE_REMOVED; an Xid is `code_for_xid(xid)` on
        its device (host-wide when NVML names no device)."""
        data = _EventData()
        rc = int(self._lib.nvmlEventSetWait_v2(
            event_set, ctypes.byref(data), int(timeout_ms)))
        if rc == NVML_ERROR_TIMEOUT:
            return None
        if rc == NVML_ERROR_GPU_IS_LOST:
            return Event(-1, EVENT_DEVICE_REMOVED, self.now_us())
        if rc != NVML_SUCCESS:
            raise NvmlError(f"nvmlEventSetWait_v2 failed: {error_name(rc)}",
                            rc)
        idx = self._index_of(data.device) if data.device else -1
        xid = int(data.eventData)
        return Event(idx, code_for_xid(xid), self.now_us(), xid=xid)

    def average_duty_cycle(self, index: int,
                           since_us: int = 0) -> Optional[float]:
        """The GPU's busy percentage (0..100) as the NVIDIA driver averages it
        over its last sample period (`since_us` is the reference's
        window start; NVML keeps its own window), or None when the
        device serves no utilization."""
        del since_us
        util = _Utilization()
        rc = int(self._lib.nvmlDeviceGetUtilizationRates(
            self._handle(index), ctypes.byref(util)))
        if rc == NVML_ERROR_NOT_SUPPORTED:
            return None
        if rc != NVML_SUCCESS:
            raise NvmlError(
                f"nvmlDeviceGetUtilizationRates failed: {error_name(rc)}",
                rc)
        return float(util.gpu)

    def pci_address(self, index: int) -> tuple:
        """The card's PCI (domain, bus, device).  NvmlError where NVML
        serves none (NVML_ERROR_NOT_SUPPORTED on some virtual machines)."""
        pci = _PciInfo()
        self._call("nvmlDeviceGetPciInfo_v3", self._handle(index),
                   ctypes.byref(pci))
        return (int(pci.domain), int(pci.bus), int(pci.device))

    @property
    def serves_vendor_reads(self) -> bool:
        """Whether the library exports the clocks-event-reason and
        NVLink-state reads the health layer's vendor source polls."""
        return (self._clocks_fn is not None
                and hasattr(self._lib, "nvmlDeviceGetNvLinkState"))

    def clocks_event_reasons(self, index: int) -> int:
        """The nvmlClocksEventReason* bit mask of the device now."""
        if self._clocks_fn is None:
            raise NvmlError("this NVML serves no clocks-event reasons",
                            NVML_ERROR_NOT_SUPPORTED)
        mask = ctypes.c_ulonglong()
        self._call(self._clocks_fn, self._handle(index), ctypes.byref(mask))
        return int(mask.value)

    def nvlink_states(self, index: int) -> dict:
        """{link: active} for every NVLink the device answers for (a
        link NVML calls unsupported or out of range is not there)."""
        out = {}
        h = self._handle(index)
        for link in range(NVLINK_MAX_LINKS):
            state = ctypes.c_int(-1)
            rc = int(self._lib.nvmlDeviceGetNvLinkState(
                h, link, ctypes.byref(state)))
            if rc in (NVML_ERROR_NOT_SUPPORTED, NVML_ERROR_INVALID_ARGUMENT):
                continue
            if rc != NVML_SUCCESS:
                raise NvmlError(
                    f"nvmlDeviceGetNvLinkState(link {link}) failed: "
                    f"{error_name(rc)}", rc)
            out[link] = int(state.value)
        return out

    @staticmethod
    def now_us() -> int:
        return time.monotonic_ns() // 1000
