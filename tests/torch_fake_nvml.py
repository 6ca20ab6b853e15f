"""A function table standing in for libnvidia-ml.so.1 in the port's CPU
tests: `Nvml(lib=FakeNvml(...))` calls these methods with the same
ctypes arguments it passes the NVIDIA driver's library, and each returns an
nvmlReturn_t and fills its by-reference outputs as NVML does."""

from __future__ import annotations

import queue

SUCCESS, INVALID_ARGUMENT, NOT_SUPPORTED, TIMEOUT, GPU_IS_LOST = (
    0, 2, 3, 10, 15)


class FakeNvml:
    """`n` cards with /dev minors `minors`; `links[i]` is card i's
    {link: state} (missing links answer NOT_SUPPORTED), `clocks[i]` its
    clocks-event reason mask, `pci[i]` its PCI (domain, bus, device).
    `events` feeds nvmlEventSetWait_v2: an int is returned as the call's
    code, a (card or None, xid) pair is delivered as an Xid event.
    `rc[name]` makes a function return that code; `calls` counts the
    calls by name; vendor=False drops the vendor reads' functions."""

    def __init__(self, n=2, minors=None, links=None, clocks=None,
                 vendor=True):
        self.n = n
        self.minors = list(minors if minors is not None else range(n))
        self.uuids = [f"GPU-{i:08x}-0000-0000-0000-000000000000"
                      for i in range(n)]
        self.total = [80 << 30] * n
        self.used = [1 << 30] * n
        self.reserved = [480 << 20] * n
        self.links = links if links is not None else [{} for _ in range(n)]
        self.clocks = clocks if clocks is not None else [0] * n
        self.util = [37] * n
        self.pci = [(0, 0x18 + 0x10 * i, 0) for i in range(n)]
        self.events: "queue.Queue" = queue.Queue()
        self.rc = {}
        self.calls = {}
        self.registered = []  # (card, event types, set)
        self.sets_made = 0
        self.sets_freed = []
        # vendor=False: a library without the vendor reads.
        self.missing = set() if vendor else {
            "nvmlDeviceGetCurrentClocksEventReasons",
            "nvmlDeviceGetNvLinkState"}

    def __getattribute__(self, name):
        if name.startswith("nvml"):
            if name in object.__getattribute__(self, "missing"):
                raise AttributeError(name)
            self.calls[name] = self.calls.get(name, 0) + 1
            rc = self.rc.get(name)
            if rc is not None:
                return lambda *a: rc
        return object.__getattribute__(self, name)

    def _card(self, handle):
        h = handle.value if hasattr(handle, "value") else handle
        return int(h) - 0x1000

    def nvmlInit_v2(self):
        return SUCCESS

    def nvmlShutdown(self):
        return SUCCESS

    def nvmlDeviceGetCount_v2(self, out):
        out._obj.value = self.n
        return SUCCESS

    def nvmlDeviceGetHandleByIndex_v2(self, i, out):
        if not 0 <= i < self.n:
            return INVALID_ARGUMENT
        out._obj.value = 0x1000 + i
        return SUCCESS

    def nvmlDeviceGetUUID(self, h, buf, length):
        buf.value = self.uuids[self._card(h)].encode()
        return SUCCESS

    def nvmlDeviceGetMinorNumber(self, h, out):
        out._obj.value = self.minors[self._card(h)]
        return SUCCESS

    def nvmlDeviceGetMemoryInfo(self, h, out):
        i = self._card(h)
        out._obj.total = self.total[i]
        out._obj.used = self.used[i]
        out._obj.free = self.total[i] - self.used[i]
        return SUCCESS

    def nvmlDeviceGetMemoryInfo_v2(self, h, out):
        i = self._card(h)
        if out._obj.version != (40 | 2 << 24):
            return 25  # NVML_ERROR_ARGUMENT_VERSION_MISMATCH
        out._obj.total = self.total[i]
        out._obj.reserved = self.reserved[i]
        out._obj.used = self.used[i]
        out._obj.free = self.total[i] - self.reserved[i] - self.used[i]
        return SUCCESS

    def nvmlEventSetCreate(self, out):
        self.sets_made += 1
        out._obj.value = 0x9000 + self.sets_made
        return SUCCESS

    def nvmlEventSetFree(self, es):
        self.sets_freed.append(es.value)
        return SUCCESS

    def nvmlDeviceRegisterEvents(self, h, types, es):
        self.registered.append((self._card(h), types, es.value))
        return SUCCESS

    def nvmlEventSetWait_v2(self, es, out, timeout_ms):
        try:
            item = self.events.get(timeout=timeout_ms / 1000)
        except queue.Empty:
            return TIMEOUT
        if isinstance(item, int):
            return item
        card, xid = item
        out._obj.device = None if card is None else 0x1000 + card
        out._obj.eventType = 0x8
        out._obj.eventData = xid
        return SUCCESS

    def nvmlDeviceGetUtilizationRates(self, h, out):
        out._obj.gpu = self.util[self._card(h)]
        return SUCCESS

    def nvmlDeviceGetCurrentClocksEventReasons(self, h, out):
        out._obj.value = self.clocks[self._card(h)]
        return SUCCESS

    def nvmlDeviceGetNvLinkState(self, h, link, out):
        states = self.links[self._card(h)]
        if link not in states:
            return NOT_SUPPORTED
        out._obj.value = states[link]
        return SUCCESS

    def nvmlDeviceGetPciInfo_v3(self, h, out):
        domain, bus, device = self.pci[self._card(h)]
        out._obj.domain, out._obj.bus, out._obj.device = domain, bus, device
        out._obj.busId = f"{domain:08x}:{bus:02x}:{device:02x}.0".encode()
        return SUCCESS
