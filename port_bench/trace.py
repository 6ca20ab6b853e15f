"""The device trace of a traced run (`--trace 1`): torch.profiler over a
stretch of the window, read from the profiler's raw records.

What a reader gets (`Trace`): the device operations (kernels, copies,
sets; not the annotations a record_function mirrors onto the device's
timeline) with their names and spans, the traced stretch's length on
the host's clock, the busy time as the union of the device spans, and
for the breakdown the operations that took most time and the longest
idle gaps, each named by the CUDA runtime call the host was in across
the gap's middle ("no CUDA call": the host was in Python or the
engine's own work).
"""

from __future__ import annotations

import time


class Trace:
    def __init__(self, ops, cpu, window_s):
        self.ops = ops  # [(name, start_ns, end_ns)] device operations
        self.cpu = cpu  # [(name, start_ns, end_ns)] host operations
        self.window_s = window_s
        spans = sorted((s, e) for _, s, e in ops)
        busy, reach, gaps = 0, None, []
        for s, e in spans:
            if reach is None or s > reach:
                if reach is not None:
                    gaps.append((reach, s))
                busy += e - s
                reach = e
            elif e > reach:
                busy += e - reach
                reach = e
        self.busy_s = busy / 1e9
        self.gaps = gaps

    def kernels(self, *needles):
        """[(name, seconds)] of device operations whose name holds any
        of `needles`."""
        return [(n, (e - s) / 1e9) for n, s, e in self.ops
                if any(k in n for k in needles)]

    def breakdown(self, top=10):
        by_name = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[self._host_at((a + b) // 2), (b - a) / 1e9]
                          for a, b in gaps],
        }

    def _host_at(self, t):
        """The innermost host record running at `t` (latest start)."""
        best = None
        for n, s, e in self.cpu:
            if s <= t <= e and (best is None or s > best[1]):
                best = (n, s)
        return "host: " + (best[0][:100] if best else "no CUDA call")


class Tracer:
    """Start and stop torch.profiler around a stretch; `trace()` reads
    it.  Starting and stopping synchronize the device, so the stretch's
    host-clock length and the device work in it line up."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, torch.device(device).type == "cuda"
        self.prof = None
        self.t0 = self.t1 = None

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        # The device's activity alone: recording every host op would slow
        # a host-bound engine several fold under the trace.
        acts = [ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.start()
        self._sync()
        self.t0 = time.monotonic()

    def stop(self):
        self._sync()
        self.t1 = time.monotonic()
        self.prof.stop()

    def trace(self):
        return read_events(self.prof.profiler.kineto_results.events(),
                           self.t1 - self.t0)


def _is_device_op(e):
    """A kernel, copy or set on the device: a device-typed record that is
    neither a runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    ...) nor a record_function range mirrored onto the device."""
    if "CUDA" not in str(e.device_type()):
        return False
    if getattr(e, "is_user_annotation", lambda: False)():
        return False
    name = e.name()
    return not (name.startswith("cuda") or name.startswith("cu")
                and name[2:3].isupper())


def read_events(events, window_s):
    """Trace of the profiler's raw records: device operations, and host
    records (the CUDA runtime calls the host made) to name gaps by."""
    ops, cpu = [], []
    for e in events:
        rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        (ops if _is_device_op(e) else cpu).append(rec)
    return Trace(ops, cpu, window_s)
