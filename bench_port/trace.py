"""The profiler's timeline of a measured window, reduced to what the
per-layer metrics read.

:func:`profile` runs the window under ``torch.profiler`` (CPU and CUDA
activity) and returns a :class:`Timeline`: the device's activities
(kernels, copies, fills) and the host's operations, as (name, start,
end) in microseconds on the profiler's one clock, and the window's own
span.  The profiler has left out up to a few dozen of a session's
device records at its edges on an H100; 64 short spin kernels before
the window and after it, each batch waited for, take that loss instead.

:class:`Timeline` gives the device's busy time (the union of its
activity intervals inside the window), time by activity name, the idle
gaps labeled by the host operation that was running, and the window's
length.  No CUDA is needed to build one from records, so the CPU tests
hold the arithmetic on canned timelines.
"""

from __future__ import annotations

from collections import defaultdict

__all__ = ["Timeline", "profile", "WINDOW", "CALL"]

WINDOW = "bench_port.window"
CALL = "bench_port.call"


class Timeline:
    """``device``: [(name, start_us, end_us)] of the device's activities;
    ``host``: the same for the host's operations and the harness's spans
    (``WINDOW`` once, ``CALL`` a call)."""

    def __init__(self, device, host):
        self.host = sorted(host, key=lambda e: (e[1], -e[2]))
        spans = [e for e in self.host if e[0] == WINDOW]
        if len(spans) != 1:
            raise ValueError("a timeline holds one %r span, found %d"
                             % (WINDOW, len(spans)))
        self.t0, self.t1 = spans[0][1], spans[0][2]
        # the harness's own spans show on the device's timeline too, as
        # annotations over the work they launched: not device activity
        self.device = sorted((e for e in device
                              if e[2] > self.t0 and e[1] < self.t1
                              and not e[0].startswith("bench_port.")),
                             key=lambda e: e[1])
        self.calls = [e for e in self.host if e[0] == CALL
                      and e[1] >= self.t0 and e[2] <= self.t1]

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    def intervals(self):
        """The union of the device activities, clipped to the window, as
        sorted disjoint (start, end) pairs."""
        out = []
        for _, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.intervals()) / 1e6

    def by_name(self, match=lambda name: True):
        """Device seconds a name, over the records ``match`` keeps."""
        out = defaultdict(float)
        for name, a, b in self.device:
            if match(name):
                out[name] += (min(b, self.t1) - max(a, self.t0)) / 1e6
        return dict(out)

    def seconds(self, match):
        return sum(self.by_name(match).values())

    def gaps(self):
        """The idle gaps inside the window, (start, end)."""
        out, t = [], self.t0
        for a, b in self.intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.t1:
            out.append((t, self.t1))
        return out

    def host_at(self, times):
        """For each of the sorted ``times``, what the host was doing: the
        innermost torch operation running then, else ``in a call, after
        <the last operation that ended>`` (host code between operations),
        else ``between calls`` (one sweep over the host's spans)."""
        out, active, i, last = [], [], 0, None
        for t in times:
            while i < len(self.host) and self.host[i][1] <= t:
                active.append(self.host[i])
                i += 1
            for e in active:
                if e[2] <= t and not e[0].startswith("bench_port.") and (
                        last is None or e[2] > last[2]):
                    last = e
            active = [e for e in active if e[2] > t]
            best = min(active, key=lambda e: e[2] - e[1], default=None)
            if best is None or best[0] == WINDOW:
                out.append("between calls")
            elif best[0] == CALL:
                out.append("in a call, after %s"
                           % (last[0] if last and last[2] > best[1]
                              else "its start"))
            else:
                out.append(best[0])
        return out

    def breakdown(self, top=10):
        """``device_ops``: the activities that took the most device time;
        ``idle_gaps``: the idle time summed by what the host was doing at
        each gap's midpoint, longest first; both [[name, seconds]]."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        idle = defaultdict(float)
        gaps = self.gaps()
        for (a, b), what in zip(gaps, self.host_at([(a + b) / 2
                                                    for a, b in gaps])):
            idle[what] += (b - a) / 1e6
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


def profile(window):
    """Run ``window()`` (which marks each call with a ``CALL`` span) under
    torch.profiler; returns its :class:`Timeline`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    def pad():
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        pad()
        with record_function(WINDOW):
            window()
            torch.cuda.synchronize()
        pad()
    device, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            device.append(rec)
        elif e.device_type == DeviceType.CPU:
            host.append(rec)
    return Timeline(device, host)
