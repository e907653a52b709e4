"""The device timeline of a traced window, read from ``torch.profiler``.

:class:`Timeline` holds every device activity (kernels, copies, sets) and
every host operation of the window, in the profiler's microseconds, clipped
to the window that the harness's ``perfbench.window`` span marks.  The
per-layer metrics' readers take what they need from it.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

WINDOW_SPAN = "perfbench.window"


class Span(NamedTuple):
    start: float       # microseconds on the profiler's clock
    end: float
    name: str


def _on_device(ev) -> bool:
    return "CUDA" in str(getattr(ev, "device_type", ""))


def _is_device_work(ev) -> bool:
    """A kernel, copy or set on the card; the profiler also puts the host's
    named ranges on the device's timeline, which are no device work."""
    return (_on_device(ev) and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith("perfbench."))


def merged(spans):
    """The union of ``spans`` as sorted, disjoint ``(start, end)`` pairs."""
    out = []
    for s, e in sorted((sp.start, sp.end) for sp in spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


class Timeline:
    def __init__(self, device: list, host: list, window: Span):
        self.window = window
        clip = lambda sp: Span(max(sp.start, window.start),
                               min(sp.end, window.end), sp.name)
        self.device = [clip(sp) for sp in device
                       if sp.end > window.start and sp.start < window.end]
        self.host = sorted(host)
        self.busy = merged(self.device)

    @classmethod
    def from_profile(cls, prof) -> "Timeline":
        device, host, window = [], [], None
        for ev in prof.events():
            tr = ev.time_range
            sp = Span(float(tr.start), float(tr.end), ev.name)
            if _is_device_work(ev):
                device.append(sp)
            elif not _on_device(ev):
                host.append(sp)
                if ev.name == WINDOW_SPAN:
                    window = sp
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        return cls(device, host, window)

    @property
    def window_s(self) -> float:
        return (self.window.end - self.window.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def kernels(self, part: str) -> list:
        """Device spans whose name holds ``part``, by start."""
        return sorted(sp for sp in self.device if part in sp.name)

    def share(self, part: str) -> float | None:
        """Share of the window (in %) in which a device span whose name
        holds ``part`` runs; None when none ran."""
        spans = self.kernels(part)
        if not spans:
            return None
        return 100.0 * sum(e - s for s, e in merged(spans)) * 1e-6 \
            / self.window_s

    def device_ops(self, n: int = 10) -> list:
        """``[[name, seconds], ...]``: the device operations that took most
        time in the window, summed by name."""
        tot = {}
        for sp in self.device:
            tot[sp.name] = tot.get(sp.name, 0.0) + (sp.end - sp.start) * 1e-6
        return [[k[:120], v] for k, v in sorted(tot.items(),
                                                key=lambda kv: -kv[1])[:n]]

    def gaps(self):
        """Idle stretches ``(start, end)`` of the device in the window."""
        out, t = [], self.window.start
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window.end > t:
            out.append((t, self.window.end))
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost harness span
        around it and the last host operation that started before it."""
        starts = [sp.start for sp in self.host]
        i = bisect.bisect_right(starts, t)
        outer, last = WINDOW_SPAN, "idle"
        for sp in self.host[:i]:
            if sp.name.startswith("perfbench.") and sp.end >= t:
                outer = sp.name
        for sp in reversed(self.host[:i]):
            if not sp.name.startswith("perfbench."):
                last = sp.name
                break
        return f"{outer} / after {last}"

    def idle_gaps(self, n: int = 10) -> list:
        """``[[what the host was doing, seconds], ...]``: the longest idle
        gaps of the device in the window."""
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_at(s), (e - s) * 1e-6] for s, e in longest]
