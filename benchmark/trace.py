"""Reading a torch.profiler Chrome trace of a traced slice of a run.

The harness marks the slice with a ``bench.window`` annotation and each of
its own spans with ``bench.<name>`` (``bench.call`` around a request's
calls). Device activity is every kernel, copy and fill the trace lists;
the card's busy time is the union of their intervals inside the window.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench."


class Trace:
    def __init__(self, events: list):
        marks = [e for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(PREFIX)]
        win = next(e for e in marks if e["name"] == PREFIX + "window")
        self.t0, self.t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
        self.device = []  # (start, end, name), clipped to the window, in us
        for e in events:
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
                a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
                a, b = max(a, self.t0), min(b, self.t1)
                if b > a:
                    self.device.append((a, b, e["name"]))
        self.device.sort()
        self.spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                             e["name"][len(PREFIX):]) for e in marks if e is not win)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def requests(self) -> int:
        """Requests made in the slice (``bench.call`` spans)."""
        return sum(1 for s in self.spans if s[2] == "call")

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's activity intervals, in us."""
        merged: list[list[float]] = []
        for a, b, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        """The window's stretches with nothing on the device, in us."""
        out, t = [], self.t0
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def device_seconds(self, match) -> float:
        """Device seconds of the activities whose name ``match`` accepts."""
        return sum(b - a for a, b, n in self.device if match(n)) / 1e6

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        total: dict[str, float] = defaultdict(float)
        for a, b, n in self.device:
            total[_short(n)] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_by_span(self, top: int = 10) -> list[list]:
        """Idle device seconds by the innermost benchmark span open on the
        host at the middle of each gap ("loop" outside every span)."""
        starts = [s[0] for s in self.spans]
        total: dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            mid = (a + b) / 2
            k = bisect.bisect_right(starts, mid)
            inner = None
            for s in reversed(self.spans[max(0, k - 8):k]):
                if s[1] >= mid and (inner is None or s[1] - s[0] < inner[1] - inner[0]):
                    inner = s
            total[inner[2] if inner else "loop"] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def _short(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= 160 else name[:157] + "..."


def load(path) -> Trace:
    with open(path) as f:
        data = json.load(f)
    return Trace(data["traceEvents"] if isinstance(data, dict) else data)
