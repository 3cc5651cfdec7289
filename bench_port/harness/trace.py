"""The traced window's profiler events, reduced to what the readers need.

The window runs under ``torch.profiler`` (CPU and CUDA activities); its
events stay in memory and are read once from the profiler's raw event
list (building ``FunctionEvent`` objects for a million events would take
minutes). The arithmetic is ``chip_smoke.py:where_time_goes``'s:

- a span (a ``record_function`` range, the program's or the benchmark's)
  has a host range, and where it launched device work a device range from
  its first operation's start to its last one's end;
- device operations are kernels, copies and fills; the device is busy
  while any runs (their union), idle otherwise.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

Range = Tuple[int, int]  # (start ns, end ns)



def _kind(e) -> str:
    """The event's activity type as a lower-case name ("kernel",
    "user_annotation", ...), however the build prints the enum."""
    try:
        return str(e.activity_type()).lower().rsplit(".", 1)[-1]
    except (AttributeError, RuntimeError):
        return ""


def _on_device(e) -> bool:
    return str(e.device_type()).upper().endswith("CUDA")


@dataclasses.dataclass
class Trace:
    window: Range
    host_spans: Dict[str, List[Range]]  # name -> host ranges, in start order
    device_spans: Dict[str, List[Range]]  # name -> device ranges
    device_ops: List[Tuple[str, int, int]]  # (name, start, end), in start order
    run: Dict  # what the driver recorded in the window (requests, sizes)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Range]:
        """The union of the device operations' ranges inside the window."""
        out: List[List[int]] = []
        lo, hi = self.window
        for _, s, e in self.device_ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def host_ms(self, name: str) -> List[float]:
        return [(e - s) / 1e6 for s, e in self.host_spans.get(name, [])]

    def device_ms(self, name: str) -> List[float]:
        return [(e - s) / 1e6 for s, e in self.device_spans.get(name, [])]

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device_ops if match(n)) / 1e9

    def breakdown(self, top: int = 10) -> Dict[str, List[list]]:
        """The device operations that took most time (by name), and the idle
        time by the innermost span open on the host during each gap."""
        by_op: Dict[str, int] = defaultdict(int)
        for n, s, e in self.device_ops:
            by_op[n[:120]] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        idle: Dict[str, int] = defaultdict(int)
        for (s, e), name in zip(gaps, self._innermost([(s + e) // 2 for s, e in gaps])):
            idle[name or "(no span)"] += e - s
        gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in ops], "idle_gaps": [[n, t / 1e9] for n, t in gaps_by]}

    def _innermost(self, times: List[int]) -> List[Optional[str]]:
        """For each time, the latest-starting host span that contains it."""
        spans = sorted((s, e, n) for n, rs in self.host_spans.items() for s, e in rs)
        starts = [s for s, _, _ in spans]
        out = []
        for t in times:
            i = bisect.bisect_right(starts, t) - 1
            name = None
            while i >= 0 and t - starts[i] < 60e9:  # spans are far shorter than a minute
                s, e, n = spans[i]
                if e >= t:
                    name = n
                    break
                i -= 1
            out.append(name)
        return out


WINDOW_SPAN = "bench.window"


def from_profiler(prof, run: Dict) -> Trace:
    """Reduce a stopped ``torch.profiler.profile``'s raw events; the window
    is the host range of the benchmark's ``bench.window`` span."""
    host: Dict[str, List[Range]] = defaultdict(list)
    dev_spans: Dict[str, List[Range]] = defaultdict(list)
    ops: List[Tuple[str, int, int]] = []
    kinds: Dict[str, int] = defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        kinds[kind] += 1
        s = e.start_ns()
        r = (s, s + e.duration_ns())
        if _on_device(e) or kind.startswith("gpu_") or kind.endswith("kernel"):
            # on the device: a span's device range, or an operation (a
            # kernel, "concurrent_kernel" in some builds, a copy or a fill)
            if kind.endswith("user_annotation") or e.is_user_annotation():
                dev_spans[e.name()].append(r)
            else:
                ops.append((e.name(), r[0], r[1]))
        elif kind == "user_annotation" or e.is_user_annotation():
            host[e.name()].append(r)
    if WINDOW_SPAN not in host:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span; its events by kind: {dict(kinds)}")
    for d in (host, dev_spans):
        for v in d.values():
            v.sort()
    ops.sort(key=lambda o: o[1])
    return Trace(host[WINDOW_SPAN][0], dict(host), dict(dev_spans), ops, run)
