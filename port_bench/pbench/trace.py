"""Reduce a ``torch.profiler`` trace, held in memory, to what the readers
take: device activity, the benchmark's spans, and where the device idled.

- ``busy_s``: the union of the device's activity intervals (kernels, copies,
  sets) inside the ``window`` span, not a sum of their times (activities
  that overlap count once).
- ``span_device_s[span]``: device seconds of the activities whose launch,
  found through the trace's correlation ids, lies inside one of the span's
  intervals on the host.
- ``kernel_s(name_test)``: device seconds of the activities whose name
  passes ``name_test``.
- ``breakdown``: the ten device operations that took most time, and the
  idle time grouped by what the host was doing at the middle of each gap
  (the innermost host event open there); gaps under ``SHORT_GAP_NS`` are
  back-to-back launches and are grouped as such.
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict

SHORT_GAP_NS = 10_000
WINDOW_SPAN = "window"


def _short(name: str, width: int = 160) -> str:
    """A kernel's symbol without its return type, its argument list and
    anonymous namespaces, cut to ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    return name.removeprefix("void ")[:width]


class Trace:
    def __init__(self, device: list, host: list, spans: dict, window: tuple):
        self.window = window                      # (start_ns, end_ns) on the host clock
        self.device = device                      # [(name, start_ns, end_ns, launch_ns | None)]
        self.host = host                          # [(name, start_ns, end_ns)] on the main thread
        self.spans = spans                        # {span: [(start_ns, end_ns)]}
        self.window_s = (window[1] - window[0]) / 1e9
        self.busy_s, self.gaps = self._union()

    def _union(self):
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e, _ in self.device if e > lo and s < hi)
        busy, gaps, cur_s, cur_e = 0, [], None, None
        prev_end = lo
        for s, e in ivs:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                if s > prev_end:
                    gaps.append((prev_end, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            prev_end = max(prev_end, cur_e)
        if cur_e is not None:
            busy += cur_e - cur_s
        if hi > prev_end:
            gaps.append((prev_end, hi))
        return busy / 1e9, gaps

    def count(self, span: str) -> int:
        return len(self.spans.get(span, []))

    def span_device_s(self, span: str) -> float:
        ivs = sorted(self.spans.get(span, []))
        starts = [s for s, _ in ivs]
        total = 0
        for _, s, e, launch in self.device:
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= ivs[i][1]:
                total += e - s
        return total / 1e9

    def kernel_s(self, test) -> float:
        lo, hi = self.window
        return sum(e - s for name, s, e, _ in self.device if test(name) and lo <= s < hi) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        lo, hi = self.window
        by_name = defaultdict(int)
        for name, s, e, _ in self.device:
            if lo <= s < hi:
                by_name[_short(name)] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v / 1e9] for k, v in ops],
                "idle_gaps": [[k, v / 1e9] for k, v in self.idle_by_host()[:top]]}

    def idle_by_host(self) -> list:
        """Idle nanoseconds by the innermost host event open at each gap's middle."""
        out = defaultdict(int)
        long_gaps = []
        for s, e in self.gaps:
            if e - s < SHORT_GAP_NS:
                out[f"gaps under {SHORT_GAP_NS // 1000} us (launch to launch)"] += e - s
            else:
                long_gaps.append(((s + e) // 2, e - s))
        long_gaps.sort()
        host = sorted(self.host, key=lambda ev: ev[1])
        open_ev, j = [], 0  # heap of (-start, end, name): the innermost open event on top
        for mid, dur in long_gaps:
            while j < len(host) and host[j][1] <= mid:
                heapq.heappush(open_ev, (-host[j][1], host[j][2], host[j][0]))
                j += 1
            while open_ev and open_ev[0][1] < mid:
                heapq.heappop(open_ev)
            # an event below the top may have ended; the top is checked above
            out[open_ev[0][2] if open_ev else "no host event"] += dur
        return sorted(out.items(), key=lambda kv: -kv[1])


def read(prof, span_names) -> Trace:
    """A ``Trace`` of the ``window`` span from a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    cpu_launch, device_raw, host_all, spans = {}, [], [], defaultdict(list)
    window, main_tid = None, None
    names = set(span_names) | {WINDOW_SPAN}
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if name in names or ev.is_user_annotation():
                continue
            device_raw.append((name, s, e, ev.correlation_id()))
            continue
        corr = ev.correlation_id()
        if corr:
            cpu_launch.setdefault(corr, s)
        host_all.append((name, s, e, ev.start_thread_id()))
        if name == WINDOW_SPAN:
            window, main_tid = (s, e), ev.start_thread_id()
        elif name in names:
            spans[name].append((s, e))
    if window is None:
        raise RuntimeError("the trace holds no 'window' span")
    device = [(n, s, e, cpu_launch.get(c)) for n, s, e, c in device_raw]
    host = [(n, s, e) for n, s, e, tid in host_all if tid == main_tid and n != WINDOW_SPAN]
    return Trace(device, host, dict(spans), window)
