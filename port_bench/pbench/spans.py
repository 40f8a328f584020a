"""The program's own spans (``mmbidaf_tpu_torch/utils/profiling.py::span``,
named ``frontend.*``, ``model.*``, ``train.*``), read from a
``pbench.trace.Trace``: its main thread's host events (``host``), its device
activities with their launch times (``device``), and its idle gaps (``gaps``).

- ``device(trace, names)``: the device seconds and the count of the
  activities whose launch lies inside one of the named spans' intervals (a
  launch from another thread, autograd's, counts by its time);
- ``idle(trace, test)``: idle seconds of the gaps whose innermost open
  program span at the gap's middle passes ``test`` (every gap, the short
  ones between launches too).

A program without the spans (an older commit) has none in its trace: both
return ``None`` there, and the readers leave their metric out.
"""

from __future__ import annotations

import bisect
import heapq

LAYERS = ("frontend.", "model.", "train.")
# the train step's update: the metrics' gradient norm, the optimizer, the EMA
UPDATE = ("train.grad_norm", "train.optimizer", "train.ema")


def is_program_span(name: str) -> bool:
    return name.startswith(LAYERS)


def _merged(trace, names) -> list:
    """The union of the named spans' host intervals, sorted."""
    ivs = sorted((s, e) for n, s, e in trace.host if n in names)
    out = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device(trace, names) -> tuple[float, int] | None:
    """``(seconds, count)`` of the device activities launched inside any of
    ``names``' intervals; ``None`` where no such span was recorded."""
    ivs = _merged(trace, set(names))
    if not ivs:
        return None
    starts = [s for s, _ in ivs]
    total, count = 0, 0
    for _, s, e, launch in trace.device:
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= ivs[i][1]:
            total += e - s
            count += 1
    return total / 1e9, count


def idle(trace, test) -> float | None:
    """Idle seconds of the gaps whose innermost program span at their middle
    passes ``test(name)``; ``None`` where the trace holds no program span."""
    host = sorted((s, e, n) for n, s, e in trace.host if is_program_span(n))
    if not host:
        return None
    total, j, open_ev = 0, 0, []  # heap of (-start, end, name): the innermost on top
    for mid, dur in sorted(((s + e) // 2, e - s) for s, e in trace.gaps):
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(open_ev, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while open_ev and open_ev[0][1] < mid:
            heapq.heappop(open_ev)
        if open_ev and test(open_ev[0][2]):
            total += dur
    return total / 1e9


def per_unit_ms(run, names) -> float | None:
    """Device milliseconds a batch or step (``run.window.units``) launched
    inside ``names``; ``None`` off the card or without the spans."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    got = device(run.trace, names)
    return None if got is None else got[0] / run.window.units * 1e3
