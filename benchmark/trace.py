"""What a ``torch.profiler`` trace of the window says: the device's busy
time (the union of the intervals of its kernels, copies and sets inside the
window), each kernel launch, the device operations that took most time, and
the device's idle time by what the host was doing meanwhile."""

from __future__ import annotations

import collections
import heapq


def _short(name: str) -> str:
    return name if len(name) <= 80 else name[:77] + "..."


def summarize(prof) -> dict:
    """The trace's numbers; times in the profiler's nanoseconds, kept as
    (name, start, end) tuples, and seconds in the summaries."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == "bench.window" and e.device_type() != cuda]
    if len(win) != 1:
        raise AssertionError(f"the trace holds {len(win)} window spans")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and t > w0 and s < w1:
                dev.append((e.name(), max(s, w0), min(t, w1)))
        elif e.name() != "bench.window":
            host.append((e.name(), s, t))
    return summarize_events(w0, w1, dev, host)


def summarize_events(w0: int, w1: int, dev: list, host: list) -> dict:
    """The summary of a window [w0, w1) from its device operations and host
    events, each a (name, start, end) tuple in nanoseconds (device ones
    clipped to the window)."""
    dev = sorted(dev, key=lambda t: t[1])
    host = sorted(host, key=lambda h: h[1])
    # the union of the device intervals, and the gaps between them
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for _, s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            else:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, w1))
    else:
        gaps.append((w0, w1))
    by_op = collections.Counter()
    for name, s, e in dev:
        by_op[_short(name)] += (e - s) / 1e9
    # label each gap by the innermost host event at its middle (the latest
    # started one that still runs): one sweep over the middles in order
    idle = collections.Counter()
    heap, k = [], 0
    for s, e in sorted(g for g in gaps if g[1] > g[0]):
        mid = (s + e) / 2
        while k < len(host) and host[k][1] <= mid:
            heapq.heappush(heap, (-host[k][1], host[k][2], host[k][0]))
            k += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        idle[_short(heap[0][2]) if heap else "no host event"] += (e - s) / 1e9
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernels": [(n, s, e) for n, s, e in dev],
        "device_ops": [[n, v] for n, v in by_op.most_common(10)],
        "idle_gaps": [[n, v] for n, v in idle.most_common(10)],
    }
