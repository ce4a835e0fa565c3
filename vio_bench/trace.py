"""Readers of a torch.profiler run's raw trace events.

A copy of okvis_tpu_torch/utils/profiling.py's reader (the raw kineto
events: `key_averages()` builds an object an event, tens of seconds for a
few frames of ~50,000 launches), with busy time taken as the union of the
device's intervals, not their sum, and the idle gaps between them named by
the host span that was open.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

MARK = "vio_bench.mark"


def events(prof) -> tuple:
    """(device events [(name, start_ns, end_ns)], the marker's start_ns or
    None) of a finished profiler run."""
    import torch

    dev, mark = [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif mark is None and e.name() == MARK:
            mark = e.start_ns()
    dev.sort(key=lambda x: x[1])
    return dev, mark


def union(intervals) -> list:
    """Merged [(start, end)] of sorted (name, start, end) intervals."""
    out = []
    for _, s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summary(dev: list, t0_ns: int, t1_ns: int, spans: Optional[list] = None, top: int = 10) -> dict:
    """Busy seconds (the union of device intervals inside [t0, t1]), the
    launches, the device operations that took most time, and the idle gaps
    summed by the innermost host span open at their midpoint (`spans`:
    [(name, start_ns, end_ns)] on the trace's clock)."""
    inside = [(n, max(s, t0_ns), min(e, t1_ns)) for n, s, e in dev if e > t0_ns and s < t1_ns]
    merged = union(inside)
    busy = sum(e - s for s, e in merged)
    by_name = defaultdict(int)
    for n, s, e in inside:
        by_name[n] += e - s
    gaps = defaultdict(int)
    edges = [t0_ns] + [x for se in merged for x in se] + [t1_ns]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        open_spans = [(s, n) for n, s, e in (spans or []) if s <= mid < e]
        gaps[max(open_spans)[1] if open_spans else "host: outside the layers' spans"] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy / 1e9, window_s=(t1_ns - t0_ns) / 1e9, launches=len(inside),
                device_ops=[[n[:120], v / 1e9] for n, v in ops], idle_gaps=[[n, v / 1e9] for n, v in idle])
