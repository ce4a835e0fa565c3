"""The card's kernels under torch.profiler, read from the raw trace events.

prof.events() and key_averages() read the same numbers but first build an
event object for every trace event: 30-90 s of host time for a profiled
window of a few estimator frames (~40,000 launches a frame;
scripts/torch_profiler_cost.py). The raw events give the launches and the
summed kernel time in a second or two. chip_smoke.py and the bench tools
(okvis_tpu_torch.bench) share these readers.

`attribute` charges each device operation to the program span (a traced
pipeline's, utils.timing) that was open on the thread whose launch call
queued it, through the operation's correlation id, and each idle gap of
the device to the span open at its midpoint. Spans and trace share one
clock (Unix nanoseconds), so no offset is applied.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Callable, Iterable, Optional


def union(intervals: Iterable[tuple]) -> list:
    """The merged [start, end] of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_operations(prof) -> list:
    """The device operations (kernels, copies, fills) of a finished
    torch.profiler run, from its raw trace events, sorted by start:
    [(name, start_ns, end_ns, launch_ns, launch_thread)], where launch_ns is
    the start of the CUDA API call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...) of the same correlation id and launch_thread that
    call's thread (kineto's id: the native id of the thread that started
    the profiler, the low 32 bits of the pthread id of any other); both
    None where the trace holds no such call."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):  # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...
            calls[e.correlation_id()] = (e.start_ns(), e.device_resource_id())
    dev.sort(key=lambda x: x[1])
    return [(name, s, t, *calls.get(corr, (None, None))) for name, s, t, corr in dev]


def _innermost(spans: list, times: list) -> list:
    """For each of the ascending `times`, the id of the span with the latest
    start among `spans` [(start, end, id)] open at that time (None if
    none)."""
    spans = sorted(spans)
    heap, out, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            s, e, sid = spans[i]
            heapq.heappush(heap, (-s, e, sid))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def attribute(ops: list, spans: list, t0_ns: int, t1_ns: int, threads: Optional[dict] = None) -> dict:
    """Charge device operations and idle gaps to program spans.

    `ops`: [(name, start_ns, end_ns, launch_ns, launch_thread)] as
    device_operations gives them; `spans`: [(id, start_ns, end_ns, thread)],
    thread None for a span open on every thread; `threads` maps a span's
    thread to the other id the trace may give it (Tracer.export's
    "threads"). Each operation is charged to the innermost span (the latest
    start) open on its launching thread when its launch call started; the
    device's idle gaps inside [t0, t1] to the innermost span open on any
    thread at their midpoint. Returns {"launches": {span id: n},
    "not_charged": {reason: n}, "idle_ns": {span id or None: ns},
    "busy_ns", "window_ns", "operations"}."""
    # kineto keeps a thread's id as a signed 32-bit value: compare the low
    # 32 bits
    alias = {}
    for tid, other in (threads or {}).items():
        alias[tid & 0xFFFFFFFF] = alias[other & 0xFFFFFFFF] = tid
    everywhere = [(s, e, sid) for sid, s, e, th in spans if th is None]
    by_thread = defaultdict(list)
    for sid, s, e, th in spans:
        if th is not None:
            by_thread[th].append((s, e, sid))
    launches, not_charged = defaultdict(int), defaultdict(int)
    queries = defaultdict(list)
    for op in ops:
        launch_ns, launch_thread = op[3], op[4]
        if launch_ns is None:
            not_charged["no launch call in the trace"] += 1
        else:
            queries[alias.get(launch_thread & 0xFFFFFFFF, launch_thread)].append(launch_ns)
    for th, times in queries.items():
        times.sort()
        for sid in _innermost(by_thread.get(th, []) + everywhere, times):
            if sid is None:
                not_charged["outside the program's spans"] += 1
            else:
                launches[sid] += 1
    merged = union((max(s, t0_ns), min(e, t1_ns)) for _, s, e, *_ in ops if e > t0_ns and s < t1_ns)
    edges = [t0_ns] + [x for se in merged for x in se] + [t1_ns]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    all_spans = everywhere + [x for v in by_thread.values() for x in v]
    idle = defaultdict(int)
    for (a, b), sid in zip(gaps, _innermost(all_spans, [(a + b) // 2 for a, b in gaps])):
        idle[sid] += b - a
    return dict(launches=dict(launches), not_charged=dict(not_charged), idle_ns=dict(idle),
                busy_ns=sum(e - s for s, e in merged), window_ns=t1_ns - t0_ns, operations=len(ops))


def attribute_to_frames(prof, export: dict) -> dict:
    """`attribute` over a profiled stretch of a traced pipeline's frames
    (ThreadedVio.export_trace of the frames the profiler saw), by span
    name: the operations charged to a span of each name or a span inside
    it (`launches_within`; a frame's own work is under "frame"), those
    charged to each innermost span (`launches_by_span`), the operations not
    charged, and the idle seconds by innermost span between the first
    frame's start and the last frame's end (`idle_gaps_by_span`)."""
    spans = {s["id"]: s for f in export["frames"] for s in f["spans"]}
    frames = [f["spans"][0] for f in export["frames"]]
    if not frames:
        return {}
    t0, t1 = min(f["start_ns"] for f in frames), max(f["end_ns"] for f in frames)
    res = attribute(device_operations(prof), [(i, s["start_ns"], s["end_ns"], s["thread"]) for i, s in spans.items()],
                    t0, t1, export.get("threads"))
    within, innermost = defaultdict(int), defaultdict(int)
    for sid, n in res["launches"].items():
        innermost[spans[sid]["name"]] += n
        names, at = set(), sid
        while at in spans:
            names.add(spans[at]["name"])
            at = spans[at]["parent"]
        for name in names:
            within[name] += n
    idle = defaultdict(int)
    for sid, ns in res["idle_ns"].items():
        idle["outside the program's spans" if sid is None else spans[sid]["name"]] += ns
    return dict(launches_within=dict(within), launches_by_span=dict(innermost), not_charged=res["not_charged"],
                operations=res["operations"], idle_gaps_by_span=sorted(([k, v / 1e9] for k, v in idle.items()),
                                                                      key=lambda kv: -kv[1]),
                busy_s=res["busy_ns"] / 1e9, window_s=res["window_ns"] / 1e9)


def device_kernels(prof) -> tuple:
    """(launches, summed device ms) of the kernels a finished torch.profiler
    run traced, read from its raw trace events."""
    import torch

    kern = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    return len(kern), sum(e.duration_ns() for e in kern) / 1e6


def profile_summary(prof, frames: int, wall_ms: float) -> dict:
    """A profiled window's device busy share (the union of its operations'
    intervals over the wall; kernel_ms is their sum) and launches a frame."""
    launches, kernel_ms = device_kernels(prof)
    busy_ms = sum(e - s for s, e in union((op[1], op[2]) for op in device_operations(prof))) / 1e6
    return dict(frames=frames, wall_ms=wall_ms, kernel_ms=kernel_ms, busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms, launches_per_frame=launches / frames)


def profile_call(fn: Callable, top: int = 0) -> dict:
    """One call under torch.profiler on the card: its device kernels' summed
    time, their launches, and the `top` kernels by device time (the only
    reader here that builds key_averages(); keep `top` to short calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, kernel_ms = device_kernels(prof)
    out = dict(kernel_ms=kernel_ms, launches=launches)
    if top:
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        kernels.sort(key=lambda e: -e.self_device_time_total)
        out["top"] = [dict(kernel=e.key[:80], device_ms=e.self_device_time_total / 1e3, calls=e.count)
                      for e in kernels[:top]]
    return out


def kernel_ms_per_call(fn: Callable, reps: int = 3) -> dict:
    """`reps` back-to-back calls of `fn` under the profiler: the summed
    kernel time and the launches of one call (their means)."""
    res = profile_call(lambda: [fn() for _ in range(reps)])
    return dict(kernel_ms=res["kernel_ms"] / reps, launches=res["launches"] / reps)
