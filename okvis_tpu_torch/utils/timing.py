"""Hierarchical named-timer registry, and the span tree of a traced pipeline.

Copy of okvis_tpu.utils.timing, the reference profiler's behavior
(okvis_timing Timer.hpp:70-178): a global registry of named timers with
mean/min/max/stddev and a rolling mean over the last 50 samples, printed as a
table at shutdown. Device-side time is measured by synchronising on the
result (CUDA launches are asynchronous); use `torch.profiler` for kernel
traces.

Spans. A `Tracer` belongs to one pipeline (ThreadedVio.set_tracing); its
loops enter a frame's context (`Tracer.frame`) on the thread doing the
frame's work. Inside it, every `Timer`, `span` and `syncstats.sync` records
a span: name, frame stamp, id, parent, start and end on `time.time_ns()`,
the thread, and an attribute dict. `time.time_ns()` is the clock of
torch.profiler's kineto trace (the profiler converts its own and CUPTI's
timestamps to Unix nanoseconds), so a span and the device operations it
launched line up with no offset; while a profiler runs, each span also
enters `torch.profiler.record_function`, so a trace that records the
pipeline's threads shows the spans. Outside a frame's context nothing is
recorded, and a Timer costs one attribute read more than the registry
alone. The registry's `frame`, `preintegrate` and `sync.<tag>` totals are
kept whether tracing is on or not.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time as _time
from collections import deque
from typing import Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler


class _Accumulator:
    __slots__ = ("count", "total", "min", "max", "m2", "mean", "window")

    def __init__(self, window_size: int = 50):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.mean = 0.0
        self.m2 = 0.0  # Welford
        self.window = deque(maxlen=window_size)

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        d = v - self.mean
        self.mean += d / self.count
        self.m2 += d * (v - self.mean)
        self.window.append(v)

    @property
    def std(self) -> float:
        return math.sqrt(self.m2 / self.count) if self.count > 1 else 0.0

    @property
    def rolling_mean(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0


class Timing:
    """Process-global registry (ref okvis::timing::Timing singleton).

    Disable with OKVIS_TPU_DEACTIVATE_TIMERS=1 (ref compile-time
    DEACTIVATE_TIMERS switch -> DummyTimer)."""

    _lock = threading.Lock()
    _timers: Dict[str, _Accumulator] = {}
    enabled = os.environ.get("OKVIS_TPU_DEACTIVATE_TIMERS", "0") != "1"

    @classmethod
    def add(cls, name: str, seconds: float) -> None:
        if not cls.enabled:
            return
        with cls._lock:
            acc = cls._timers.get(name)
            if acc is None:
                acc = cls._timers[name] = _Accumulator()
            acc.add(seconds)

    @classmethod
    def mean(cls, name: str) -> float:
        return cls._timers[name].mean

    @classmethod
    def total(cls, name: str) -> float:
        return cls._timers[name].total

    @classmethod
    def count(cls, name: str) -> int:
        return cls._timers[name].count

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._timers.clear()

    @classmethod
    def print(cls) -> str:
        """Shutdown table (ref Timing::print): name, count, total, mean(std), min/max, rolling."""
        lines = ["{:<42s} {:>7s} {:>10s} {:>18s} {:>21s} {:>10s}".format(
            "timer", "count", "total[s]", "mean(std)[s]", "[min,max][s]", "roll50[s]")]
        with cls._lock:
            for name in sorted(cls._timers):
                a = cls._timers[name]
                lines.append(
                    "{:<42s} {:>7d} {:>10.4f} {:>10.6f}({:.6f}) [{:>9.6f},{:>9.6f}] {:>10.6f}".format(
                        name, a.count, a.total, a.mean, a.std, a.min, a.max, a.rolling_mean
                    )
                )
        table = "\n".join(lines)
        return table


class Timer:
    """Context-manager timer: ``with Timer("2.4 matching"): ...``.

    Matches the reference's construct/stop usage; also usable via explicit
    start()/stop().
    """

    def __init__(self, name: str, start: bool = True):
        self.name = name
        self._t0: Optional[float] = None
        self._span: Optional[_Span] = None
        if start:
            self.start()

    def start(self) -> None:
        self._t0 = _time.perf_counter()
        if _current.frame is not None:
            self._span = _open(self.name)

    def stop(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = _time.perf_counter() - self._t0
        self._t0 = None
        Timing.add(self.name, dt)
        if self._span is not None:
            _close(self._span)
            self._span = None
        return dt

    def __enter__(self) -> "Timer":
        if self._t0 is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ----------------------------------------------------------------------
# spans
# ----------------------------------------------------------------------
class _Current(threading.local):
    """The frame context this thread is in (None outside one), its open
    spans, innermost last, and the thread's native id."""

    frame = None
    stack: List["_Span"] = ()  # a list of this thread's own inside a frame's context
    tid = 0


_current = _Current()


class _Frame:
    """One frame of a Tracer while it is open: its span's id and start,
    and the spans handed from one thread to another (`begin` / `end`)."""

    __slots__ = ("tracer", "stamp", "id", "start", "handed")

    def __init__(self, tracer: "Tracer", stamp: int, start: int):
        self.tracer, self.stamp, self.id, self.start = tracer, stamp, next(tracer._ids), start
        self.handed: Dict[str, tuple] = {}


class _Span:
    __slots__ = ("frame", "id", "parent", "name", "start", "attrs", "rf")

    def __init__(self, frame: _Frame, parent: int, name: str):
        self.frame, self.id, self.parent, self.name = frame, next(frame.tracer._ids), parent, name
        self.attrs: Optional[dict] = None
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(name)
            self.rf.__enter__()
        self.start = _time.time_ns()


def _open(name: str) -> Optional[_Span]:
    f = _current.frame
    if f is None:
        return None
    stack = _current.stack
    s = _Span(f, stack[-1].id if stack else f.id, name)
    stack.append(s)
    return s


def _close(s: _Span) -> None:
    end = _time.time_ns()
    if s.rf is not None:
        s.rf.__exit__(None, None, None)
    _current.stack.remove(s)
    s.frame.tracer._record(s.frame.stamp, s.id, s.parent, s.name, s.start, end, _current.tid, s.attrs)


class span:
    """``with span("preintegrate"): ...``: a span of the current frame, with
    `attrs`, and nothing else (no Timing entry); nothing outside a frame's
    context."""

    __slots__ = ("name", "attrs", "_s")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs or None
        self._s: Optional[_Span] = None

    def __enter__(self) -> "span":
        if _current.frame is not None:
            self._s = _open(self.name)
            self._s.attrs = self.attrs
        return self

    def __exit__(self, *exc) -> None:
        if self._s is not None:
            _close(self._s)
            self._s = None


def tracing() -> bool:
    """Whether this thread is inside a traced frame."""
    return _current.frame is not None


def annotate(name: str, **attrs) -> None:
    """Set attributes on this thread's innermost open span called `name`
    (nothing when there is none)."""
    for s in reversed(_current.stack):
        if s.name == name:
            s.attrs = {**(s.attrs or {}), **attrs}
            return


def begin(name: str) -> None:
    """Open a span of the current frame that another thread ends (`end`):
    a hand-off between pipeline stages; recorded with no thread."""
    f = _current.frame
    if f is not None:
        f.handed[name] = (next(f.tracer._ids), _time.time_ns())


def end(name: str) -> None:
    """Close the current frame's span `name` opened by `begin`."""
    f = _current.frame
    if f is not None and name in f.handed:
        sid, start = f.handed.pop(name)
        f.tracer._record(f.stamp, sid, f.id, name, start, _time.time_ns(), None, None)


_NO_FRAME = contextlib.nullcontext()


class _InFrame:
    __slots__ = ("f", "_saved")

    def __init__(self, f: _Frame):
        self.f = f

    def __enter__(self):
        self._saved = (_current.frame, _current.stack)
        tid = threading.get_native_id()
        _current.frame, _current.stack, _current.tid = self.f, [], tid
        threads = self.f.tracer._threads
        if tid not in threads:
            threads[tid] = threading.get_ident() & 0xFFFFFFFF
        return self.f

    def __exit__(self, *exc):
        _current.frame, _current.stack = self._saved


class Tracer:
    """The span tree of one pipeline's frames, kept in memory until
    `export`. Off until `enabled` is set; a frame is traced when tracing
    was on as its camera group completed (`frame(stamp, start=True)`).
    Traced or not, each frame's time from its first image to its close
    is added to the Timer `frame`."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._images: Dict[int, tuple] = {}  # stamp -> (time_ns, perf_counter) of its first image
        self._starts: Dict[int, tuple] = {}  # open frames' starts by stamp
        self._frames: Dict[int, _Frame] = {}  # open traced frames by stamp
        self._spans: List[tuple] = []  # closed spans, in the order they closed
        self._threads: Dict[int, int] = {}  # native thread id -> pthread id's low 32 bits

    def image_added(self, stamp: int) -> None:
        """The first image of a frame's stamp arrived: its `frame` span starts."""
        with self._lock:
            self._images.setdefault(stamp, (_time.time_ns(), _time.perf_counter()))

    def frame(self, stamp: int, start: bool = False, tolerance_ns: int = 0):
        """The context of frame `stamp` on this thread. With `start`, first
        open the frame, starting at its first image within `tolerance_ns` of
        `stamp` (images older than that never made a frame and are
        forgotten). A null context when the frame is not traced."""
        if start:
            with self._lock:
                older = [s for s in self._images if s <= stamp + tolerance_ns]
                near = [self._images.pop(s) for s in older if s >= stamp - tolerance_ns]
                for s in older:
                    self._images.pop(s, None)
                t0 = min(near, default=None) or (_time.time_ns(), _time.perf_counter())
                self._starts[stamp] = t0
                if self.enabled:
                    self._frames[stamp] = _Frame(self, stamp, t0[0])
        f = self._frames.get(stamp)
        return _NO_FRAME if f is None else _InFrame(f)

    def close_frame(self, stamp: int, **attrs) -> None:
        """End frame `stamp` (the state was published, or the frame
        dropped): its time goes to the Timer `frame`, and a traced frame's
        spans can then be exported."""
        with self._lock:
            f = self._frames.pop(stamp, None)
            t0 = self._starts.pop(stamp, None)
        if t0 is not None:
            Timing.add("frame", _time.perf_counter() - t0[1])
        if f is not None:
            self._record(stamp, f.id, None, "frame", f.start, _time.time_ns(), None, attrs)

    def _record(self, *row) -> None:
        with self._lock:
            self._spans.append(row)

    def export(self) -> dict:
        """Hand out, and forget, the spans of every closed frame:
        {"frames": [{"stamp", "spans": [{name, id, parent, start_ns, end_ns,
        thread, attrs}], the `frame` span first}], "threads": {native id:
        pthread id's low 32 bits}}; frames in the order they closed."""
        with self._lock:
            open_stamps = set(self._frames)
            keep = [r for r in self._spans if r[0] in open_stamps]
            done = [r for r in self._spans if r[0] not in open_stamps]
            self._spans = keep
            threads = dict(self._threads)
        by_frame: Dict[int, list] = {}
        order = []
        for stamp, sid, parent, name, t0, t1, tid, attrs in done:
            if stamp not in by_frame:
                by_frame[stamp] = []
            row = dict(name=name, id=sid, parent=parent, start_ns=t0, end_ns=t1, thread=tid, attrs=attrs or {})
            if name == "frame":
                by_frame[stamp].insert(0, row)
                order.append(stamp)
            else:
                by_frame[stamp].append(row)
        return {"frames": [{"stamp": s, "spans": by_frame[s]} for s in order], "threads": threads}
