"""Copied from hinge_tpu/utils/log.py (logger and stage timing verbatim),
with the torch profiler in place of its `jax_trace`, and the port's span
recorder.

The reference registers an spdlog logger with stdout + daily-file sinks in
every binary (`filter.cpp:201-205`, mkdir("log") at :170) and logs stage
counters (#reads, #alignments, #hinges, coverage estimates — SURVEY.md §5).
This module provides the equivalent: a process-wide logger writing to
stdout and `<logdir>/log.txt`, a `stage_timer` context manager that
records wall time per stage, and an optional torch profiler trace hook.
The logger is named "hinge_tpu_torch", so that it never shares handlers
with another package's logger in the same process.

The recorder: `record(name)` opens a call (a root span with a new call
id) and yields its `Call`; inside it `span(name)` opens nested spans and
`count(name, n)` adds to the call's counters.  Each span keeps its host
wall (`time.perf_counter_ns`), its process CPU time
(`time.process_time_ns`) and, once the call ends, its self time (its wall
less the union of its children's walls).  Spans and counters opened with
no call open record nothing.  Only while torch.profiler records does a
span also open a profiler range (`stage.<name>`; the root
`pipeline.<name>`), and a span given a CUDA `device` record a CUDA event
at each end on the device's current stream: the root waits on the call's
last event when it closes and turns each pair into the span's stream
seconds.  The last finished call stays in memory (`last_call()`); nothing
is written to disk.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import torch

_LOGGER: Optional[logging.Logger] = None
_TIMINGS: Dict[str, float] = {}


def get_logger(logdir: str = "log",
               name: str = "hinge_tpu_torch") -> logging.Logger:
    """stdout + file dual-sink logger (reference: spdlog 'log' logger)."""
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    try:
        os.makedirs(logdir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(logdir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    except OSError:
        pass
    _LOGGER = logger
    return logger


@contextlib.contextmanager
def stage_timer(name: str, logger: Optional[logging.Logger] = None):
    """Times a pipeline stage; accumulates into the process timing table.
    Also a `span(name)`, which it yields."""
    t0 = time.perf_counter()
    try:
        with span(name) as sp:
            yield sp
    finally:
        dt = time.perf_counter() - t0
        _TIMINGS[name] = _TIMINGS.get(name, 0.0) + dt
        if logger is not None:
            logger.info("%s: %.2fs", name, dt)


def timings() -> Dict[str, float]:
    return dict(_TIMINGS)


@contextlib.contextmanager
def torch_trace(out_dir: Optional[str]):
    """Chrome/Perfetto trace of the enclosed block (CPU and CUDA
    activities) written to <out_dir>/trace.json when out_dir is set."""
    if not out_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


# ---------------------------------------------------------------------------
# the span recorder
# ---------------------------------------------------------------------------

class _State(threading.local):
    """Per thread: the stack of open calls (spans go to the innermost)."""

    def __init__(self):
        self.calls: List["Call"] = []


_CALL_IDS = itertools.count(1)
_STATE = _State()
_LAST: Optional["Call"] = None


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


class Span:
    """One timed stretch of a call: times in ns, stream seconds (None
    unless the call was profiled and the span ran on a CUDA device)."""

    __slots__ = ("name", "call", "id", "parent", "t0", "t1", "cpu0", "cpu1",
                 "self_ns", "stream_s", "_range", "_events")

    def __init__(self, name: str, call: int, sid: int, parent: Optional[int]):
        self.name, self.call, self.id, self.parent = name, call, sid, parent
        self.t1 = self.cpu1 = self.self_ns = 0
        self.stream_s = self._range = self._events = None
        self.t0 = time.perf_counter_ns()
        self.cpu0 = time.process_time_ns()

    @property
    def wall_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def self_s(self) -> float:
        return self.self_ns / 1e9

    @property
    def cpu_s(self) -> float:
        return (self.cpu1 - self.cpu0) / 1e9


class Call:
    """The spans (in the order they opened, the root first) and counter
    totals of one `record(...)`."""

    def __init__(self, name: str):
        self.id = next(_CALL_IDS)
        self.name = name
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._open: List[Span] = []

    @property
    def root(self) -> Span:
        return self.spans[0]

    def _open_span(self, name: str, device=None) -> Span:
        parent = self._open[-1].id if self._open else None
        sp = Span(name, self.id, len(self.spans), parent)
        self.spans.append(sp)
        self._open.append(sp)
        if _profiling():
            prefix = "stage." if parent is not None else "pipeline."
            sp._range = torch.profiler.record_function(prefix + name)
            sp._range.__enter__()
            if device is not None and torch.device(device).type == "cuda":
                sp._events = [device, _stream_event(device)]
        return sp

    def _close_span(self, sp: Span) -> None:
        if sp._events is not None:
            sp._events.append(_stream_event(sp._events[0]))
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        sp.cpu1 = time.process_time_ns()
        sp.t1 = time.perf_counter_ns()
        self._open.pop()

    def _finish(self) -> None:
        """Self times of every span; stream seconds of the device spans
        (one wait a device, on its last event)."""
        kids: Dict[int, list] = {}
        for sp in self.spans[1:]:
            kids.setdefault(sp.parent, []).append((sp.t0, sp.t1))
        for sp in self.spans:
            covered, end = 0, None
            for a, b in sorted(kids.get(sp.id, ())):
                if end is None or a > end:
                    covered += b - a
                    end = b
                elif b > end:
                    covered += b - end
                    end = b
            sp.self_ns = (sp.t1 - sp.t0) - covered
        timed = [sp for sp in self.spans if sp._events is not None]
        last = {}  # a device's last closed span
        for sp in timed:
            dev = str(sp._events[0])
            if dev not in last or sp.t1 > last[dev].t1:
                last[dev] = sp
        for sp in last.values():
            sp._events[2].synchronize()
        for sp in timed:
            _, ev0, ev1 = sp._events
            sp.stream_s = ev0.elapsed_time(ev1) / 1e3
            sp._events = None

    def named(self, name: str) -> List[Span]:
        return [sp for sp in self.spans if sp.name == name]

    def _sum(self, name: str, attr: str) -> Optional[float]:
        got = [getattr(sp, attr) for sp in self.named(name)]
        got = [x for x in got if x is not None]
        return sum(got) if got else None

    def wall_s(self, name: str) -> Optional[float]:
        """Summed wall seconds of the spans named `name`; None if none."""
        return self._sum(name, "wall_s")

    def self_s(self, name: str) -> Optional[float]:
        return self._sum(name, "self_s")

    def cpu_s(self, name: str) -> Optional[float]:
        return self._sum(name, "cpu_s")

    def stream_s(self, name: str) -> Optional[float]:
        return self._sum(name, "stream_s")

    def tree(self) -> List[str]:
        """One line a path of span names from the root (spans on one path
        summed), indented by depth, then one a counter."""
        paths: Dict[tuple, list] = {}
        path_of: Dict[int, tuple] = {}
        for sp in self.spans:
            path = path_of.get(sp.parent, ()) + (sp.name,)
            path_of[sp.id] = path
            paths.setdefault(path, []).append(sp)
        lines = []
        for path, sps in paths.items():
            wall = sum(sp.wall_s for sp in sps)
            own = sum(sp.self_s for sp in sps)
            cpu = sum(sp.cpu_s for sp in sps)
            line = (f"{'  ' * (len(path) - 1)}{path[-1]}: {wall:.3f}s wall, "
                    f"{own:.3f}s self, {cpu:.3f}s cpu")
            stream = [sp.stream_s for sp in sps if sp.stream_s is not None]
            if stream:
                line += f", {sum(stream):.3f}s stream"
            if len(sps) > 1:
                line += f" ({len(sps)} spans)"
            lines.append(line)
        lines += [f"counter {k}: {v}" for k, v in self.counters.items()]
        return lines


def _stream_event(device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


@contextlib.contextmanager
def record(name: str):
    """A new call: its root span `name` around the block; yields the
    `Call`, which `last_call()` returns once the block has ended."""
    global _LAST
    call = Call(name)
    _STATE.calls.append(call)
    root = call._open_span(name)
    try:
        yield call
    finally:
        call._close_span(root)
        _STATE.calls.pop()
        call._finish()
        _LAST = call


@contextlib.contextmanager
def span(name: str, device=None):
    """A span of the innermost open call on this thread, nested in its
    innermost open span; yields the `Span` (None when no call is open).
    `device`: where the span's work runs; on a CUDA device, while the
    profiler records, the span gets stream seconds."""
    if not _STATE.calls:
        yield None
        return
    call = _STATE.calls[-1]
    sp = call._open_span(name, device)
    try:
        yield sp
    finally:
        call._close_span(sp)


def count(name: str, n: int) -> None:
    """Add `n` to counter `name` of the innermost open call, if any."""
    if _STATE.calls:
        c = _STATE.calls[-1].counters
        c[name] = c.get(name, 0) + int(n)


def last_call() -> Optional[Call]:
    """The most recently finished call of the process."""
    return _LAST
