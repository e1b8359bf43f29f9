"""Reading a torch.profiler chrome trace: the seconds in which the device
ran anything, the device ops that took most time, and the device's idle
time split by the benchmark's `stage.<layer>` spans.

`busy_seconds`' union of device spans is copied from the port's
hinge_tpu_torch/bench/bench_e2e.py::busy_seconds, clipped to a window.
"""

from __future__ import annotations

import json

#: chrome-trace categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the span around the whole traced call, and the prefix of stage spans
WINDOW_SPAN = "bench.assemble"
STAGE_PREFIX = "stage."
#: entries of each breakdown list
TOP = 10


def load(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _union(spans):
    """Sorted, merged [(start, end)] of `spans`."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summary(events: list) -> dict:
    """window_s, busy_s (union of device spans inside the window span),
    device_ops (the TOP device ops by summed seconds, by name) and
    idle_gaps (the TOP stages by the device's idle seconds while their
    span was open; "pipeline" where no stage span was), from a trace
    whose window span is WINDOW_SPAN.  Times in seconds."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"the trace holds {len(win)} {WINDOW_SPAN!r} spans, want 1")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    spans = [(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1))
             for e in dev]
    busy = _union([(s, e) for s, e in spans if e > s])
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0) / 1e6
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(STAGE_PREFIX):])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(STAGE_PREFIX))
    idle = {}
    for g0, g1 in _gaps(busy, w0, w1):
        for label, s in _split(g0, g1, stages):
            idle[label] = idle.get(label, 0.0) + s / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                            key=lambda x: -x[1])[:TOP],
    }


def _gaps(busy, w0, w1):
    """The stretches of [w0, w1] that no busy span covers."""
    t = w0
    for s, e in busy:
        if s > t:
            yield t, s
        t = max(t, e)
    if w1 > t:
        yield t, w1


def _split(g0, g1, stages):
    """[(label, microseconds)] of gap [g0, g1) under the stage spans (the
    innermost open one names a stretch; "pipeline" where none is)."""
    cuts = {g0, g1}
    for s, e, _ in stages:
        if s < g1 and e > g0:
            cuts.update(x for x in (s, e) if g0 < x < g1)
    cuts = sorted(cuts)
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        label = "pipeline"
        for s, e, name in stages:  # sorted by start: the last open is innermost
            if s <= mid < e:
                label = name
        out.append((label, b - a))
    return out
