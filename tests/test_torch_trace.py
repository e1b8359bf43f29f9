"""The port's span recorder (hinge_tpu_torch/utils/log.py) on the CPU.

One small fasta-only `assemble(device="cpu")` with the CPU twins of the
CUDA routes (HINGE_DEVICE_JOIN=1, HINGE_FAST_ALIGN=1), once with no
profiler (and `record_function` / `torch.cuda.Event` made to raise) and
once under a CPU torch.profiler: the span tree, its profiler ranges, the
benchmark's idle split by sub-span, the join's counters, and the
quantity of each span or counter that PERF.md names a metric for.
"""

import json

import pytest
import torch

from benchmark import trace as T
from hinge_tpu_torch.data.simulator import SimParams, simulate
from hinge_tpu_torch.io.fasta import write_fasta
from hinge_tpu_torch.overlap import device_join as DJ
from hinge_tpu_torch.pipeline import assemble
from hinge_tpu_torch.utils import log as L

#: the keys of timings() that assemble() from FASTA adds to
STAGES = {"overlap", "filter", "maximal", "layout", "clip", "draft_path",
          "draft", "map", "consensus", "gfa"}


def _share(c, part, whole):
    a, b = c.counters.get(part), c.counters.get(whole)
    return a / b if a is not None and b else None


def _mib(c, name):
    n = c.counters.get(name)
    return n / 2**20 if n is not None else None


#: the hinge counters of the filter and the layout
HINGE_COUNTERS = ("filter.in_hinges", "filter.out_hinges",
                  "layout.hinges_killed", "layout.hinged_edges")
#: the quantity of each span or counter that PERF.md §3 names a metric
#: for, read from a call as the metric would; None where the call lacks it
QUANTITIES = {
    "pipeline.cpu_s": lambda c: c.cpu_s("assemble"),
    "draft.backbone_s": lambda c: c.self_s("draft.backbone"),
    "draft.ladders_s": lambda c: c.self_s("draft.ladders"),
    "draft.emit_s": lambda c: c.self_s("band_nw.emit"),
    "draft.vote_s": lambda c: c.self_s("draft.vote"),
    "draft.shortcut_share": lambda c: _share(c, "draft.pairs_identical",
                                             "draft.pairs"),
    "clip.graphml_s": lambda c: c.self_s("clip.graphml"),
    "filter.hinges_s": lambda c: c.self_s("filter.hinges"),
    "layout.hinge_graph_s": lambda c: c.self_s("layout.hinge_graph"),
    "map.diffs_s": lambda c: c.self_s("map.diffs"),
    "consensus.rows_s": lambda c: c.self_s("consensus.rows"),
    "consensus.vote_s": lambda c: c.self_s("consensus.vote"),
    "join.kept_share": lambda c: _share(c, "join.kept", "join.anchors"),
    "device.h2d_mib": lambda c: _mib(c, "copy.h2d_bytes"),
    "device.d2h_mib": lambda c: _mib(c, "copy.d2h_bytes"),
}


def _raise(*a, **k):
    raise AssertionError("made while no profiler records")


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """(plain call, its timings() delta, profiled call, the profiler's
    chrome-trace events) of one small fasta-only assemble() each."""
    tmp = tmp_path_factory.mktemp("trace")
    _, _, rs, _ = simulate(SimParams(
        genome_len=20_000, coverage=12.0, mean_read_len=4000,
        std_read_len=800, sub_rate=0.01, seed=33))
    fasta = str(tmp / "reads.fasta")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HINGE_DEVICE_JOIN", "1")
        mp.setenv("HINGE_FAST_ALIGN", "1")
        with pytest.MonkeyPatch.context() as off:
            off.setattr(torch.profiler, "record_function", _raise)
            off.setattr(torch.cuda, "Event", _raise)
            before = L.timings()
            assemble(fasta=fasta, workdir=str(tmp / "plain"), device="cpu",
                     log=lambda *a: None)
            plain = L.last_call()
            after = L.timings()
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        with prof, torch.profiler.record_function(T.WINDOW_SPAN):
            assemble(fasta=fasta, workdir=str(tmp / "profiled"),
                     device="cpu", log=lambda *a: None)
        profiled = L.last_call()
    path = str(tmp / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    stages = {k: v - before.get(k, 0.0) for k, v in after.items()
              if v - before.get(k, 0.0) > 0}
    return plain, stages, profiled, events


def _inside(a0, a1, b0, b1):
    return b0 <= a0 <= a1 <= b1


@pytest.mark.parametrize("which", ["plain", "profiled"])
def test_call_is_one_span_tree(calls, which):
    """One call id; the root first; every child inside its parent; self
    times >= 0 and summing to the root's wall; every span of the main
    path's layers there."""
    call = calls[0] if which == "plain" else calls[2]
    spans = {sp.id: sp for sp in call.spans}
    root = call.spans[0]
    assert root.name == "assemble" and root.parent is None
    assert {sp.call for sp in call.spans} == {call.id}
    for sp in call.spans[1:]:
        parent = spans[sp.parent]
        assert _inside(sp.t0, sp.t1, parent.t0, parent.t1), sp.name
        assert _inside(sp.cpu0, sp.cpu1, parent.cpu0, parent.cpu1), sp.name
        assert sp.self_ns >= 0
    assert sum(sp.self_ns for sp in call.spans) == root.t1 - root.t0
    names = {sp.name for sp in call.spans}
    assert STAGES | {"input", "correct_head"} <= names
    assert {"overlap.minimizer", "overlap.index", "overlap.p1", "overlap.p2",
            "overlap.p3", "overlap.p4", "overlap.fetch", "overlap.mirror",
            "filter.hinges", "layout.hinge_graph", "clip.graphs",
            "clip.graphml", "draft_path.graphml", "draft.index",
            "draft.backbone", "draft.ladders", "draft.align",
            "band_nw.pack", "band_nw.device", "band_nw.fetch",
            "band_nw.emit", "draft.vote", "draft.write", "map.index",
            "map.blocks", "map.diffs", "consensus.rows", "consensus.vote",
            "consensus.emit"} <= names
    parent_of = {sp.name: spans[sp.parent].name for sp in call.spans[1:]}
    assert parent_of["band_nw.emit"] == "draft.align"
    assert parent_of["draft.vote"] == "draft"
    assert parent_of["overlap.p3"] == "overlap"
    assert parent_of["filter.hinges"] == "filter"
    assert parent_of["layout.hinge_graph"] == "layout"
    assert all(sp.stream_s is None for sp in call.spans)  # no CUDA device


def test_timings_keep_their_keys(calls):
    """timings() gains exactly the ten stage keys over the call, each the
    wall of its stage span."""
    call, stages = calls[0], calls[1]
    assert set(stages) == STAGES
    for name, secs in stages.items():
        assert secs == pytest.approx(call.wall_s(name), abs=1e-3)


def test_counters_of_the_call(calls):
    """The copy counters read 0 on the CPU; the draft's pairs split into
    identical ones and those the band aligner took; the join counted; the
    port's graphml serializer wrote clip's G0-G2 and X_draft.graphml itself."""
    c = calls[0].counters
    assert c["copy.h2d_bytes"] == c["copy.d2h_bytes"] == c["copy.d2h_calls"] == 0
    assert c["draft.pairs"] > c["draft.pairs_identical"] > 0
    assert 0 < c["band_nw.pairs"] <= c["draft.pairs"] - c["draft.pairs_identical"]
    assert c["join.blocks"] == 1
    assert c["join.hits"] >= c["join.anchors"] >= c["join.kept"] > 0
    assert min(c[k] for k in HINGE_COUNTERS) >= 0
    assert c["graphml.files"] >= 4
    assert c.get("graphml.delegated", 0) == 0
    assert c["graphml.bytes"] > 0


def test_profiled_spans_are_profiler_ranges(calls):
    """Under the profiler each span is a user_annotation range named
    stage.<name> (the root pipeline.assemble), nested as the spans are."""
    call, events = calls[2], calls[3]
    ranges = {}
    for e in sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    seen = {}
    got = {}
    for sp in call.spans:
        name = ("pipeline." if sp.parent is None else "stage.") + sp.name
        k = seen.get(name, 0)
        seen[name] = k + 1
        got[sp.id] = ranges[name][k]
    assert {n: len(ranges[n]) for n in seen} == seen
    for sp in call.spans[1:]:
        assert _inside(*got[sp.id], *got[sp.parent]), sp.name


def test_idle_split_names_sub_spans(calls, monkeypatch):
    """benchmark/trace.py::summary labels the device's idle seconds (all
    of the window on the CPU) by the innermost span: sub-spans such as
    draft.vote, and the labels sum to the window."""
    monkeypatch.setattr(T, "TOP", 1000)
    s = T.summary(calls[3])
    idle = dict(s["idle_gaps"])
    assert s["busy_s"] == 0.0
    assert sum(idle.values()) == pytest.approx(s["window_s"], rel=1e-6)
    assert {"draft.vote", "band_nw.device", "overlap.minimizer",
            "clip.graphml", "map.diffs", "consensus.rows",
            "pipeline"} <= set(idle)


def test_no_profiler_makes_no_range_and_no_event(monkeypatch):
    """With no profiler recording, spans on a CUDA device make no CUDA
    event and no span opens a profiler range (both made to raise)."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    with L.record("call") as call:
        with L.span("overlap", device="cuda"):
            with L.span("overlap.p1", device=torch.device("cuda")):
                L.count("join.hits", 3)
    assert [sp.stream_s for sp in call.spans] == [None] * 3
    assert call.counters == {"join.hits": 3}


class _FakeEvent:
    """A CUDA event stand-in: records where it was recorded, and waits."""

    log = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream):
        self.at = len(_FakeEvent.log)
        _FakeEvent.log.append(("record", stream))

    def synchronize(self):
        _FakeEvent.log.append(("sync", self.at))

    def elapsed_time(self, end):
        return 1000.0 * (end.at - self.at)


def test_profiled_device_spans_wait_once_on_the_last_event(monkeypatch):
    """While the profiler records, a span on a CUDA device records an
    event at each end on the device's current stream; the call waits once,
    when it closes, on the last event, and each span's stream seconds are
    its events' elapsed time."""
    _FakeEvent.log = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: f"s:{dev}")
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with prof, L.record("call") as call:
        with L.span("overlap"):
            with L.span("overlap.p1", device="cuda"):
                pass
            with L.span("overlap.p2", device="cuda"):
                assert all(op == "record" for op, _ in _FakeEvent.log)
    assert _FakeEvent.log == [("record", "s:cuda")] * 4 + [("sync", 3)]
    assert [sp.stream_s for sp in call.spans] == [None, None, 1.0, 1.0]


def test_span_outside_a_call_records_nothing():
    """No call open: spans yield None and counters go nowhere, while
    stage_timer still adds to timings()."""
    before = L.timings().get("trace_test_stage", 0.0)
    last = L.last_call()
    with L.span("x") as sp, L.stage_timer("trace_test_stage") as st:
        L.count("x", 1)
    assert sp is None and st is None and L.last_call() is last
    assert L.timings()["trace_test_stage"] > before


def test_nested_record_is_a_call_of_its_own():
    """A record inside a record is a new call with its own id; the outer
    one goes on, and last_call() is the one that ended last."""
    with L.record("outer") as outer:
        L.count("n", 1)
        with L.record("inner") as inner:
            L.count("n", 2)
            with L.span("a"):
                pass
        assert L.last_call() is inner
        with L.span("b"):
            pass
    assert L.last_call() is outer and outer.id != inner.id
    assert [sp.name for sp in outer.spans] == ["outer", "b"]
    assert [sp.name for sp in inner.spans] == ["inner", "a"]
    assert outer.counters == {"n": 1} and inner.counters == {"n": 2}


@pytest.fixture(scope="module")
def join_reads():
    return simulate(SimParams(genome_len=40_000, coverage=10, seed=3))[2]


@pytest.mark.parametrize("block_bases, blocks", [(1 << 23, 1), (1 << 16, 15)])
def test_join_counters_equal_the_former_stats(join_reads, block_bases, blocks):
    """The join's counters, which hold what its former `stats=` keyword
    gave, on the CPU twin: hits >= anchors >= kept > 0, the same whatever
    the blocking but for join.blocks, kept equal to the anchors p3 kept;
    one span a phase and block."""
    kept = []
    thin = DJ.thin_rows_ref

    def spy(*a, **k):
        out = thin(*a, **k)
        kept.append(int(out[0].numel()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DJ, "thin_rows_ref", spy)
        with L.record("join") as call:
            got = DJ.overlap_base_records(join_reads, device="cpu",
                                          block_bases=block_bases)
    with L.record("join") as whole:
        ref = DJ.overlap_base_records(join_reads, device="cpu")
    c = dict(call.counters)
    assert got.n == ref.n > 0
    assert c.pop("join.blocks") == blocks and whole.counters["join.blocks"] == 1
    assert c == {k: v for k, v in whole.counters.items() if k != "join.blocks"}
    assert c["join.hits"] >= c["join.anchors"] >= c["join.kept"] > 0
    assert len(kept) == blocks and sum(kept) == c["join.kept"]
    assert c["copy.h2d_bytes"] == c["copy.d2h_bytes"] == c["copy.d2h_calls"] == 0
    n = {sp.name: 0 for sp in call.spans}
    for sp in call.spans:
        n[sp.name] += 1
    assert n == {"join": 1, "overlap.minimizer": 1, "overlap.index": 1,
                 **{f"overlap.{p}": blocks
                    for p in ("p1", "p2", "p3", "p4", "fetch")}}


@pytest.mark.parametrize("name", sorted(QUANTITIES))
def test_metric_quantity_reads_the_call(calls, name):
    """Each span or counter named for a metric is in a small call: a
    number >= 0 (a share in (0, 1]; the copy counters 0 on the CPU)."""
    got = QUANTITIES[name](calls[0])
    assert isinstance(got, float) and got >= 0
    if name.endswith("share"):
        assert 0 < got <= 1
    if name.startswith("device."):
        assert got == 0.0


@pytest.mark.parametrize("name", sorted(QUANTITIES))
def test_metric_quantity_is_none_without_its_span(name):
    """A call without the span or counter reads None, not 0."""
    with L.record("other") as call:
        with L.span("other.part"):
            L.count("other.n", 1)
    assert QUANTITIES[name](call) is None


def test_timing_tree_lines(calls):
    """Call.tree(): a line a path of names, indented by depth, summed over
    its spans, then the counters."""
    lines = calls[0].tree()
    assert lines[0].startswith("assemble: ")
    assert any(ln.startswith("    draft.align: ") and ln.endswith(" spans)")
               for ln in lines)
    assert "counter join.blocks: 1" in lines
    assert not any("stream" in ln for ln in lines)
    assert float(lines[0].split()[1][:-1]) == pytest.approx(
        calls[0].root.wall_s, abs=1e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_hinge_spans_and_counters(cuda_device, tmp_path):
    """On the card (device join, K4, the device hinge calls): the hinge
    spans sit in their stages with stream seconds under the profiler, and
    the hinge counters equal the CPU's C-join call's, on the rrn workload
    (tests/torch_golden_repeats.py) with its 3 kb reads."""
    from tests import torch_golden_repeats as GR

    _, _, rs, _ = simulate(GR.rrn_params(SimParams, "unbridged"))
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    got = {}
    for dev in ("cpu", cuda_device):
        prof = torch.profiler.profile()
        with prof:
            assemble(fasta=fasta, workdir=str(tmp_path / str(dev)),
                     device=dev, log=lambda *a: None)
        got[str(dev)] = L.last_call()
    cpu, card = got["cpu"], got[str(cuda_device)]
    assert {k: card.counters[k] for k in HINGE_COUNTERS} == {
        k: cpu.counters[k] for k in HINGE_COUNTERS}
    assert card.counters["layout.hinged_edges"] >= 1
    spans = {sp.id: sp for sp in card.spans}
    for name, stage in (("filter.hinges", "filter"),
                        ("layout.hinge_graph", "layout")):
        got = card.named(name)
        assert got and all(spans[sp.parent].name == stage for sp in got)
        assert card.stream_s(name) is not None and card.stream_s(name) >= 0
