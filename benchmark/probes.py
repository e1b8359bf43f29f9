"""The benchmark's own instruments on the port: wrappers put in place of
module attributes that `pipeline.assemble` looks up at call time, and
taken out again afterwards.

- Always: the built-in overlapper's records (`overlap.mapper.
  overlap_reads`' return) are kept for the reference to judge.
- Traced (`Probes(traced=True)`): a profiler span (`record_function`,
  named `stage.<layer>`) around each call into a layer, and the two ops
  whose roofline shares are read, each call timed between two CUDA
  synchronisations with its work counted from its inputs and outputs
  (`roofline.py`): the draft's ladder aligner (`stages.draft.
  _align_ladder_pairs`) and the join's p3 thinning (`overlap.
  device_join.thin_rows`).
"""

from __future__ import annotations

import functools
import importlib
import time

import numpy as np

from benchmark import roofline

#: (module, attribute, span name) of each call into a layer
SPANS = (
    ("hinge_tpu_torch.io.fasta", "read_fasta", "input"),
    ("hinge_tpu_torch.io.las", "read_las", "input"),
    ("hinge_tpu_torch.overlap.mapper", "overlap_reads", "overlap"),
    ("hinge_tpu_torch.stages.filter", "run_filter", "filter"),
    ("hinge_tpu_torch.stages.maximal", "run_maximal", "maximal"),
    ("hinge_tpu_torch.stages.layout", "run_layout", "layout"),
    ("hinge_tpu_torch.stages.clip", "run_clip", "clip"),
    ("hinge_tpu_torch.stages.draft_path", "run_draft_path", "draft_path"),
    ("hinge_tpu_torch.stages.draft", "run_draft", "draft"),
    ("hinge_tpu_torch.io.fasta", "correct_head", "correct_head"),
    ("hinge_tpu_torch.overlap.mapper", "map_reads_to_targets", "map"),
    ("hinge_tpu_torch.stages.consensus", "run_consensus", "consensus"),
    ("hinge_tpu_torch.stages.gfa", "run_gfa", "gfa"),
)
#: the ops whose roofline shares are read: (module, attribute, key)
OPS = (
    ("hinge_tpu_torch.stages.draft", "_align_ladder_pairs", "draft_align"),
    ("hinge_tpu_torch.overlap.device_join", "thin_rows", "join_thin"),
)
#: the overlap record columns the reference judges
RECORD_COLUMNS = ("a_id", "b_id", "rc", "a_start", "a_end", "b_start",
                  "b_end")


def _draft_align_work(args, kwargs, result):
    pair_q, pair_t, band = args[:3]
    return roofline.draft_align_work(
        [len(q) for q in pair_q], [len(t) for t in pair_t],
        [len(q) == len(t) and np.array_equal(q, t)
         for q, t in zip(pair_q, pair_t)], band)


def _join_thin_work(args, kwargs, result):
    a_row, n_rows = args[0], args[3]
    return roofline.join_thin_work(int(a_row.shape[0]),
                                   int(result[0].shape[0]), int(n_rows))


WORK = {"draft_align": _draft_align_work, "join_thin": _join_thin_work}


class Probes:
    """Install with `with Probes(...) as p:`; `p.records` holds the
    overlapper's records of the last call, `p.ops[key]` the (bytes,
    operations, seconds) of each timed op call."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.records = None
        self.ops = {key: [] for *_, key in OPS}
        self._undo = []

    def _patch(self, mod_name, attr, make):
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)
        setattr(mod, attr, make(orig))
        self._undo.append((mod, attr, orig))

    def __enter__(self):
        def capture(fn):
            @functools.wraps(fn)
            def run(*args, **kwargs):
                ov = fn(*args, **kwargs)
                self.records = {c: np.array(getattr(ov, c))
                                for c in RECORD_COLUMNS}
                return ov
            return run

        try:
            if self.traced:
                for mod, attr, name in SPANS:
                    self._patch(mod, attr, functools.partial(_span, name))
                for mod, attr, key in OPS:
                    self._patch(mod, attr, functools.partial(
                        _timed, self.ops[key], WORK[key]))
            self._patch("hinge_tpu_torch.overlap.mapper", "overlap_reads",
                        capture)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc):
        while self._undo:
            mod, attr, orig = self._undo.pop()
            setattr(mod, attr, orig)
        return False


def _span(name, fn):
    import torch

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.profiler.record_function("stage." + name):
            return fn(*args, **kwargs)
    return run


def _timed(calls, work, fn):
    import torch

    @functools.wraps(fn)
    def run(*args, **kwargs):
        sync = torch.cuda.is_initialized()
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        calls.append((*work(args, kwargs, out), dt))
        return out
    return run
