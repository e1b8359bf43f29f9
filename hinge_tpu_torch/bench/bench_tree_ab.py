"""The device join and the FASTA path of this tree against another tree of the repo, in turns on one card.

Simulates one read set (`bench_e2e.simulate_reads`: seed 0, error-free,
or with chip_smoke.py phase 5's read errors under --errors), writes it as
FASTA, and runs four child processes in the order other, this, this,
other, each importing `hinge_tpu_torch` from its own tree.  A child
warms up on a genome of at most 300 kb (the kernel and native builds,
the CUDA context), reads the FASTA and runs:

- the device join alone, `overlap_base_records`: the join's wall, its
  counters and per-phase host walls (`bench.join_stats` of a
  `utils.log.record` around it; a tree from before the recorder gives
  its join's `stats=` keyword, synchronised at every phase boundary,
  under other keys), and a sha256 of its records;
- `bench_defaults_ab.run_arm("device", ...)`: assemble() from the FASTA
  under the CUDA defaults, its stage walls, the join's counters and
  per-phase seconds and the sha256 of the draft and consensus FASTA.

Every run must give the same records and FASTA bytes.  Each child's entry
and the whole entry are printed as JSON lines.  The other tree is a
checkout of another commit (`git archive <commit> | tar -x -C DIR`); its
package must have `bench_defaults_ab`.

    python -m hinge_tpu_torch.bench.bench_tree_ab OTHER_TREE [genome_len]
        [coverage] [--errors] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

#: this tree: the directory that holds this module's package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the trees in turn: the other tree first and last
ORDER = ("other", "this", "this", "other")
#: the warm-up genome's length, at most
WARMUP_LEN = 300_000
CHILD_TAG = "TREE_AB_CHILD "


def _records_sha256(store) -> str:
    """One digest of an overlap store's tspace and columns (the ones
    `bench.assert_stores_equal` compares), each as int64."""
    import numpy as np

    from hinge_tpu_torch.bench import STORE_COLUMNS

    h = hashlib.sha256(str(store.tspace).encode())
    for col in STORE_COLUMNS:
        h.update(np.ascontiguousarray(getattr(store, col),
                                      dtype=np.int64).tobytes())
    return h.hexdigest()


def child(fasta, warm, genome_len, warm_len, workdir, device):
    """One run in the tree on sys.path: warm up, then the join alone and
    the device arm; the run's entry."""
    from hinge_tpu_torch.bench import sync
    from hinge_tpu_torch.bench.bench_defaults_ab import run_arm
    from hinge_tpu_torch.device import resolve_device
    from hinge_tpu_torch.io.fasta import read_fasta
    from hinge_tpu_torch.overlap import device_join as DJ

    dev = resolve_device(device)
    t0 = time.perf_counter()
    DJ.overlap_base_records(read_fasta(warm), device=dev)
    run_arm("device", warm, os.path.join(workdir, "warm"), warm_len,
            device=dev)
    warm_s = time.perf_counter() - t0
    rs = read_fasta(fasta)
    sync(dev)
    t0 = time.perf_counter()
    got, stats = _join(DJ, rs, dev)
    sync(dev)
    entry = {"package": os.path.dirname(os.path.dirname(DJ.__file__)),
             "warmup_s": warm_s, "join_s": time.perf_counter() - t0,
             "join": stats, "records": got.n,
             "records_sha256": _records_sha256(got)}
    del got
    entry["assemble"] = run_arm("device", fasta, os.path.join(workdir, "run"),
                                genome_len, device=dev)
    return entry


def _join(DJ, rs, dev):
    """The device join of the tree on sys.path on `rs`: (records, its
    counters and phase seconds).  A tree from before the recorder gives
    its `stats=` keyword's phase seconds, synchronised at every phase
    boundary, as `<phase>_sync_s`: a quantity of their own, apart from
    the recorder's `<phase>_host_s`."""
    from hinge_tpu_torch.utils import log as L

    if not hasattr(L, "record"):
        stats = {}
        got = DJ.overlap_base_records(rs, device=dev, stats=stats)
        counters = ("blocks", "hits", "anchors", "kept")
        return got, {(k if k in counters else k + "_sync_s"): v
                     for k, v in stats.items()}
    from hinge_tpu_torch.bench import join_stats

    with L.record("join") as call:
        got = DJ.overlap_base_records(rs, device=dev)
    return got, join_stats(call)


def run(other, genome_len, coverage, *, device, errors=False,
        log=lambda *a: None) -> dict:
    """The four runs in turn; the entry.  Raises when a child fails or
    two runs' records or FASTA bytes differ."""
    from hinge_tpu_torch.bench import READ_ERRORS, card
    from hinge_tpu_torch.bench.bench_e2e import simulate_reads, write_reads
    from hinge_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    trees = {"other": os.path.abspath(other), "this": ROOT}
    err = READ_ERRORS if errors else {}
    warm_len = min(WARMUP_LEN, genome_len)
    with tempfile.TemporaryDirectory() as tmp:
        warm = os.path.join(tmp, "warm.fasta")
        write_reads(warm, simulate_reads(warm_len, coverage, **err)[1])
        t0 = time.perf_counter()
        _, rs = simulate_reads(genome_len, coverage, **err)
        fasta = os.path.join(tmp, "reads.fasta")
        write_reads(fasta, rs)
        n_reads = rs.n_reads
        del rs
        setup = time.perf_counter() - t0
        runs = []
        for i, which in enumerate(ORDER):
            tree = trees[which]
            wd = os.path.join(tmp, f"run{i}")
            os.makedirs(wd)
            env = dict(os.environ, PYTHONPATH=tree)
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", fasta,
                 warm, str(genome_len), str(warm_len), wd, str(dev)],
                cwd=tree, env=env, capture_output=True, text=True)
            lines = [x for x in r.stdout.splitlines() if x.startswith(CHILD_TAG)]
            if r.returncode != 0 or not lines:
                raise RuntimeError(f"run {i} ({which} tree {tree}) failed, "
                                   f"rc {r.returncode}:\n{r.stdout[-4000:]}\n"
                                   f"{r.stderr[-8000:]}")
            entry = {"run": i, "tree": which,
                     **json.loads(lines[-1][len(CHILD_TAG):])}
            if os.path.realpath(entry["package"]) != os.path.realpath(
                    os.path.join(tree, "hinge_tpu_torch")):
                raise RuntimeError(f"run {i} imported {entry['package']}, "
                                   f"not {tree}'s package")
            runs.append(entry)
            log(json.dumps(entry))
    keys = ["records", "records_sha256"]
    for r in runs[1:]:
        for k in keys:
            if r[k] != runs[0][k]:
                raise AssertionError(f"{k} differs between run 0 and run "
                                     f"{r['run']}")
        for k in ("n_contigs", "draft_sha256", "consensus_sha256"):
            if r["assemble"][k] != runs[0]["assemble"][k]:
                raise AssertionError(f"{k} differs between run 0 and run "
                                     f"{r['run']}")
    return {
        "kind": "tree_ab", **card(dev), "trees": trees,
        "workload": {"genome_mb": round(genome_len / 1e6, 2),
                     "coverage_x": coverage, "n_reads": n_reads, "seed": 0,
                     "input": "fasta", **err},
        "setup_s": setup, "order": list(ORDER), "runs": runs,
        "outputs_equal": True,
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        # run by path: drop this file's directory, so that the package
        # comes from the tree on PYTHONPATH
        if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
                os.path.abspath(__file__)):
            sys.path.pop(0)
        fasta, warm, genome_len, warm_len, wd, device = argv[1:7]
        entry = child(fasta, warm, int(genome_len), int(warm_len), wd, device)
        print(CHILD_TAG + json.dumps(entry), flush=True)
        return entry
    ap = argparse.ArgumentParser(
        prog="python -m hinge_tpu_torch.bench.bench_tree_ab",
        description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the root of the other tree")
    ap.add_argument("genome_len", nargs="?", type=int, default=4_600_000)
    ap.add_argument("coverage", nargs="?", type=float, default=30.0)
    ap.add_argument("--errors", action="store_true",
                    help="chip_smoke.py phase 5's read errors")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from hinge_tpu_torch.bench import card
    from hinge_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    print(json.dumps(card(dev)), flush=True)
    entry = run(args.other, args.genome_len, args.coverage, device=dev,
                errors=args.errors, log=lambda line: print(line, flush=True))
    print("AB " + json.dumps(entry), flush=True)
    return entry


if __name__ == "__main__":
    main()
