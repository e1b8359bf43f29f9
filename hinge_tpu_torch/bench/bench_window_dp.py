"""Port of `bench_window_dp.py`: window-DP throughput host to host, C DW_banded vs band-NW (K1/K2/K2e) vs the DW_banded wave (K3).

The JAX script's windows (800-1000 bp queries, each template a copy with
5-25% divergence; the same rng draws in the same order, so the same
windows), each aligner timed from inputs on the host to alignment rows
on the host, in windows/s with its edit count:

- C DW_banded: `ops/myers.align_exact_batch(qs, ts, 1500)`;
- band-NW: `ops/band_nw.band_align_batch` on the device (K1/K2/K2e on CUDA);
- K3: `ops/wavefront.align_exact_batch_device` on the device.

The device rows are timed twice: the first call (which builds the
kernels if they are not built) and warm.  Gates, which raise: K3's rows
equal the C rows byte for byte (C at K3's band tolerance, 150, the
draft's), and band-NW's rows equal the rows of the kernels' plain torch
twins on the same windows and device.  Band-NW's
edit ratio to C is printed, not gated: it is a different aligner.

    python -m hinge_tpu_torch.bench.bench_window_dp [n_windows] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np

from hinge_tpu_torch.bench import card, sync
from hinge_tpu_torch.device import resolve_device

#: the C row's band tolerance (bench_window_dp.py:53)
C_BAND = 1500


def windows(n, seed=0):
    """(qs, ts): the JAX script's `n` windows (bench_window_dp.py:22-45),
    the rng drawn in exactly its order."""
    rng = np.random.default_rng(seed)

    def mutate(q, d):
        out = []
        for b in q:
            r = rng.random()
            if r < d * 0.4:
                continue  # deletion
            if r < d * 0.7:
                out.append(rng.integers(0, 4))  # substitution
                continue
            out.append(b)
            if rng.random() < d * 0.3:
                out.append(rng.integers(0, 4))  # insertion
        return np.array(out, np.uint8)

    qs, ts = [], []
    for _ in range(n):
        L = int(rng.integers(800, 1000))
        q = rng.integers(0, 4, L).astype(np.uint8)
        qs.append(q)
        ts.append(mutate(q, float(rng.uniform(0.05, 0.25))))
    return qs, ts


def edits(rows):
    return sum(int((a != b).sum()) for a, b in rows)


@contextlib.contextmanager
def plain_twins():
    """band_align_batch with K1/K2/K2e's plain torch twins in the
    kernels' place, on whatever device it is given."""
    from hinge_tpu_torch.ops import band_nw as BN

    kernels = BN.band_fill, BN.row_traceback, BN.emit_rows
    BN.band_fill, BN.row_traceback, BN.emit_rows = (
        BN.band_fill_ref, BN.row_traceback_ref, BN.emit_rows_ref)
    try:
        yield
    finally:
        BN.band_fill, BN.row_traceback, BN.emit_rows = kernels


def _rows_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        for x, y in zip(a, b))


def _timed(fn, dev):
    t0 = time.perf_counter()
    rows = fn()
    sync(dev)
    return rows, time.perf_counter() - t0


def run(qs, ts, *, device) -> dict:
    """The three rows on (qs, ts) and their gates; raises when a gate
    fails.  Returns windows/s, seconds, edits and launches per row."""
    from hinge_tpu_torch.ops import band_nw as BN
    from hinge_tpu_torch.ops import myers as MY
    from hinge_tpu_torch.ops import wavefront as WF

    dev = resolve_device(device)
    n = len(qs)
    out = {"n_windows": n, **card(dev)}
    rows_c, t_c = _timed(lambda: MY.align_exact_batch(qs, ts, C_BAND), dev)
    out["c_dw_banded"] = {"win_s": n / t_c, "s": t_c, "edits": edits(rows_c)}
    print(f"native C DW_banded: {n / t_c:8.0f} win/s  ({t_c:.3f}s, "
          f"edits {edits(rows_c)})", flush=True)
    rows = {}
    for name, fn, counts in (
            ("band_nw", lambda: BN.band_align_batch(qs, ts, device=dev),
             BN.launches),
            ("k3", lambda: WF.align_exact_batch_device(qs, ts, device=dev),
             WF.launches)):
        before = dict(counts)
        for tag in ("first", "warm"):
            rows[name], t = _timed(fn, dev)
            out[f"{name}_{tag}"] = {"win_s": n / t, "s": t,
                                    "edits": edits(rows[name])}
            print(f"{name} ({tag}): {n / t:8.0f} win/s  ({t:.3f}s, "
                  f"edits {edits(rows[name])})", flush=True)
        out[f"{name}_launches"] = {k: v - before[k] for k, v in counts.items()}
    with plain_twins():
        twin = BN.band_align_batch(qs, ts, device=dev)
    if not _rows_equal(rows["band_nw"], twin):
        raise AssertionError("band-NW kernel rows differ from the plain "
                             "twins' rows")
    # K3 is DW_banded at its own band tolerance (150, the draft's)
    if not _rows_equal(rows["k3"], MY.align_exact_batch(qs, ts)):
        raise AssertionError("K3 rows differ from the C DW_banded rows")
    out["band_nw_rows_equal_twins"] = out["k3_rows_equal_c"] = True
    out["speedup_band_nw_warm"] = t_c / out["band_nw_warm"]["s"]
    out["speedup_k3_warm"] = t_c / out["k3_warm"]["s"]
    out["band_nw_edit_ratio"] = edits(rows["band_nw"]) / max(edits(rows_c), 1)
    print(f"speedup warm: band-NW {out['speedup_band_nw_warm']:.2f}x, K3 "
          f"{out['speedup_k3_warm']:.2f}x; band-NW edit ratio "
          f"{out['band_nw_edit_ratio']:.3f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m hinge_tpu_torch.bench.bench_window_dp",
        description=__doc__.splitlines()[0])
    ap.add_argument("n_windows", nargs="?", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    qs, ts = windows(args.n_windows)
    print(f"{args.n_windows} windows, device={dev} "
          f"(made in {time.perf_counter() - t0:.3f}s)", flush=True)
    out = run(qs, ts, device=dev)
    print(json.dumps({"window_dp": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
