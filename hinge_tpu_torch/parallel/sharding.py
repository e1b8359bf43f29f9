"""Multi-device sharding of the record-stream ops: port of `hinge_tpu/parallel/sharding.py`.

The reference's only parallelism notion is `.las` partitioning by A-read id
(--mlas, filter.cpp:35-63) on one host.  The design shards the same way
across a device mesh:

    mesh axes:  ('reads', 'recs')
      reads — data-parallel over contiguous A-read ranges (the --mlas axis)
      recs  — parallel over overlap records *within* a read range

Each shard scatter-adds its record block into a local (reads_chunk, bins)
grid; a psum over 'recs' merges the partial pileups (the scatter-add is
associative); the bin-axis cumsum, mask runs and repeat annotation then run
data-parallel over 'reads'.  The per-read mask table, needed globally for
B-side overhang lookups during hinge calling, is all-gathered over 'reads'
at the end.  Trim/classify, GetMatchingPosition, hinge calling, the
per-(A,B) top-k and the window aligner are pure data parallelism over flat
shards; the consensus vote and the falcon tally end in one psum of their
tables.

JAX runs one `shard_map` body per device with the collectives inside it.
Here a `Mesh` is a grid of `torch.device`s (a device may repeat: logical
shards on one card, or N CPU shards), each body is split at its
collectives, and the collectives are `Mesh` methods:

- in one process, psum/pmax copy the shard tensors onto one device and
  combine them there (every value is an integer, so the order of the sum
  changes no bit), and all_gather concatenates the shards in mesh order;
- across processes (`process_mesh`), each process holds whole rows of the
  'reads' axis; a collective first combines this process's shards, then
  calls `torch.distributed.all_reduce` (SUM or MAX) or
  `all_gather_into_tensor` across the ranks.  A psum over 'recs' never
  leaves the process, because a row never spans two processes.

Shard inputs are host numpy arrays of the global shape (every process
holds the same), of which a process places only its own shards.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hinge_tpu_torch.device import resolve_device, to_device, to_host
from hinge_tpu_torch.ops import coverage as C

I32 = torch.int32
AXES = ("reads", "recs")


def _visible_devices(device) -> List[torch.device]:
    """Every device of `device`'s type: the CUDA cards, or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def shard_count(device) -> int:
    """The mesh size for `device`: HINGE_MESH_SHARDS when set (logical
    shards, round-robin over the devices of that type), else the number of
    visible devices of that type (one on the CPU)."""
    n = os.environ.get("HINGE_MESH_SHARDS", "")
    return int(n) if n else len(_visible_devices(device))


class Mesh:
    """A ('reads', 'recs') grid of torch devices.

    `devices` is this process's rows of the grid (all of it in one
    process); with `world` > 1 the global grid has `world` times as many
    'reads' rows, process `rank` holding rows rank*len(devices) onward."""

    axis_names = AXES

    def __init__(self, devices, *, rank: int = 0, world: int = 1,
                 distributed: bool = False):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or len({len(row) for row in grid}) != 1:
            raise ValueError("a mesh needs equal, non-empty rows of devices")
        self.devices = grid
        self.rank, self.world, self.distributed = rank, world, distributed
        self.row0 = rank * len(grid)
        self.shape = {"reads": len(grid) * world, "recs": len(grid[0])}
        self.home = grid[0][0]

    @property
    def size(self) -> int:
        return self.shape["reads"] * self.shape["recs"]

    def local_rows(self) -> range:
        return range(self.row0, self.row0 + len(self.devices))

    def device(self, r: int, s: int) -> torch.device:
        return self.devices[r - self.row0][s]

    def local_shards(self) -> List[Tuple[int, torch.device]]:
        """(flat shard index, device) of this process's shards, row-major."""
        S = self.shape["recs"]
        return [(r * S + s, self.device(r, s))
                for r in self.local_rows() for s in range(S)]

    # -- collectives -------------------------------------------------------

    @staticmethod
    def _combine(parts, op, dev):
        acc = parts[0].to(dev)
        for p in parts[1:]:
            p = p.to(dev)
            acc = acc + p if op == "sum" else torch.maximum(acc, p)
        return acc

    def psum_recs(self, parts, r: int):
        """psum over 'recs' of row r's shard tensors, on the row's first
        device (a row lies in one process)."""
        return self._combine(parts, "sum", self.device(r, 0))

    def pmax_recs(self, parts, r: int):
        return self._combine(parts, "max", self.device(r, 0))

    def psum_all(self, parts):
        """psum over every mesh axis of this process's shard tensors,
        replicated on `home`."""
        import torch.distributed as dist

        acc = self._combine(parts, "sum", self.home).contiguous()
        if self.distributed:
            dist.all_reduce(acc, op=dist.ReduceOp.SUM)
        return acc

    def _all_gather(self, local):
        import torch.distributed as dist

        if not self.distributed:
            return local
        is_bool = local.dtype == torch.bool
        x = (local.to(torch.uint8) if is_bool else local).contiguous()
        out = torch.empty((self.world * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out.bool() if is_bool else out

    def gather_reads(self, rows):
        """all_gather over 'reads' (tiled on axis 0) of this process's row
        tensors, in mesh order, on `home`."""
        return self._all_gather(torch.cat([x.to(self.home) for x in rows]))

    def gather_flat(self, shards):
        """Every shard's tensor stacked in flat mesh order, (size, ...), on
        `home`: the counterpart of reading a flat-sharded output."""
        return self._all_gather(torch.stack([x.to(self.home) for x in shards]))


def make_mesh(n_devices: Optional[int] = None, rec_axis: Optional[int] = None,
              *, device="cuda") -> Mesh:
    """2D ('reads', 'recs') mesh of `n_devices` shards (default
    `shard_count(device)`), round-robin over the devices of `device`'s
    type, in one process."""
    devs = _visible_devices(device)
    n = n_devices if n_devices is not None else shard_count(device)
    if rec_axis is None:
        # favor the reads axis; use a recs axis when n has a factor of 2
        rec_axis = 2 if n % 2 == 0 and n > 2 else 1
    if n < 1 or n % rec_axis:
        raise ValueError(f"cannot lay {n} shards out with rec_axis={rec_axis}")
    reads_axis = n // rec_axis
    flat = [devs[i % len(devs)] for i in range(n)]
    return Mesh([flat[r * rec_axis:(r + 1) * rec_axis] for r in range(reads_axis)])


def process_mesh(local_devices: Sequence, rec_axis: int = 1) -> Mesh:
    """The mesh across the processes of the initialised torch.distributed
    group: this process's `local_devices` form whole rows of the 'reads'
    axis (`rec_axis` shards each), rank-major.  Every process must own the
    same number of whole rows; any other layout raises ValueError."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise ValueError("process_mesh needs an initialised process group "
                         "(parallel.distributed.init_distributed)")
    devs = [torch.device(d) for d in local_devices]
    if not devs or len(devs) % rec_axis:
        raise ValueError(f"{len(devs)} local devices do not form whole rows "
                         f"of {rec_axis}")
    rows = len(devs) // rec_axis
    world = dist.get_world_size()
    mine = torch.tensor([rows, rec_axis], dtype=I32, device=devs[0])
    every = torch.empty(2 * world, dtype=I32, device=devs[0])
    dist.all_gather_into_tensor(every, mine)
    if not bool((every.view(world, 2) == mine).all()):
        raise ValueError("every process must own the same number of whole "
                         f"'reads' rows; got (rows, recs) per rank "
                         f"{every.view(world, 2).tolist()}")
    return Mesh([devs[r * rec_axis:(r + 1) * rec_axis] for r in range(rows)],
                rank=dist.get_rank(), world=world, distributed=True)


def shard_records(
    a_id: np.ndarray,
    a_start: np.ndarray,
    a_end: np.ndarray,
    n_reads: int,
    mesh: Mesh,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Partition records into (reads_shards, recs_shards, pad) blocks.

    Records go to the reads-shard owning their A read (contiguous read
    ranges), then round-robin over recs-shards; every block is padded to the
    max block size with sentinel rows (a_rel = reads_chunk, which lands in
    the grids' padding row).  Returns (a_rel, a_start, a_end) with shape
    (R, S, pad) plus the per-shard read-chunk size.
    """
    R = mesh.shape["reads"]
    S = mesh.shape["recs"]
    reads_chunk = -(-n_reads // R)
    shard_of_read = np.minimum(a_id // reads_chunk, R - 1)
    blocks = [[None] * S for _ in range(R)]
    maxlen = 1
    for r in range(R):
        rows = np.nonzero(shard_of_read == r)[0]
        for s in range(S):
            sel = rows[s::S]
            blocks[r][s] = sel
            maxlen = max(maxlen, len(sel))
    a_rel = np.full((R, S, maxlen), reads_chunk, dtype=np.int32)  # pad row
    a_s = np.zeros((R, S, maxlen), dtype=np.int32)
    a_e = np.zeros((R, S, maxlen), dtype=np.int32)
    for r in range(R):
        base = r * reads_chunk
        for s in range(S):
            sel = blocks[r][s]
            a_rel[r, s, : len(sel)] = a_id[sel] - base
            a_s[r, s, : len(sel)] = a_start[sel]
            a_e[r, s, : len(sel)] = a_end[sel]
    return a_rel, a_s, a_e, reads_chunk


def _local_grid(a_rel, a_start, a_end, cutoff, *, reads_chunk, nb, reso):
    """One shard's partial (reads_chunk, nb) event grid; the sentinel row
    reads_chunk is sliced off."""
    sb = C.event_bins(a_start + cutoff, reso, nb)
    eb = C.event_bins(a_end - cutoff, reso, nb)
    grid = torch.zeros((reads_chunk + 1) * (nb + 1), dtype=I32,
                       device=a_rel.device)
    row = a_rel.long() * (nb + 1)
    ones = torch.ones(a_rel.shape[0], dtype=I32, device=a_rel.device)
    grid.index_add_(0, row + sb.long(), ones)
    grid.index_add_(0, row + eb.long(), -ones)
    return grid.view(reads_chunk + 1, nb + 1)[:reads_chunk, :nb]


def _record_stats(mesh, shards, r, reads_chunk, reso, cut_off):
    """Row r's per-read n_entries (ne, ne_cut) from its shards' record
    stats, pmax/psum'd over 'recs'."""
    stats = [C.pileup_stats(a_rel, a_s, a_e, n_reads=reads_chunk)
             for a_rel, a_s, a_e in shards]
    me = mesh.pmax_recs([x[0] for x in stats], r)
    mstart = mesh.pmax_recs([x[1] for x in stats], r)
    cnt = mesh.psum_recs([x[2] for x in stats], r)
    ne = C.n_entries_from_max_event(me, cnt, reso)
    # clipped profile: start+cutoff events can exceed every end-cutoff
    ne_cut = C.n_entries_from_max_event(
        torch.maximum(me - cut_off, mstart + cut_off), cnt, reso)
    return ne, ne_cut


def _place_rows(mesh, a_rel, a_s, a_e):
    """{row: [(a_rel, a_start, a_end) on each shard's device]} for this
    process's rows of the (R, S, pad) blocks."""
    return {r: [tuple(to_device(x[r, s], mesh.device(r, s))
                      for x in (a_rel, a_s, a_e))
                for s in range(mesh.shape["recs"])]
            for r in mesh.local_rows()}


def sharded_filter_step(
    mesh: Mesh,
    *,
    reads_chunk: int,
    nb: int,
    reso: int = 40,
    cut_off: int = 300,
    min_cov: int = 5,
    coverage_fraction: int = 3,
    min_thresh: int = 10,
    max_thresh: int = 20,
    no_hinge_region: int = 500,
):
    """Build the multi-device filter step.

    The step takes host arrays of shape (R, S, pad) (records) and
    (R, reads_chunk) (read lengths) and returns (coverage, masks,
    annotations): coverage and annotations of this process's 'reads' rows
    (all rows in one process), masks of every read (all-gathered), as
    tensors on the mesh's first local device.
    """

    def step(a_rel, a_start, a_end, read_len):
        placed = _place_rows(mesh, a_rel, a_start, a_end)
        covs, masks, anns = [], [], []
        for r, shards in placed.items():
            # partial pileup grids + psum over the record axis
            g0 = mesh.psum_recs([_local_grid(*x, 0, reads_chunk=reads_chunk,
                                             nb=nb, reso=reso)
                                 for x in shards], r)
            gc = mesh.psum_recs([_local_grid(*x, cut_off,
                                             reads_chunk=reads_chunk,
                                             nb=nb, reso=reso)
                                 for x in shards], r)
            cov = torch.cumsum(g0, dim=1, dtype=I32)
            cov_cut = torch.cumsum(gc, dim=1, dtype=I32)
            ne, ne_cut = _record_stats(mesh, shards, r, reads_chunk, reso,
                                       cut_off)
            reduced = torch.clamp(cov_cut - min_cov, min=0)
            ms, mev, _, _ = C.coverage_mask(reduced, ne_cut, reso=reso)
            masks.append(torch.stack([ms, mev], dim=1))
            anns.append(C.repeat_annotation_mask(
                cov, ne, ms, mev, min_cov, reso=reso,
                coverage_fraction=coverage_fraction, min_thresh=min_thresh,
                max_thresh=max_thresh, no_hinge_region=no_hinge_region))
            covs.append(cov)
        home = mesh.home
        # global mask table for B-side overhang lookups (hinge calling)
        all_masks = mesh.gather_reads(masks)
        return (torch.cat([c.to(home) for c in covs]), all_masks,
                torch.cat([a.to(home) for a in anns]))

    return step


def run_sharded_filter(
    a_id: np.ndarray,
    a_start: np.ndarray,
    a_end: np.ndarray,
    read_len: np.ndarray,
    mesh: Mesh,
    nb: Optional[int] = None,
    **params,
):
    """Host-side wrapper: shard, place, and execute one filter step."""
    reso = params.get("reso", 40)
    if nb is None:
        nb = int(read_len.max()) // reso + 3
    step, args, reads_chunk = prepare_filter_step(a_id, a_start, a_end,
                                                  read_len, mesh, nb, **params)
    cov, masks, ann = step(*args)
    return cov, masks, ann, reads_chunk


def prepare_filter_step(a_id, a_start, a_end, read_len, mesh: Mesh, nb: int,
                        **params):
    """(step, its host arguments, reads a shard): the records sharded for
    `mesh` and the filter step built over it, so that the step can run
    again on the same arguments."""
    n_reads = len(read_len)
    a_rel, a_s, a_e, reads_chunk = shard_records(a_id, a_start, a_end, n_reads, mesh)
    R = mesh.shape["reads"]
    pad_reads = R * reads_chunk - n_reads
    rl = np.concatenate([read_len, np.zeros(pad_reads, read_len.dtype)]).reshape(
        R, reads_chunk
    )
    step = sharded_filter_step(mesh, reads_chunk=reads_chunk, nb=nb, **params)
    return step, (a_rel, a_s, a_e, rl), reads_chunk


def run_sharded_profiles(
    a_rel: np.ndarray, a_start: np.ndarray, a_end: np.ndarray,
    n_reads: int, mesh: Mesh,
    *, nb: int, reso: int, cut_off: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The filter stage's raw device profiles — (cov, cov_cut, ne, ne_cut)
    per read — computed over the mesh (record scatter + psum/pmax).  The
    scatter-adds are integer and associative, so the results equal the
    single-device `stages.filter._device_profiles`; used when
    HINGE_SHARDED=1 routes stage internals through the mesh."""
    a_rel3, a_s3, a_e3, reads_chunk = shard_records(
        a_rel, a_start, a_end, n_reads, mesh)
    out = {k: [] for k in ("cov", "cov_cut", "ne", "ne_cut")}
    for r, shards in _place_rows(mesh, a_rel3, a_s3, a_e3).items():
        def grid(cutoff):
            return mesh.psum_recs(
                [_local_grid(*x, cutoff, reads_chunk=reads_chunk, nb=nb,
                             reso=reso) for x in shards], r)

        out["cov"].append(torch.cumsum(grid(0), dim=1, dtype=I32))
        out["cov_cut"].append(torch.cumsum(grid(cut_off), dim=1, dtype=I32))
        ne, ne_cut = _record_stats(mesh, shards, r, reads_chunk, reso, cut_off)
        out["ne"].append(ne)
        out["ne_cut"].append(ne_cut)
    return tuple(to_host(mesh.gather_reads(out[k]))[:n_reads]
                 for k in ("cov", "cov_cut", "ne", "ne_cut"))


def stage_mesh(device) -> Optional[Mesh]:
    """The mesh stage internals use when HINGE_SHARDED=1 — None otherwise
    or when fewer than two shards exist (`shard_count`)."""
    if os.environ.get("HINGE_SHARDED", "0") != "1":
        return None
    if shard_count(device) < 2:
        return None
    return make_mesh(device=device)


# ---------------------------------------------------------------------------
# Sharded classify / trim lattice (maximal + layout device portion)
# ---------------------------------------------------------------------------


def _shard_overlap_tables(cols: dict, tw, n_dev: int):
    """Partition a batch of overlaps (+ flat trace-walk) into n_dev blocks.

    `cols` maps name -> int32 [n] per-overlap column.  Each shard gets
    `chunk` real/zero-padded overlap rows plus ONE sentinel row (index
    `chunk`) that absorbs flat-point padding, so every shard has identical
    shapes: rows = chunk+1, points = pad_pts, pairs = pad_pts-chunk-1
    (each row contributes npairs+1 points).  Returns (tables, meta) where
    tables holds (n_dev, ...) arrays.
    """
    from hinge_tpu_torch.ops import classify as CL

    n = len(next(iter(cols.values())))
    chunk = max(1, -(-n // n_dev))
    npairs = tw.npairs
    total_pairs_at = np.append(tw.pair_off, tw.pair_off[-1] + npairs[-1]) if n else np.zeros(1, np.int64)

    # per-shard real counts and point totals
    n_real = np.array([max(0, min(n - r * chunk, chunk)) for r in range(n_dev)])
    pts_real = np.zeros(n_dev, dtype=np.int64)
    for r in range(n_dev):
        r0, r1 = r * chunk, r * chunk + n_real[r]
        if n_real[r]:
            pts_real[r] = int(npairs[r0:r1].sum()) + n_real[r]
    # zero-filled rows contribute 1 point each; +1 so sentinel has >=1 point
    pad_pts = int((pts_real + (chunk - n_real)).max()) + 1
    pad_pairs = pad_pts - (chunk + 1)

    names = list(cols)
    out = {k: np.zeros((n_dev, chunk + 1), dtype=np.int32) for k in names}
    np_l = np.zeros((n_dev, chunk + 1), dtype=np.int32)
    po_l = np.zeros((n_dev, chunk + 1), dtype=np.int64)
    cum_l = np.zeros((n_dev, max(pad_pairs, 1)), dtype=np.int32)
    seg_l = np.zeros((n_dev, pad_pts), dtype=np.int32)
    k_l = np.zeros((n_dev, pad_pts), dtype=np.int32)

    for r in range(n_dev):
        r0 = r * chunk
        m = n_real[r]
        if m:
            for k in names:
                out[k][r, :m] = cols[k][r0 : r0 + m]
            np_l[r, :m] = npairs[r0 : r0 + m]
            gp0 = tw.pair_off[r0]
            gp1 = total_pairs_at[r0 + m]
            po_l[r, :m] = tw.pair_off[r0 : r0 + m] - gp0
            cum_l[r, : gp1 - gp0] = tw.cum[gp0:gp1]
            real_pairs = int(gp1 - gp0)
        else:
            real_pairs = 0
        # sentinel row absorbs remaining points
        sent_pts = pad_pts - (int(np_l[r, :chunk].sum()) + chunk)
        np_l[r, chunk] = sent_pts - 1
        po_l[r, chunk] = real_pairs
        seg_id, k_local, _ = CL.make_point_index(np_l[r])
        seg_l[r] = seg_id
        k_l[r] = k_local

    tables = dict(out)
    tables.update(npairs=np_l, pair_off=po_l, cum=cum_l, seg_id=seg_l, k_local=k_l)
    return tables, dict(n=n, chunk=chunk, n_dev=n_dev)


def _flat_outputs(mesh, per_shard, n, chunk):
    """Stack each output over the flat shards and drop the sentinel and
    padding rows: numpy arrays in input order."""
    return tuple(
        to_host(mesh.gather_flat(list(o)))[:, :chunk].reshape(-1)[:n]
        for o in zip(*per_shard))


def run_sharded_classify(
    a_start, a_end, b_start, b_end, rc,
    ears, eare, ebrs, ebre,
    tw,
    mesh: Mesh,
    *,
    tspace: int,
    aln_threshold: int,
    theta: int,
    theta2: int,
):
    """Sharded batched ProcessAlignment (trim_overlap + AddTypesAsymmetric +
    length filter, maximal.cpp:65-134) over the full device mesh.

    eff-mask values (`ears..ebre`) are per-overlap gathers done host-side.
    Returns numpy (eams, eame, ebms, ebme, active, mtype) in input order,
    equal to the single-device ops.
    """
    from hinge_tpu_torch.ops import classify as CL

    n_dev = mesh.size
    cols = dict(
        a_s=a_start, a_e=a_end, b_s=b_start, b_e=b_end, rc=rc,
        ears=ears, eare=eare, ebrs=ebrs, ebre=ebre,
    )
    tables, meta = _shard_overlap_tables(cols, tw, n_dev)
    order = ("a_s", "a_e", "b_s", "b_e", "rc", "ears", "eare", "ebrs", "ebre",
             "npairs", "pair_off", "cum", "seg_id", "k_local")
    per_shard = []
    for i, dev in mesh.local_shards():
        (a_s, a_e, b_s, b_e, rc_, ears_, eare_, ebrs_, ebre_, npairs,
         pair_off, cum, seg_id, k_local) = (to_device(tables[k][i], dev)
                                            for k in order)
        eams, eame, ebms, ebme, act = CL.trim_overlaps(
            a_s, a_e, b_s, b_e, rc_, ears_, eare_, ebrs_, ebre_,
            npairs, pair_off, cum, seg_id, k_local, tspace=tspace,
        )
        too_short = ((ebme - ebms) < aln_threshold) | ((eame - eams) < aln_threshold)
        active = act & ~too_short
        mtype = CL.add_types_asymmetric(
            eams, eame, ebms, ebme, ears_, eare_, ebrs_, ebre_, rc_, theta, theta2
        )
        mtype = torch.where(active, mtype, CL.NOT_ACTIVE).to(I32)
        per_shard.append((eams, eame, ebms, ebme, active, mtype))
    return _flat_outputs(mesh, per_shard, meta["n"], meta["chunk"])


def run_sharded_matching_position(
    ov_idx, pos_a,
    a_start, a_end, b_start, b_end, rc,
    tw,
    mesh: Mesh,
    *,
    tspace: int,
):
    """Sharded batched GetMatchingPosition (LAInterface.cpp:4498-4546).

    Overlap tables shard by contiguous row ranges; each query is routed to
    the shard owning its overlap and its `ov_idx` remapped to a local index.
    Returns int32 results in the input query order, equal to
    `ops.classify.matching_position`.
    """
    from hinge_tpu_torch.ops import classify as CL

    n_dev = mesh.size
    cols = dict(a_s=a_start, a_e=a_end, b_s=b_start, b_e=b_end, rc=rc)
    tables, meta = _shard_overlap_tables(cols, tw, n_dev)
    chunk = meta["chunk"]

    nq = len(ov_idx)
    owner = np.minimum(np.asarray(ov_idx, dtype=np.int64) // chunk, n_dev - 1)
    per = np.bincount(owner, minlength=n_dev)
    qpad = max(1, int(per.max()))
    q_idx = np.full((n_dev, qpad), chunk, dtype=np.int32)  # sentinel row
    q_pos = np.zeros((n_dev, qpad), dtype=np.int32)
    slot_src = np.zeros((n_dev, qpad), dtype=np.int64)
    fill = np.zeros(n_dev, dtype=np.int64)
    for qi in range(nq):
        r = owner[qi]
        s = fill[r]
        q_idx[r, s] = ov_idx[qi] - r * chunk
        q_pos[r, s] = pos_a[qi]
        slot_src[r, s] = qi
        fill[r] = s + 1

    order = ("a_s", "a_e", "b_s", "b_e", "rc", "npairs", "pair_off", "cum")
    shards = []
    for i, dev in mesh.local_shards():
        args = [to_device(tables[k][i], dev) for k in order]
        shards.append(CL.matching_position(
            to_device(q_idx[i], dev), to_device(q_pos[i], dev), *args,
            tspace=tspace))
    res = to_host(mesh.gather_flat(shards))
    out = np.zeros(nq, dtype=np.int32)
    for r in range(n_dev):
        m = int(fill[r])
        out[slot_src[r, :m]] = res[r, :m]
    return out


def run_sharded_hinge_call(
    pos_a, grad, m0, m1, rid,
    ams, ame, lov, rov, valid,
    mesh: Mesh,
    *, theta: int, htl: int, hbl: int, hrut: int, hbpt: int,
):
    """Sharded hinge calling (filter.cpp:838-1070): the (read, annotation)
    task rows shard over the flat mesh; the per-read padded pileup tables
    are replicated (every task reads only its own read's row, so there is
    no cross-shard term).  Equal to ops.hinge_call._hinge_kernel."""
    from hinge_tpu_torch.ops.hinge_call import _hinge_kernel

    n_dev = mesh.size
    T = len(pos_a)
    tpad = ((T + n_dev - 1) // n_dev) * n_dev
    chunk = tpad // n_dev

    def _pad2(x, fill=0):
        out = np.full(tpad, fill, np.asarray(x).dtype)
        out[:T] = x
        return out.reshape(n_dev, chunk)

    tasks = [_pad2(np.asarray(x, np.int32)) for x in (pos_a, grad, m0, m1, rid)]
    tables = [np.asarray(x) for x in (ams, ame, lov, rov, valid)]
    per_shard = []
    for i, dev in mesh.local_shards():
        b, s = _hinge_kernel(
            *(to_device(x[i], dev) for x in tasks),
            *(to_device(x, dev) for x in tables),
            theta=theta, htl=htl, hbl=hbl, hrut=hrut, hbpt=hbpt,
        )
        per_shard.append((b, s))
    b, s = (to_host(mesh.gather_flat(list(o))) for o in zip(*per_shard))
    return b.reshape(-1)[:T], s.reshape(-1)[:T]


def sharded_top_k_per_pair(ov, k: int, n_shards: int) -> np.ndarray:
    """Per-(A,B) top-k selection partitioned at A-read boundaries.

    Mirrors the reference's --mlas sharding (records sorted by a_id,
    processed part by part): shard boundaries snap to a_id changes so no
    read's pair groups split, making per-shard `top_k_per_pair` results
    concatenate into exactly the global emission order (a ascending, then
    per-a unordered_map order — both shard-local properties).
    """
    from hinge_tpu_torch.ops.pairs import top_k_per_pair

    n = ov.n
    if n == 0 or n_shards <= 1:
        return top_k_per_pair(ov, k)
    cuts = [0]
    for s in range(1, n_shards):
        c = s * n // n_shards
        # snap forward to the next a_id boundary
        while c < n and c > 0 and ov.a_id[c] == ov.a_id[c - 1]:
            c += 1
        if c > cuts[-1]:
            cuts.append(c)
    cuts.append(n)
    parts = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi <= lo:
            continue
        sub = ov.take(np.arange(lo, hi))
        parts.append(top_k_per_pair(sub, k) + lo)
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


def run_sharded_wave_align(mesh: Mesh, qs, ts, band_tolerance: int = 150):
    """Draft-stage window aligner with the window batch sharded over the
    mesh — pure data parallelism on the batch axis of the DW_banded-exact
    wave (ops/wavefront.py): the batch is padded to a multiple of the shard
    count and cut into one contiguous block per shard, each block runs the
    forward wave + backtrack on its shard's device (K3 on CUDA), and the
    path points are gathered for the host's row emission.  Rows come back
    equal to align_exact_batch_device.
    """
    from hinge_tpu_torch.ops import wavefront as W

    B = len(qs)
    if B == 0:
        return []
    n_dev = mesh.size
    pad = (-B) % n_dev
    qs_p = list(qs) + [np.zeros(0, np.uint8)] * pad
    ts_p = list(ts) + [np.zeros(0, np.uint8)] * pad
    # one padded batch and one max_d for every shard, as hinge_tpu's
    q, t, m, n, max_d, kb = W.pack_block(qs_p, ts_p, band_tolerance)
    per = len(qs_p) // n_dev
    per_shard = []
    for i, dev in mesh.local_shards():
        sl = slice(i * per, (i + 1) * per)
        per_shard.append(W.wave_align(
            to_device(q[sl], dev), to_device(t[sl], dev),
            to_device(m[sl], dev), to_device(n[sl], dev), band_tolerance,
            max_d=max_d, kb=kb))
    px, py, aligned, d_fin, _, _ = (
        to_host(mesh.gather_flat(list(o))).reshape(len(qs_p), -1)
        for o in zip(*per_shard))
    aligned_h = aligned[:, 0]
    npts = 2 * (d_fin[:, 0] + 1)
    both_empty = (m == 0) & (n == 0)
    aligned_h = aligned_h | both_empty
    npts = np.where(both_empty, 0, npts)
    rows = W._emit_rows_batch(qs_p, ts_p, px, py, npts, aligned_h)
    return rows[:B]


def run_sharded_falcon_tally(mesh: Mesh, rows: np.ndarray, t_len: int):
    """The device-shardable half of the falcon consensus vote: per-column
    coverage tallies of one window's align-tag rows (falcon.c:346-352),
    rows sharded over the mesh, per-shard count, table psum'd across the
    mesh.  The link DP that consumes the tallies is sequential per column
    (strict `>` tie-break over stream-ordered links, falcon.c:366-520) and
    stays host-side by design — this covers the O(rows) half that scales
    with pileup depth.
    """
    n_dev = mesh.size
    d0 = rows[rows[:, 1] == 0, 0]
    d0 = d0[(d0 >= 0) & (d0 < t_len)].astype(np.int32)
    pad = (-len(d0)) % max(n_dev, 1)
    d0p = np.concatenate([d0, np.full(pad, -1, np.int32)]).reshape(n_dev, -1)
    tables = []
    for i, dev in mesh.local_shards():
        d = to_device(d0p[i], dev)
        ok = (d >= 0) & (d < t_len)
        cov = torch.zeros(t_len, dtype=I32, device=dev)
        cov.index_add_(0, d[ok].long(), torch.ones_like(d[ok]))
        tables.append(cov)
    return to_host(mesh.psum_all(tables)).astype(np.int64)
