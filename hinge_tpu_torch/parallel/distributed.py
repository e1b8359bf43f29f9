"""Multi-process initialisation: port of `hinge_tpu/parallel/distributed.py`.

The reference has no distributed runtime; the design shards overlap
records by A-read ranges across processes exactly like `--mlas` parts
map to sequential single-host runs.  This module joins the processes into
one `torch.distributed` group (NCCL for CUDA, gloo for the CPU) and hands
each its read range; the collectives of `parallel.sharding` then run over
a ('reads', 'recs') mesh whose 'reads' rows are spread over the
processes (`sharding.process_mesh`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> Tuple[int, int]:
    """Join the process group; returns (rank, world).

    Without `num_processes` it is a no-op and returns (0, 1).  Given a
    coordinator ("host:port"), a process count (1 included) and this
    process's id, it calls `torch.distributed.init_process_group` with
    NCCL when `device` is CUDA and gloo when it is the CPU."""
    import torch.distributed as dist

    if num_processes is None:
        return 0, 1
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def host_read_range(n_reads: int, process_index: int, process_count: int) -> Tuple[int, int]:
    """Contiguous A-read range owned by this host (the --mlas axis)."""
    chunk = -(-n_reads // process_count)
    lo = process_index * chunk
    hi = min(lo + chunk, n_reads)
    return lo, hi
