"""Copied from hinge_tpu/io/fasta.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

FASTA/FASTQ reader-writer (reference: kseq.h macro library + loadFASTA,
LAInterface.cpp:4849-4870). Supports plain and gzip files."""

from __future__ import annotations

import gzip
from typing import Iterator, List, Optional, Tuple

import numpy as np

from hinge_tpu_torch.data.overlaps import INT, ReadStore, str_to_codes


def _open(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def iter_fastx(path: str) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Yield (name, seq, qual|None) records from FASTA or FASTQ."""
    with _open(path) as f:
        name = None
        seq_parts: List[str] = []
        first = f.read(1)
        if not first:
            return
        if first == "@":  # FASTQ
            line = f.readline()
            while True:
                header = line.rstrip("\n")
                seq = f.readline().rstrip("\n")
                f.readline()  # '+'
                qual = f.readline().rstrip("\n")
                yield header.split()[0], seq, qual
                nxt = f.readline()
                if not nxt:
                    return
                line = nxt[1:] if nxt.startswith("@") else nxt
        else:  # FASTA
            line = first + f.readline()
            while line:
                if line.startswith(">"):
                    if name is not None:
                        yield name, "".join(seq_parts), None
                    name = line[1:].rstrip("\n").split()[0] if line[1:].strip() else ""
                    # keep full header up to first whitespace like kseq
                    name = line[1:].rstrip("\n").split(None, 1)[0] if line[1:].strip() else ""
                    seq_parts = []
                else:
                    seq_parts.append(line.strip())
                line = f.readline()
            if name is not None:
                yield name, "".join(seq_parts), None


def read_fasta(path: str) -> ReadStore:
    """Load reads into a ReadStore (ids assigned in file order, like
    loadFASTA's `num` counter)."""
    names: List[str] = []
    lens: List[int] = []
    chunks: List[np.ndarray] = []
    for name, seq, _ in iter_fastx(path):
        names.append(name)
        lens.append(len(seq))
        chunks.append(str_to_codes(seq))
    n = len(names)
    length = np.asarray(lens, dtype=INT)
    bases_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(length, out=bases_off[1:])
    bases = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    return ReadStore(length=length, bases_off=bases_off, bases=bases, names=names)


def read_fasta_lengths(path: str) -> List[int]:
    """Sequence lengths only (no base decoding)."""
    return [len(seq) for _, seq, _ in iter_fastx(path)]


def fasta_to_fastq(fa_path: str, fq_path: str, qual: int = 40) -> int:
    """FASTA -> FASTQ with a static phred quality
    (reference scripts/fasta_to_fastq.py: phred 40 for every base).
    Returns the record count."""
    n = 0
    qchar = chr(qual + 33)
    with open(fq_path, "w") as fq:
        for name, seq, _ in iter_fastx(fa_path):
            fq.write(f"@{name}\n{seq}\n+\n{qchar * len(seq)}\n")
            n += 1
    return n


def write_fasta(path: str, records, width: int = 0) -> None:
    """records: iterable of (name, seq). width=0 writes one line per seq
    (matches the reference stage outputs)."""
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            if width <= 0:
                f.write(seq + "\n")
            else:
                for i in range(0, len(seq), width):
                    f.write(seq[i : i + width] + "\n")


def select_single_strand(in_path: str, out_path: str, mode: str = "even") -> int:
    """Keep one strand per contig pair from a draft/consensus FASTA.

    The draft-path stage writes each contig immediately followed by its
    reverse complement, so the single-strand file is every even-indexed
    record (reference: scripts/get_draft_path_norevcomp.py:8-11, the input
    to the norevcomp consensus flow of pipeline_consensus_norevcomp.py).

    mode="even"  — keep records 0, 2, 4, ... (the norevcomp filter).
    mode="first" — replicate scripts/get_single_strand.py:12-16 exactly: its
    counter only increments on a write, so after record 0 ('Consensus0') the
    parity test never passes again and only the FIRST record is emitted —
    a reference quirk kept verbatim for parity.

    Returns the number of records written.
    """
    if mode not in ("even", "first"):
        raise ValueError(f"mode must be 'even' or 'first', got {mode!r}")
    n = 0
    with open(out_path, "w") as f:
        if mode == "even":
            for i, (name, seq, _q) in enumerate(iter_fastx(in_path)):
                if i % 2 == 0:
                    f.write(f">{name}\n{seq}\n")
                    n += 1
        else:
            j = 0
            for name, seq, _q in iter_fastx(in_path):
                if j % 2 == 0:
                    f.write(f">Consensus{j}\n{seq}\n")
                    j += 1
                    n += 1
    return n


def correct_head(in_path: str, out_path: str, lookup_path: str) -> None:
    """Rewrite headers to the PacBio `m000_000/{zmw}/{start}_{end}` form that
    fasta2DB requires; drop sequences < 30bp as 'Deleted'
    (reference scripts/correct_head.py:6-31)."""
    with open(lookup_path, "w") as lk, open(out_path, "w") as out:
        for i, (name, seq, _) in enumerate(iter_fastx(in_path)):
            if len(seq) < 30:
                lk.write(f"{name}\tDeleted\n")
                continue
            new_header = f"m000_000/{i+1}/0_{len(seq)}"
            lk.write(f"{name}\t{new_header}\n")
            out.write(f">{new_header}\n{seq}\n")
