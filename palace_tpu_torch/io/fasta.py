"""FASTA reading and writing (plain or gzip-compressed input)."""
from __future__ import annotations

import gzip
import io
from pathlib import Path
from typing import Iterable, Iterator, List, Tuple


def _open_text(path: str | Path):
    path = str(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def iter_fasta(path: str | Path) -> Iterator[Tuple[str, str]]:
    """Yield ``(name, sequence)``; name is the first whitespace token."""
    name = None
    chunks: List[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif name is not None:
                chunks.append(line.strip())
    if name is not None:
        yield name, "".join(chunks)


def write_fasta(path: str | Path, records: Iterable[Tuple[str, str]],
                width: int = 0) -> None:
    """Write ``(name, sequence)`` records, wrapped at ``width`` if > 0."""
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            if width > 0:
                for i in range(0, len(seq), width):
                    fh.write(seq[i : i + width] + "\n")
            else:
                fh.write(seq + "\n")
