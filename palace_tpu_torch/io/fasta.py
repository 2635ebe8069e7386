"""FASTA/FASTQ reading and writing (plain or gzip-compressed input), and
samtools-style ``.fai`` random access to a FASTA by row and name."""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Tuple

_COMPLEMENT = bytes.maketrans(
    b"ACGTacgtRYSWKMBDHVNryswkmbdhvn",
    b"TGCAtgcaYRSWMKVHDBNyrswmkvhdbn",
)


def reverse_complement(seq: str) -> str:
    """Reverse complement, preserving case; IUPAC codes complement too."""
    return seq.encode()[::-1].translate(_COMPLEMENT).decode()


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


def read_fasta_dict(path: str | Path) -> Dict[str, str]:
    return dict(iter_fasta(path))


def iter_fastq(path: str | Path) -> Iterator[Tuple[str, str, str]]:
    """Yield ``(name, sequence, quality)`` from a FASTQ file (optionally gzip);
    the name stops at the first ``/``, space or tab."""
    with _open_text(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            seq = fh.readline().rstrip("\n")
            fh.readline()  # '+'
            qual = fh.readline().rstrip("\n")
            name = header[1:].rstrip("\n")
            for delim in ("/", " ", "\t"):
                idx = name.find(delim)
                if idx >= 0:
                    name = name[:idx]
            yield name, seq, qual


def write_fasta(path: str | Path, records: Iterable[Tuple[str, str]],
                width: int = 0) -> None:
    """Write ``(name, sequence)`` records, wrapped at ``width`` if > 0."""
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            if width and width > 0:
                for i in range(0, len(seq), width):
                    fh.write(seq[i : i + width] + "\n")
            else:
                fh.write(seq + "\n")


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int
    linebases: int
    linewidth: int


class FastaIndex:
    """samtools-compatible ``.fai``: name, length, offset, linebases, linewidth."""

    def __init__(self, entries: List[FaiEntry]):
        self.entries = entries
        self.by_name: Dict[str, FaiEntry] = {e.name: e for e in entries}

    @classmethod
    def read(cls, path: str | Path) -> "FastaIndex":
        entries = []
        with open(path) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if len(f) >= 5:
                    entries.append(FaiEntry(f[0], int(f[1]), int(f[2]), int(f[3]), int(f[4])))
                elif len(f) >= 2:
                    entries.append(FaiEntry(f[0], int(f[1]), 0, 0, 0))
        return cls(entries)

    def write(self, path: str | Path) -> None:
        with open(path, "w") as fh:
            for e in self.entries:
                fh.write(f"{e.name}\t{e.length}\t{e.offset}\t{e.linebases}\t{e.linewidth}\n")

    def lengths(self) -> Dict[str, int]:
        return {e.name: e.length for e in self.entries}

    def name_by_row(self, row_1based: int) -> str:
        """1-based fai row → sequence name (get_ref_by_index.py:40-49)."""
        return self.entries[row_1based - 1].name


def build_fai(fasta_path: str | Path, fai_path: str | Path | None = None) -> FastaIndex:
    """Build and write a samtools-compatible index of an uncompressed FASTA."""
    entries: List[FaiEntry] = []
    with open(fasta_path, "rb") as fh:
        name = None
        length = offset = linebases = linewidth = 0
        first_line = True
        while True:
            raw = fh.readline()
            if not raw:
                break
            if raw.startswith(b">"):
                if name is not None:
                    entries.append(FaiEntry(name, length, offset, linebases, linewidth))
                name = raw[1:].split()[0].decode() if len(raw) > 1 else ""
                length = 0
                offset = fh.tell()
                first_line = True
            elif name is not None:
                stripped = raw.rstrip(b"\r\n")
                if first_line and stripped:
                    linebases = len(stripped)
                    linewidth = len(raw)
                    first_line = False
                length += len(stripped)
        if name is not None:
            entries.append(FaiEntry(name, length, offset, linebases, linewidth))
    index = FastaIndex(entries)
    index.write(fai_path if fai_path is not None else str(fasta_path) + ".fai")
    return index


class FastaStore:
    """Random access to FASTA sequences by name through the ``.fai``
    offsets (built beside the FASTA when missing)."""

    def __init__(self, fasta_path: str | Path):
        self.path = str(fasta_path)
        fai = Path(self.path + ".fai")
        self.index = FastaIndex.read(fai) if fai.exists() else build_fai(self.path)
        self._fh = open(self.path, "rb")

    def close(self) -> None:
        self._fh.close()

    def __contains__(self, name: str) -> bool:
        return name in self.index.by_name

    def names(self) -> List[str]:
        return [e.name for e in self.index.entries]

    def length(self, name: str) -> int:
        return self.index.by_name[name].length

    def fetch(self, name: str) -> str:
        e = self.index.by_name[name]
        self._fh.seek(e.offset)
        if e.linebases <= 0:
            raw = self._fh.read().split(b">")[0]
            return raw.replace(b"\n", b"").replace(b"\r", b"").decode()[: e.length]
        full_lines = e.length // e.linebases
        rem = e.length - full_lines * e.linebases
        raw = self._fh.read(full_lines * e.linewidth + rem)
        return raw.replace(b"\r", b"").replace(b"\n", b"").decode()

    def fetch_oriented(self, token: str) -> str:
        """Fetch by oriented token ``NAME+``/``NAME-`` (or bare name).

        Falls back to dropping the last ``_`` part like
        make_fa_from_path.py:36-39 when the name is missing.
        """
        token = token.replace(" ", "").strip()
        orient = "+"
        name = token
        if token and token[-1] in "+-":
            orient = token[-1]
            name = token[:-1]
        if not name:
            return ""
        if name not in self.index.by_name:
            fallback = "_".join(name.split("_")[:-1])
            if fallback in self.index.by_name:
                name = fallback
            else:
                raise KeyError(name)
        seq = self.fetch(name)
        return reverse_complement(seq) if orient == "-" else seq
