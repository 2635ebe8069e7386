"""BGZF/BAM reading and writing, dependency-free.

The reference links htslib (generate_graph.cpp:1) and shells out to
samtools for depth (palace:541).  This module provides:

* a BGZF block reader/writer (zlib raw-deflate with the BC extra field),
* a BAM record parser exposing the fields the pipeline needs
  (flag, tid, pos, mapq, CIGAR, mate info, NM/SA tags),
* a minimal BAM writer used by tests and ``chip_smoke.py`` to fabricate
  alignments.

It doubles as the pure-Python fallback for the C++ reader of
``palace_tpu_torch/native/bamgraph.cpp`` and as the oracle that reader is
tested against.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

CIGAR_OPS = "MIDNSHP=X"
_CONSUMES_REF = set("MDN=X")
_CONSUMES_READ = set("MIS=X")

FLAG_PAIRED = 0x1
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

_SEQ_CODES = "=ACMGRSVTWYHKDBN"


# ---------------------------------------------------------------------------
# BGZF
# ---------------------------------------------------------------------------

def bgzf_decompress(path: str | Path) -> bytes:
    """Concatenated-gzip decode (BGZF is a valid multi-member gzip)."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos < len(data):
        d = zlib.decompressobj(wbits=zlib.MAX_WBITS | 16)
        out.append(d.decompress(data[pos:]))
        consumed = len(data) - pos - len(d.unused_data)
        if consumed <= 0:
            break
        pos += consumed
    return b"".join(out)


def bgzf_compress_block(payload: bytes) -> bytes:
    """One BGZF block (≤64 KiB payload)."""
    compressor = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = compressor.compress(payload) + compressor.flush()
    bsize = len(cdata) + 25  # header(18) + cdata + crc(4) + isize(4), minus 1
    header = struct.pack(
        "<BBBBIBBHBBHH",
        31, 139, 8, 4,  # gzip magic, deflate, FEXTRA
        0, 0, 255,      # mtime, xfl, os
        6,              # xlen
        66, 67, 2,      # 'B','C', slen
        bsize,
    )
    return header + cdata + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def bgzf_write(path: str | Path, payload: bytes) -> None:
    with open(path, "wb") as fh:
        for i in range(0, len(payload), 60000):
            fh.write(bgzf_compress_block(payload[i : i + 60000]))
        if not payload:
            fh.write(bgzf_compress_block(b""))
        fh.write(BGZF_EOF)


# ---------------------------------------------------------------------------
# BAM records
# ---------------------------------------------------------------------------

@dataclass
class BamRecord:
    name: str
    flag: int
    tid: int
    pos: int          # 0-based leftmost
    mapq: int
    cigar: List[Tuple[int, str]]  # [(len, op), ...]
    mtid: int
    mpos: int
    tlen: int
    seq_len: int
    tags: Dict[str, object] = field(default_factory=dict)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAP)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    def cigar_string(self) -> str:
        return "".join(f"{n}{op}" for n, op in self.cigar)

    def ref_len(self) -> int:
        return sum(n for n, op in self.cigar if op in _CONSUMES_REF)

    def read_len(self) -> int:
        return sum(n for n, op in self.cigar if op in _CONSUMES_READ)

    def match_len(self) -> int:
        return sum(n for n, op in self.cigar if op in "M=X")


@dataclass
class BamFile:
    references: List[Tuple[str, int]]
    records: List[BamRecord]

    def name_to_tid(self) -> Dict[str, int]:
        return {name: i for i, (name, _) in enumerate(self.references)}


def _parse_aux(data: bytes) -> Dict[str, object]:
    tags: Dict[str, object] = {}
    i = 0
    n = len(data)
    while i + 3 <= n:
        tag = data[i : i + 2].decode()
        typ = chr(data[i + 2])
        i += 3
        if typ == "A":
            tags[tag] = chr(data[i]); i += 1
        elif typ == "c":
            tags[tag] = struct.unpack_from("<b", data, i)[0]; i += 1
        elif typ == "C":
            tags[tag] = struct.unpack_from("<B", data, i)[0]; i += 1
        elif typ == "s":
            tags[tag] = struct.unpack_from("<h", data, i)[0]; i += 2
        elif typ == "S":
            tags[tag] = struct.unpack_from("<H", data, i)[0]; i += 2
        elif typ == "i":
            tags[tag] = struct.unpack_from("<i", data, i)[0]; i += 4
        elif typ == "I":
            tags[tag] = struct.unpack_from("<I", data, i)[0]; i += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", data, i)[0]; i += 4
        elif typ in ("Z", "H"):
            end = data.index(b"\x00", i)
            tags[tag] = data[i:end].decode()
            i = end + 1
        elif typ == "B":
            sub = chr(data[i]); cnt = struct.unpack_from("<I", data, i + 1)[0]
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            i += 5 + cnt * size
            tags[tag] = None  # arrays unused by the pipeline
        else:
            break
    return tags


def _parse_record(data, off: int, end: int) -> BamRecord:
    (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, mtid, mpos, tlen) = (
        struct.unpack_from("<iiBBHHHiiii", data, off)
    )
    p = off + 32
    name = bytes(data[p : p + l_read_name - 1]).decode()
    p += l_read_name
    cigar = []
    for _ in range(n_cigar):
        (v,) = struct.unpack_from("<I", data, p)
        cigar.append((v >> 4, CIGAR_OPS[v & 0xF]))
        p += 4
    p += (l_seq + 1) // 2  # seq
    p += l_seq  # qual
    tags = _parse_aux(bytes(data[p:end]))
    return BamRecord(name, flag, tid, pos, mapq, cigar, mtid, mpos, tlen, l_seq, tags)


class BamStream:
    """Constant-memory BAM record iterator.

    The reference streams one ``sam_read1`` at a time
    (generate_graph.cpp:644); this is the Python equivalent —
    BGZF members are decompressed incrementally from bounded file
    chunks and complete records are parsed off a rolling buffer that is
    compacted as it is consumed, so a 50 Gbp metagenome BAM never
    inflates into host memory.

    ``references`` is parsed eagerly; iterate the object for records.
    """

    _CHUNK = 256 << 10   # compressed bytes per file read
    _MAX_OUT = 1 << 20   # decompressed bytes per _fill (bounds the buffer
                         # even when the BAM compresses 20×)

    def __init__(self, path: str | Path):
        self._fh = open(path, "rb")
        self._decomp = zlib.decompressobj(wbits=zlib.MAX_WBITS | 16)
        self._buf = bytearray()
        self._comp = b""   # compressed bytes not yet decompressed
        self._off = 0
        self._eof = False
        if not self._need(8) or bytes(self._buf[:4]) != b"BAM\x01":
            self._fh.close()
            raise ValueError(f"{path}: not a BAM file")
        self._off = 4
        l_text = self._read_i32()
        self._skip(l_text)
        n_ref = self._read_i32()
        refs: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            l_name = self._read_i32()
            if not self._need(l_name + 4):
                raise ValueError(f"{path}: truncated BAM header")
            name = bytes(self._buf[self._off : self._off + l_name - 1]).decode()
            self._off += l_name
            refs.append((name, self._read_i32()))
        self.references: List[Tuple[str, int]] = refs

    # -- buffer management --------------------------------------------------
    def _fill(self) -> bool:
        """Decompress up to _MAX_OUT more payload bytes into the buffer;
        False at stream end.  Output is capped so a highly-compressible
        BAM can't inflate the rolling buffer."""
        produced = 0
        while produced == 0:
            if not self._comp:
                if self._eof:
                    return False
                self._comp = self._fh.read(self._CHUNK)
                if not self._comp:
                    self._eof = True
                    return False
            out = self._decomp.decompress(self._comp, self._MAX_OUT)
            produced += len(out)
            self._buf += out
            if self._decomp.eof:  # next BGZF member follows
                self._comp = self._decomp.unused_data
                self._decomp = zlib.decompressobj(wbits=zlib.MAX_WBITS | 16)
            else:
                self._comp = self._decomp.unconsumed_tail
        return True

    def _need(self, n: int) -> bool:
        while len(self._buf) - self._off < n:
            if self._off > self._CHUNK:  # compact consumed prefix
                del self._buf[: self._off]
                self._off = 0
            if not self._fill():
                return False
        return True

    def _read_i32(self) -> int:
        if not self._need(4):
            raise ValueError("truncated BAM")
        (v,) = struct.unpack_from("<i", self._buf, self._off)
        self._off += 4
        return v

    def _skip(self, n: int) -> None:
        if not self._need(n):
            raise ValueError("truncated BAM")
        self._off += n

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[BamRecord]:
        while True:
            if not self._need(4):
                # Clean EOF only when the stream ends exactly on a record
                # boundary; 1-3 leftover bytes (or undrained compressed
                # input) mean the file was cut mid-stream — htslib reports
                # this as truncation, and so do we.
                leftover = len(self._buf) - self._off
                if leftover or self._comp:
                    self.close()
                    raise ValueError(
                        f"truncated BAM: {leftover} trailing bytes before "
                        "a record's block_size field"
                    )
                self.close()
                return
            (block_size,) = struct.unpack_from("<i", self._buf, self._off)
            self._off += 4
            if not self._need(block_size):
                self.close()
                raise ValueError("truncated BAM record")
            rec = _parse_record(self._buf, self._off, self._off + block_size)
            self._off += block_size
            yield rec

    def name_to_tid(self) -> Dict[str, int]:
        return {name: i for i, (name, _) in enumerate(self.references)}

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "BamStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_bam(path: str | Path) -> BamFile:
    """Whole-file parse (oracle/tests); the pipeline paths stream via
    :class:`BamStream` instead."""
    with BamStream(path) as s:
        return BamFile(references=s.references, records=list(s))


# ---------------------------------------------------------------------------
# writer (tests / fixtures)
# ---------------------------------------------------------------------------

def _encode_aux(tags: Dict[str, object]) -> bytes:
    out = b""
    for tag, val in tags.items():
        if isinstance(val, int):
            out += tag.encode() + b"i" + struct.pack("<i", val)
        elif isinstance(val, str) and len(val) == 1 and tag == "XA":
            out += tag.encode() + b"A" + val.encode()
        elif isinstance(val, str):
            out += tag.encode() + b"Z" + val.encode() + b"\x00"
        elif isinstance(val, float):
            out += tag.encode() + b"f" + struct.pack("<f", val)
    return out


def write_bam(path: str | Path, bam: BamFile, text: str = "") -> None:
    body = bytearray(b"BAM\x01")
    body += struct.pack("<i", len(text)) + text.encode()
    body += struct.pack("<i", len(bam.references))
    for name, length in bam.references:
        body += struct.pack("<i", len(name) + 1) + name.encode() + b"\x00"
        body += struct.pack("<i", length)
    for r in bam.records:
        name_b = r.name.encode() + b"\x00"
        cigar_b = b"".join(
            struct.pack("<I", (n << 4) | CIGAR_OPS.index(op)) for n, op in r.cigar
        )
        l_seq = r.seq_len
        seq_b = b"\x00" * ((l_seq + 1) // 2)
        qual_b = b"\xff" * l_seq
        aux = _encode_aux(r.tags)
        rec = struct.pack(
            "<iiBBHHHiiii",
            r.tid, r.pos, len(name_b), r.mapq, 0, len(r.cigar), r.flag,
            l_seq, r.mtid, r.mpos, r.tlen,
        ) + name_b + cigar_b + seq_b + qual_b + aux
        body += struct.pack("<i", len(rec)) + rec
    bgzf_write(path, body)
