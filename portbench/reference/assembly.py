"""What the graph path has to recover from a sample with planted phages, in
plain Python.

Junctions: a planted genome cut into contigs ``m1, m2, ..., mn`` in its
order joins each contig's end to the next one's start, and a circular
genome ``mn`` to ``m1`` as well, every contig read forward.  A junction
is keyed as the junction graph writes it (generate_graph.cpp's map key):
``(left, left orientation, right, right orientation)`` with the smaller
name on the left, orientations flipped and swapped where the names are.

Genomes: a record of the final FASTA holds a planted genome when its
bases, with every run of N taken out (the final FASTA joins a path's
contigs with N), equal the genome's, or its reverse complement's; for a
circular genome, up to rotation as well.

Records: PALACE's final FASTA holds each planted genome once, and each
contig outside them that passes its last gates on its own, as
filter_cycle_gene_score.py and corrected_dup.py set them: more than
MIN_LEN bases, and a phage probability at the score gate or above (no
contig outside a genome has a protein hit here).  corrected_dup.py then
keeps one of any two records whose sets of distinct contig lengths
share 90 % of either's sum (its is_similar, :412-423), the one with the
larger sum: a lone contig as long as a contig of a genome, or as another
lone contig, is one record with it.  A contig whose probability lies
within ``margin`` of the gate may go either way and is left out of the
count.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, List, Mapping, Sequence, Set, Tuple

FLIP = {"+": "-", "-": "+"}
COMPLEMENT = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")

Key = Tuple[str, str, str, str]


def junction_key(a: str, oa: str, b: str, ob: str) -> Key:
    return (a, oa, b, ob) if a <= b else (b, FLIP[ob], a, FLIP[oa])


def planted_junctions(genomes: Iterable[Mapping]) -> Set[Key]:
    """The keys of every genome's junctions (``members`` in genome order)."""
    keys = set()
    for g in genomes:
        m = g["members"]
        pairs = list(zip(m, m[1:])) + ([(m[-1], m[0])] if g["circular"] else [])
        keys |= {junction_key(a, "+", b, "+") for a, b in pairs}
    return keys


def graph_junctions(text: str) -> Set[Key]:
    """The keys of a junction graph file's ``JUNC`` lines."""
    keys = set()
    for line in text.splitlines():
        f = line.split()
        if len(f) >= 5 and f[0] == "JUNC":
            keys.add((f[1], f[2], f[3], f[4]))
    return keys


def fasta_bodies(text: str) -> List[str]:
    """Each record's bases, line breaks and runs of N taken out."""
    bodies, parts = [], None
    for line in text.splitlines():
        if line.startswith(">"):
            if parts is not None:
                bodies.append("".join(parts))
            parts = []
        elif parts is not None:
            parts.append(line.strip())
    if parts is not None:
        bodies.append("".join(parts))
    return [re.sub("[Nn]+", "", b) for b in bodies]


def reverse_complement(seq: str) -> str:
    return seq.translate(COMPLEMENT)[::-1]


def holds(body: str, genome: str, circular: bool) -> bool:
    if len(body) != len(genome):
        return False
    if circular:
        twice = genome + genome
        return body in twice or reverse_complement(body) in twice
    return body == genome or reverse_complement(body) == genome


def genomes_missing(fasta_text: str, genomes: Iterable[Mapping]) -> List[str]:
    """Names of the genomes (``name``, ``seq``, ``circular``) that no record
    of the final FASTA holds."""
    bodies = fasta_bodies(fasta_text)
    return [g["name"] for g in genomes
            if not any(holds(b, g["seq"], g["circular"]) for b in bodies)]


def canonical(seq: str) -> str:
    """A linear sequence or its reverse complement, whichever sorts first."""
    return min(seq, reverse_complement(seq))


def similar(a: Set[int], b: Set[int]) -> bool:
    """corrected_dup.py's is_similar on two records' sets of contig lengths."""
    inter = sum(a & b)
    return bool(a) and bool(b) and (inter / sum(a) >= 0.9 or inter / sum(b) >= 0.9)


def records_wrong(fasta_text: str, genomes: Sequence[Mapping],
                  contigs: Sequence[Tuple[str, str]], probability: Mapping[str, float],
                  min_len: int, gate: float, margin: float) -> Tuple[int, Dict[str, int]]:
    """Records of the final FASTA that the reference does not expect, and
    expected records it lacks: every planted genome, and every contig
    outside them of more than ``min_len`` bases whose ``probability`` is
    ``gate`` or above, where records that are ``similar`` are one, held by
    any of those with the largest sum of lengths.  Contigs within
    ``margin`` of the gate count neither way.  Returns the count and its
    parts."""
    planted = {m for g in genomes for m in g["members"]}
    length = {name: len(seq) for name, seq in contigs}
    # expected records: (key, set of contig lengths)
    want: List[Tuple[str, Set[int]]] = [(g["name"], {length[m] for m in g["members"]})
                                        for g in genomes]
    ambiguous: Set[str] = set()
    for name, seq in contigs:
        if name in planted or len(seq) <= min_len:
            continue
        if abs(probability[name] - gate) < margin:
            ambiguous.add(canonical(seq))
        elif probability[name] >= gate:
            want.append((canonical(seq), {len(seq)}))
    # similar records are one: a group of each, held by its longest ones
    group = list(range(len(want)))

    def root(i: int) -> int:
        while group[i] != i:
            i = group[i]
        return i

    for i in range(len(want)):
        for j in range(i + 1, len(want)):
            if similar(want[i][1], want[j][1]):
                group[root(j)] = root(i)
    best: Dict[int, int] = {}
    for i, (_, lens) in enumerate(want):
        best[root(i)] = max(best.get(root(i), 0), sum(lens))
    holder = {key: root(i) for i, (key, lens) in enumerate(want) if sum(lens) == best[root(i)]}
    got: Counter = Counter()
    extra = 0
    for body in fasta_bodies(fasta_text):
        names = [g["name"] for g in genomes if holds(body, g["seq"], g["circular"])]
        key = names[0] if names else canonical(body)
        if key in holder:
            got[holder[key]] += 1
        elif key not in ambiguous:
            extra += 1
    groups = set(best)
    missing = sum(1 for r in groups if got[r] == 0)
    extra += sum(got[r] - 1 for r in groups if got[r] > 1)
    genome_groups = {root(i) for i in range(len(genomes))}
    parts = {"genomes_missing": sum(1 for r in genome_groups if got[r] == 0),
             "contigs_missing": missing - sum(1 for r in genome_groups if got[r] == 0),
             "records_extra": extra, "expected": len(groups),
             "merged_as_similar": len(want) - len(groups), "ambiguous": len(ambiguous)}
    return missing + extra, parts
