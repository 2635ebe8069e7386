"""Path file → FASTA: orientation-aware concatenation.

Semantic port of share/palace/scripts/make_fa_from_path.py: skip
``iter``/``self``/empty lines (:84-96); per oriented token fetch the
contig (``-`` reverse-complemented), with missing-name fallback of
dropping the last ``_`` part (:36-39); headers are
``res_<lineno>_<len>`` in mode 0 or the concatenated tokens in mode 1
(:146-152).  Sequences concatenate directly (no N padding).
"""
from __future__ import annotations

from pathlib import Path

from palace_tpu_torch.io.fasta import FastaStore


def make_fa_from_path(
    fasta_path: str | Path,
    paths_path: str | Path,
    output_path: str | Path,
    mode: str | int = 1,
) -> int:
    """Returns the number of FASTA records written."""
    store = FastaStore(fasta_path)
    n = 0
    try:
        with open(paths_path) as paths, open(output_path, "w") as out:
            for line_index, line in enumerate(paths):
                if line.startswith("iter") or line.startswith("self") or line.strip() == "":
                    continue
                tokens = line.strip().split("\t")
                seq = ""
                for tok in tokens:
                    tok = tok.replace(" ", "").strip()
                    if len(tok) <= 1:
                        continue
                    seq += store.fetch_oriented(tok)
                if str(mode) == "0":
                    header = f"res_{line_index + 1}_{len(seq)}"
                else:
                    header = "".join(tokens)
                out.write(f">{header}\n{seq}\n")
                n += 1
    finally:
        store.close()
    return n
