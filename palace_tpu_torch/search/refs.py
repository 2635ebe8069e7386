"""Map eref hits to reference sequences.

Equivalent of share/palace/scripts/get_ref_by_index.py: parse the
``ref_index <idx> ... <ratio>`` lines, map 1-based indices to names via
the phagedb ``.fai`` row number (:40-49), and write
``phage_refs.fasta`` + ``{prefix}_ref_percent.txt`` (:73-85).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

from palace_tpu_torch.io.fasta import FastaIndex, FastaStore
from palace_tpu_torch.utils.logging import get_logger

logger = get_logger("palace")


def parse_ref_names_file(path: str | Path) -> Dict[int, float]:
    """``ref_index`` lines → {index: coverage ratio}
    (get_ref_by_index.py:6-37: first integer token, last float token)."""
    out: Dict[int, float] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line.startswith("ref_index"):
                continue
            parts = line.split()
            index = None
            for part in parts[1:]:
                if part.isdigit():
                    index = int(part)
                    break
            percentage = None
            for part in reversed(parts):
                try:
                    percentage = float(part)
                    break
                except ValueError:
                    continue
            if index is not None and percentage is not None:
                out[index] = percentage
    return out


def extract_reference_sequences(
    phagedb_fasta: str | Path,
    ref_names_file: str | Path,
    out_fasta: str | Path,
    out_percent: str | Path,
    fai_path: str | Path | None = None,
) -> List[Tuple[str, float]]:
    """Write the hit references' sequences and coverage percentages."""
    store = FastaStore(phagedb_fasta)
    fai = FastaIndex.read(fai_path) if fai_path else store.index
    ref_data = parse_ref_names_file(ref_names_file)
    written: List[Tuple[str, float]] = []
    try:
        with open(out_fasta, "w") as fa_out, open(out_percent, "w") as pct_out:
            for index in sorted(ref_data):
                if not (1 <= index <= len(fai.entries)):
                    logger.warning("Index %d not found in FAI file", index)
                    continue
                name = fai.name_by_row(index)
                if name not in store:
                    logger.warning("Sequence '%s' not found in FASTA file", name)
                    continue
                fa_out.write(f">{name}\n{store.fetch(name)}\n")
                pct_out.write(f"{name}\t{ref_data[index]}\n")
                written.append((name, ref_data[index]))
    finally:
        store.close()
    return written
