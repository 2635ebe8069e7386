"""Majority vote over similar references' scaffold paths.

Semantic port of share/palace/scripts/find_most_common_result.py:
among grouped similar refs (lines of ``similar_ref.txt``), read each
``<ref>_ragtag_scaffold_part.txt`` (``|`` → ``_`` in filenames, :49),
count identical contents treating a path and its reverse-flip as equal
(:41-71), and append the most frequent content per group to the final
tmp file (:73-78).
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional

from palace_tpu_torch.utils.logging import get_logger

logger = get_logger("palace")


def _reverse_string(s: str) -> str:
    """find_most_common_result.py:18-36 — reverse segments, flip signs."""
    parts = re.split(r"(\+|-)", s)
    combined = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
    combined.reverse()
    flip = {"+": "-", "-": "+"}
    for i in range(len(combined)):
        if combined[i]:
            last = combined[i][-1]
            combined[i] = combined[i][:-1] + flip.get(last, last)
    return "".join(combined)


def _process_group(directory: str | Path, refs: List[str]) -> Optional[str]:
    content_count: Dict[str, int] = {}
    order: List[str] = []
    for ref in refs:
        ref = ref.replace("|", "_")
        ragtag_file = Path(directory) / f"{ref}_ragtag_scaffold_part.txt"
        if not ragtag_file.is_file():
            logger.warning("File %s not found.", ragtag_file)
            continue
        content = ragtag_file.read_text()
        if content in content_count:
            content_count[content] += 1
        elif _reverse_string(content) in content_count:
            content_count[_reverse_string(content)] += 1
        else:
            content_count[content] = 1
            order.append(content)
    if not content_count:
        return None
    best = max(order, key=lambda c: content_count[c])
    return best


def find_most_common_result(directory: str | Path, similar_ref_file: str | Path,
                            output_file: str | Path) -> int:
    """Appends winners to ``output_file``; returns #groups written."""
    n = 0
    with open(similar_ref_file) as infile, open(output_file, "a") as outfile:
        for line in infile:
            refs = line.strip().split(",")
            if not any(refs):
                continue
            best = _process_group(directory, refs)
            if best:
                outfile.write(best + "\n")
                n += 1
    return n
