"""Parameters of the k-mer reference search (``KmerParams``) and of the
junction-graph builder (``GraphParams``): the port's own copies; the
pipeline's other settings are not ported yet."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class KmerParams:
    """Fixed constants of the reference k-mer search (extract_ref.cpp:21-37).

    ``k`` sets both the k-mer length and the hash width (each position
    contributes one bit per coder, extract_ref.cpp:1056-1063), so the
    count table has ``2**k`` entries.  Tests shrink ``k``; the production
    default matches the reference (k=32 → a 4 GiB table).
    """

    k: int = 32
    coder_num: int = 3
    least_depth: int = 3          # saturation level of the count table (:23)
    window: int = 500             # slide_window window (:511)
    hit_ratio: float = 0.9        # one-coder min fraction (palace:477)
    perfect_hit_ratio: float = 0.85  # three-coder min fraction (palace:477)
    min_cover_ratio: float = 0.75  # emit refs covered >75% (:617)
    down_sampling_size: int = 2_000_000_000  # 2 Gbp (:1230)
    coder_seed: int = 1           # seed of the coder permutation (index build and search agree)


@dataclass
class GraphParams:
    """Fixed constants of the junction-graph builder (generate_graph.cpp:20-41)."""

    max_end: int = 300
    min_mapq: int = 0
    max_nm: int = 5
    max_span_frac: float = 0.80
    min_count: int = 5
    enable_paired: bool = True
    lib_type: str = "FR"
    max_gap: int = 150      # split-read stitch gap (generate_graph.cpp:755)
    max_overlap: int = 150  # split-read stitch overlap (:756)
