"""``key=value`` configuration of the pipeline, the port's own copy.

The reference driver parses a ``key=value`` file and ``eval``s its keys
into shell variables (palace:187-204), checks a required set
(palace:219-225) and that the inputs exist (palace:274-308); the keys
are documented in the reference's config/config.txt.  ``PalaceConfig``
parses the same file without ``eval``, into typed fields and the
parameter groups of each stage: ``KmerParams`` (the eref search),
``GraphParams`` (the junction graph), ``ScoreParams`` (the scorer) and
``MeshConfig``, which the port parses so that one file reads the same in
both packages but does not use: it runs on one device.  Nested keys are
``group_field`` or ``group.field`` (``kmer_k=16``, ``score.dtype=bfloat16``).
A boolean field reads ``1/true/yes`` as true and ``0/false/no`` as false,
case-insensitive, and anything else raises.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

#: keys the reference treats as required (palace:219)
REQUIRED_KEYS = (
    "fastq1",
    "fastq2",
    "phagedb",
    "protein_db",
    "gcn_model",
    "out_dir",
    "prefix",
    "threads",
)


def parse_kv_file(path: str | Path) -> Dict[str, str]:
    """Parse a reference-compatible ``key=value`` config file.

    Mirrors palace:187-204: '#'-prefixed and empty lines are skipped,
    '.' in keys becomes '_', keys/values are whitespace-trimmed.
    """
    out: Dict[str, str] = {}
    with open(path) as fh:
        for raw in fh:
            if "=" not in raw:
                continue
            key, _, value = raw.partition("=")
            key = key.strip()
            if not key or key.startswith("#"):
                continue
            out[key.replace(".", "_")] = value.strip()
    return out


_TRUE = ("1", "true", "yes")
_FALSE = ("0", "false", "no")


def parse_bool(value: str) -> bool:
    """``1/true/yes`` → True, ``0/false/no`` → False (any case); anything
    else raises ``ValueError``."""
    v = value.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"not a boolean: {value!r} (use one of {_TRUE + _FALSE})")


def _convert(current: object, value: str) -> object:
    """``value`` in the type of the field's ``current`` value."""
    if isinstance(current, bool):
        return parse_bool(value)
    if isinstance(current, str):
        return value
    return type(current)(value)


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


@dataclass
class ScoreParams:
    """GCN scorer shapes/thresholds (phage_scoring.py:47-55, filter_graph.py argv)."""

    kmer_k: int = 3
    score_threshold: float = 0.7   # palace:579 passes 0.7 to filter_graph
    high_score: float = 0.9        # filter_result.py:168/196
    batch_size: int = 512          # contigs a dispatch
    encode_batch: int = 1000       # generate_model_input batch (phage_scoring.py:136)
    dtype: str = "float32"         # compute dtype on the card ("bfloat16" for speed)
    #: accepted so that a config reads the same in both packages; the
    #: port dispatches batch by batch, whatever its value
    fuse_k: int = 1
    #: scoring with random weights silently yields garbage probabilities;
    #: a missing gcn_model is a hard error unless this is set (tests/dev)
    allow_random_weights: bool = False


@dataclass
class MeshConfig:
    """Device-mesh layout of the JAX package's config files; parsed, and
    unused by the port, which runs on one device."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 0   # 0 → auto (fill remaining devices)
    model_parallel: int = 1


@dataclass
class PalaceConfig:
    fastq1: str = ""
    fastq2: str = ""
    phagedb: str = ""
    protein_db: str = ""
    gcn_model: str = ""
    out_dir: str = "output"
    prefix: str = "sample"
    threads: int = 8
    min_len: int = 10000           # MIN_LEN (config/config.txt:20)
    env_prefix: str = ""
    blast_ratio: float = 0.7       # palace:572/579
    filter_blast_ratio: float = 0.75  # palace:609
    matching_iters: int = 10       # palace:587-590
    # global -s solver mode: "" = auto (per-component exact where it
    # fits), "0" = force handshake (+abstention), "1" = force exact;
    # matching_aggressive=1 adds the --aggressive greedy pass
    matching_exact: str = ""
    matching_aggressive: int = 0
    # Dev/test ONLY: when blastn is absent, fabricate full-coverage
    # scaffold↔ref hits instead of degrading to empty outputs the way
    # the reference does (palace:509-534).  Off by default so a
    # production run never silently invents alignments.
    dev_fabricate_blast: int = 0
    kmer: KmerParams = field(default_factory=KmerParams)
    graph: GraphParams = field(default_factory=GraphParams)
    score: ScoreParams = field(default_factory=ScoreParams)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    extra: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_file(cls, path: str | Path) -> "PalaceConfig":
        return cls.from_dict(parse_kv_file(path))

    @classmethod
    def from_dict(cls, kv: Dict[str, str]) -> "PalaceConfig":
        cfg = cls()
        scalar_fields = {f.name: f for f in dataclasses.fields(cls)}
        nested = {"kmer": cfg.kmer, "graph": cfg.graph, "score": cfg.score, "mesh": cfg.mesh}
        for key, value in kv.items():
            lk = key.lower()
            if lk == "min_len":
                cfg.min_len = int(float(value))
            elif lk == "env_prefix":
                cfg.env_prefix = value
            elif lk in scalar_fields and lk not in nested and lk != "extra":
                f = scalar_fields[lk]
                if f.type in ("int", int):
                    setattr(cfg, lk, int(float(value)))
                elif f.type in ("float", float):
                    setattr(cfg, lk, float(value))
                else:
                    setattr(cfg, lk, value)
            elif "." in key or "_" in key and key.split("_", 1)[0] in nested:
                group, _, sub = key.replace(".", "_").partition("_")
                obj = nested.get(group)
                if obj is not None and hasattr(obj, sub):
                    setattr(obj, sub, _convert(getattr(obj, sub), value))
                else:
                    cfg.extra[key] = value
            else:
                cfg.extra[key] = value
        return cfg

    def validate(self, check_files: bool = True) -> List[str]:
        """Return a list of problems (empty ⇒ valid).

        Mirrors the driver's validation: required keys present
        (palace:219-225), input files exist (palace:277-282), protein
        DB dir non-empty (palace:285-292).
        """
        problems: List[str] = []
        for key in REQUIRED_KEYS:
            if not getattr(self, key, ""):
                problems.append(f"Required variable '{key}' is not defined in config file")
        if check_files:
            for key in ("fastq1", "fastq2", "phagedb", "gcn_model"):
                p = getattr(self, key)
                if p and not os.path.isfile(p):
                    problems.append(f"Required input file not found: {p}")
            if self.protein_db:
                if not os.path.isdir(self.protein_db) or not os.listdir(self.protein_db):
                    problems.append(
                        f"Protein database directory not found or empty: {self.protein_db}"
                    )
        return problems

    # --- derived paths, mirroring the OUTPUT_FILES table (palace:328-337) ---
    def output_files(self) -> Dict[str, Path]:
        out = Path(self.out_dir)
        p = self.prefix
        return {
            "filter_fastq1": out / "01-qc" / f"{p}_1_filter.fastq",
            "filter_fastq2": out / "01-qc" / f"{p}_2_filter.fastq",
            "first_bam": out / "02-assembly" / f"{p}_reads_pe_primary.sort.bam",
            "assembly_fasta": out / "02-assembly" / "assembly_graph.fasta",
            "assembly_fastg": out / "02-assembly" / "assembly_graph.fastg",
            "hit_out": out / "03-search" / "hit_seqs.out",
            "node_score": out / "03-search" / "node_scores.out",
            "phage_refs": out / "03-search" / "phage_refs.fasta",
            "ref_names": out / "03-search" / f"{p}_ref_names.txt",
            "ref_percent": out / "03-search" / f"{p}_ref_percent.txt",
            "graph": out / "04-match" / f"{p}_graph.txt",
            "filtered_graph": out / "04-match" / f"{p}_filtered_graph.txt",
            "final_fasta": out / "final_result" / f"{p}_final.fasta",
        }
