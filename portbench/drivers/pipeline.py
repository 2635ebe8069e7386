"""Driver ``pipeline``: one virome sample after SPAdes taken through steps
3-6 of the PALACE pipeline by whole calls of
``palace_tpu_torch.pipeline.driver.run_pipeline(cfg, device)``, the call
``python -m palace_tpu_torch --config`` makes, one a sample.

The world (``chip_smoke.py``'s ``make_pipeline_world``, its other contigs
drawn by the ``score_assembly`` mix's law, from the mix): planted phage
genomes, each cut into contigs, among contigs that are not phages, in one
assembly named as metaSPAdes names its contigs; the FASTG links the
planted contigs in genome order (circular genomes closed); paired reads
from the planted genomes and the other contigs; the sorted BAM of those
reads aligned where they were drawn (``alignments``: pairs across a
junction, split reads with SA tags); the protein hits of step 3.2 on
every planted contig; a phagedb of the planted genomes and decoys; the
scorer's checkpoint from the harness's weights, under the reference's
key names.  Sizes, composition and order come from the mix's
``lengths_seed``, so every run seed does the same work; bases, read
positions and strands come from the run's seed.

A sample stages steps 1-2's outputs and the protein hits by hard links
in a fresh directory (what the last sample derived, its depth file,
indexes and scores, is removed first), writes the config file and runs
the pipeline with PATH set to an empty directory: no external tool can
be found, so each external step takes the port's fallback, and every
process a sample starts is counted by its program's name.  The check
holds every sample's scores, reference report, junction graph and final
FASTA, and the last sample's depth file, to the plain references.  A
sample also records its wall, CPU and host-steal seconds, which say
whether a slow sample ran slower or waited.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from portbench.drivers.eref import COMPLEMENT, _write
from portbench.drivers.score import _gc_bases
from portbench.harness import weights
from portbench.reference import assembly as asm_ref
from portbench.reference import depth as depth_ref
from portbench.reference import eref as eref_ref
from portbench.reference import gcn as gcn_ref

#: the unit of the one end-to-end quantity this driver reports
TIME_UNIT = "s"
#: the program's outputs the check reads from every sample, under
#: ``output/`` (PALACE's layout; ``{p}`` the prefix); the depth file, ~40
#: bytes a base of the assembly, is read from the last sample alone
#: SAM flags the program's reader names no constant for
FLAG_PROPER, FLAG_MATE1, FLAG_MATE2 = 0x2, 0x40, 0x80
KEPT = {"node_score": "03-search/node_scores.out", "ref_names": "03-search/{p}_ref_names.txt",
        "graph": "04-match/{p}_graph.txt", "final_fasta": "final_result/{p}_final.fasta"}


def _log_uniform(rng: np.random.Generator, lo: float, hi: float, n: int) -> np.ndarray:
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.int64)


def plan(mix: Mapping) -> Dict:
    """What the mix fixes: every genome's and contig's length, GC share and
    coverage, the cuts, the assembly's order and the phagedb's."""
    rng = np.random.default_rng(mix["lengths_seed"])
    n = mix["phages"]
    phage_len = _log_uniform(rng, mix["phage_len_min"], mix["phage_len_max"], n)
    phage_gc = rng.uniform(*mix["phage_gc_range"], n)
    pieces = []   # (length, owner phage or -1, start in the genome, coverage, GC)
    for i, L in enumerate(phage_len.tolist()):
        w = rng.uniform(*mix["piece_weight_range"],
                        int(rng.integers(mix["pieces_min"], mix["pieces_max"] + 1)))
        cut = np.round(np.concatenate([[0], np.cumsum(w)]) / w.sum() * L).astype(np.int64)
        pieces += [(int(b - a), i, int(a), float(mix["phage_depth"]), float(phage_gc[i]))
                   for a, b in zip(cut, cut[1:])]
    m = mix["others"]
    lens = np.clip(rng.lognormal(np.log(mix["other_median_len"]), mix["other_sigma"], m),
                   mix["other_min_len"], mix["other_max_len"]).astype(np.int64)
    covs = rng.lognormal(np.log(mix["other_cov_median"]), mix["other_cov_sigma"], m)
    gcs = rng.uniform(*mix["other_gc_range"], m)
    pieces += [(int(L), -1, 0, round(float(c), 1), float(g))
               for L, c, g in zip(lens, covs, gcs)]
    order = rng.permutation(len(pieces))
    decoy_len = _log_uniform(rng, mix["decoy_len_min"], mix["decoy_len_max"], mix["decoys"])
    return {"phage_len": phage_len, "phage_gc": phage_gc,
            "circular": np.arange(n) % mix["circular_every"] == 0,
            "pieces": [pieces[j] for j in order], "decoy_len": decoy_len,
            "db_order": rng.permutation(n + mix["decoys"])}


def make_world(mix: Mapping, seed: int) -> Dict:
    """The sample (see the module's docstring) in memory: ``contigs``
    [(name, bases)] in the assembly's order, ``genomes`` [{name, seq,
    circular, members}], ``junctions`` [(left, right)] by name, ``reads``
    (pairs, 2, read_len) uint8 ASCII (mate 1, mate 2), the BAM's records
    (``bam``, ``alignments``' arrays), and the phagedb's ``refs``
    [(name, bases)]."""
    p = plan(mix)
    rng = np.random.default_rng(seed)
    genomes = []
    for i, (L, gc, circ) in enumerate(zip(p["phage_len"].tolist(), p["phage_gc"].tolist(),
                                          p["circular"].tolist())):
        seq = _gc_bases(rng, np.full(L, gc, np.float32)).tobytes().decode()
        genomes.append({"name": f"phage{i + 1}", "seq": seq, "circular": bool(circ),
                        "members": []})
    other = [pc for pc in p["pieces"] if pc[1] < 0]
    pool = _gc_bases(rng, np.repeat(np.array([g for *_, g in other], np.float32),
                                    [L for L, *_ in other])).tobytes().decode()
    contigs, members, lo = [], {}, 0
    for e, (L, owner, start, cov, _) in enumerate(p["pieces"]):
        name = f"EDGE_{e + 1}_length_{L}_cov_{cov}"
        if owner >= 0:
            s = genomes[owner]["seq"][start:start + L]
            members.setdefault(owner, []).append((start, e))
        else:
            s, lo = pool[lo:lo + L], lo + L
        contigs.append((name, s))
    junctions = []
    for i, g in enumerate(genomes):
        g["tids"] = [e for _, e in sorted(members[i])]
        g["members"] = m = [contigs[e][0] for e in g["tids"]]
        junctions += list(zip(m, m[1:])) + ([(m[-1], m[0])] if g["circular"] else [])

    # read pairs: a fragment's two ends, uniform over every genome (a
    # circular one across its origin too) and every other contig; half the
    # fragments have mate 1 on the reverse strand
    read_len, frag = mix["read_len"], mix["fragment"]
    planted = {e for g in genomes for e in g["tids"]}
    others = [e for e in range(len(contigs)) if e not in planted]
    sources = [g["seq"] + (g["seq"][:frag] if g["circular"] else "") for g in genomes]
    sources += [contigs[e][1] for e in others]
    depth = [mix["phage_depth"]] * len(genomes) + [mix["other_depth"]] * len(others)
    src = np.frombuffer("".join(sources).encode(), np.uint8)
    src_len = np.array([len(s) for s in sources], np.int64)
    src_first = np.concatenate([[0], np.cumsum(src_len)[:-1]])
    n_pairs = src_len * np.array(depth, np.int64) // (2 * read_len)
    which = np.repeat(np.arange(src_len.size), n_pairs)
    start = rng.integers(0, src_len[which] - frag + 1)
    windows = np.lib.stride_tricks.sliding_window_view(src, read_len)
    fwd = windows[src_first[which] + start]
    rev = COMPLEMENT[windows[src_first[which] + start + frag - read_len][:, ::-1]]
    flip = rng.random(which.size) < 0.5
    reads = np.where(flip[:, None, None], np.stack([rev, fwd], 1), np.stack([fwd, rev], 1))

    # where each source's bases lie in the assembly: a segment a contig
    seg_first, seg_tid, seg_next, src_at = [], [], [], []
    at = 0
    for g in genomes:
        src_at.append(at)
        t = g["tids"]
        for j, e in enumerate(t):
            seg_first.append(at)
            seg_tid.append(e)
            seg_next.append(t[j + 1] if j + 1 < len(t) else (t[0] if g["circular"] else -1))
            at += len(contigs[e][1])
    for e in others:
        src_at.append(at)
        seg_first.append(at)
        seg_tid.append(e)
        seg_next.append(-1)
        at += len(contigs[e][1])
    segs = {"first": np.array(seg_first, np.int64), "tid": np.array(seg_tid, np.int64),
            "next": np.array(seg_next, np.int64),
            "len": np.array([len(contigs[e][1]) for e in seg_tid], np.int64)}
    wrap = np.array([len(g["seq"]) for g in genomes] + [len(contigs[e][1]) for e in others],
                    np.int64)
    bam = alignments(segs, np.array(src_at, np.int64)[which], wrap[which], start, flip,
                     read_len, frag, mix["min_split"])

    refs = [(g["name"], g["seq"]) for g in genomes]
    dec = _gc_bases(rng, np.full(int(p["decoy_len"].sum()), 0.5, np.float32)).tobytes().decode()
    first = np.concatenate([[0], np.cumsum(p["decoy_len"])]).tolist()
    refs += [(f"decoy{j + 1}", dec[a:b]) for j, (a, b) in enumerate(zip(first, first[1:]))]
    refs = [refs[j] for j in p["db_order"]]
    return {"contigs": contigs, "genomes": genomes, "junctions": junctions, "reads": reads,
            "bam": bam, "refs": refs}


def alignments(segs: Mapping[str, np.ndarray], at: np.ndarray, wrap: np.ndarray,
               start: np.ndarray, flip: np.ndarray, read_len: int, frag: int,
               min_split: int) -> Dict[str, np.ndarray]:
    """Each mate of each pair aligned where it was drawn, as an aligner that
    meets no error reports it after ``samtools view -F 0x800`` and a sort:
    one primary record a mate, ordered by (contig, position, pair, mate).

    A pair's fragment starts ``start`` bases into its source, which lies
    from ``at`` in ``segs`` (``first``, ``len``, ``tid``, ``next``: the
    assembly's contigs laid end to end, ``next`` the contig a genome goes
    on into, -1 at its end) and wraps after ``wrap`` bases.  The forward
    mate reads the fragment's first ``read_len`` bases, the reverse one its
    last; mate 1 is the reverse one where ``flip``.  A mate that runs off
    its contig into the next is split where both parts hold ``min_split``
    bases or more: the longer part (the first on a tie) is the primary
    record, the other soft-clipped and named by its SA tag; a shorter part
    is only soft-clipped.

    Arrays a record: ``pair``, ``mate`` (0 for mate 1), ``tid``, ``pos``
    (0-based), ``left``, ``right`` (the read's bases before and after the
    contig's end, ``right`` 0 for a read within one contig), ``primary``
    (0: the left part, 1: the right part), ``sa_tid`` (-1: no SA tag),
    ``sa_pos`` (1-based), ``rev``, ``mtid``, ``mpos``, ``mrev``, ``tlen``."""
    pairs = start.size
    offset = np.stack([start, start + frag - read_len], 1)          # (pairs, fwd/rev)
    g = at[:, None] + offset % wrap[:, None]
    k = np.searchsorted(segs["first"], g, side="right") - 1
    o = g - segs["first"][k]
    left = np.minimum(read_len, segs["len"][k] - o)
    right = read_len - left
    nxt = segs["next"][k]
    split = (left >= min_split) & (right >= min_split)
    primary = (right > left) | ((right > 0) & (left < min_split))   # 1: the right part
    tid = np.where(primary, nxt, segs["tid"][k])
    pos = np.where(primary, 0, o)
    sa_tid = np.where(split, np.where(primary, segs["tid"][k], nxt), -1)
    sa_pos = np.where(primary, o + 1, 1)
    rev = np.broadcast_to(np.array([False, True]), (pairs, 2))

    def mates(a: np.ndarray) -> np.ndarray:
        """(forward, reverse) columns as (mate 1, mate 2)."""
        return np.where(flip[:, None], a[:, ::-1], a)

    tid, pos, rev, left, right = mates(tid), mates(pos), mates(rev), mates(left), mates(right)
    primary, sa_tid, sa_pos = mates(primary), mates(sa_tid), mates(sa_pos)
    mtid, mpos, mrev = tid[:, ::-1], pos[:, ::-1], rev[:, ::-1]
    span = np.where(right > 0, np.where(primary == 1, right, left), read_len)
    end = pos + span
    same = tid[:, 0] == tid[:, 1]
    lo = np.minimum(pos[:, 0], pos[:, 1])
    hi = np.maximum(end[:, 0], end[:, 1])
    leftmost = (pos <= pos[:, ::-1]) & ((pos < pos[:, ::-1]) | (np.arange(2) == 0))
    tlen = np.where(same[:, None], np.where(leftmost, 1, -1) * (hi - lo)[:, None], 0)
    rec = {"pair": np.repeat(np.arange(pairs), 2), "mate": np.tile([0, 1], pairs),
           "tid": tid, "pos": pos, "left": left, "right": right,
           "primary": primary.astype(np.int8), "sa_tid": sa_tid, "sa_pos": sa_pos, "rev": rev,
           "mtid": mtid, "mpos": mpos, "mrev": mrev, "tlen": tlen}
    rec = {key: np.asarray(v).reshape(-1) for key, v in rec.items()}
    order = np.lexsort((rec["mate"], rec["pair"], rec["pos"], rec["tid"]))
    return {key: v[order] for key, v in rec.items()}


def _fsync(path: Path) -> None:
    with open(path, "rb+") as fh:
        os.fsync(fh.fileno())


def _fasta(records) -> bytes:
    return "".join(f">{name}\n{seq}\n" for name, seq in records).encode()


def fastq(reads: np.ndarray, mate: int) -> bytes:
    """Mate ``mate`` (1 or 2) of every pair as FASTQ records ``@p<i>/<mate>``
    (fixed-width numbers), quality I."""
    n, L = reads.shape[0], reads.shape[2]
    width = len(str(max(n - 1, 0)))
    digits = (np.arange(n)[:, None] // 10 ** np.arange(width - 1, -1, -1)) % 10 + ord("0")
    cols = [np.full((n, 2), list(b"@p"), np.uint8), digits.astype(np.uint8),
            np.full((n, 3), list(f"/{mate}\n".encode()), np.uint8), reads[:, mate - 1],
            np.full((n, 3), list(b"\n+\n"), np.uint8), np.full((n, L), ord("I"), np.uint8),
            np.full((n, 1), ord("\n"), np.uint8)]
    return np.ascontiguousarray(np.concatenate(cols, axis=1)).tobytes()


def checkpoint(params: Mapping[str, torch.Tensor], cfg: Mapping[str, int]) -> Dict:
    """The harness's weights as a reference ``state_dict`` (PALACE's module
    names; Linear weights stored (out, in)), each tensor its own storage
    on the host."""
    t = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
    state = {}
    for name in ("pnode_d", "fnode_d", "d1", "d2"):
        state[f"{name}.weight"] = t[f"{name}.w"].T.contiguous()
        state[f"{name}.bias"] = t[f"{name}.b"]
    for i in range(cfg["num_layers"]):
        for tag in ("convs_1", "convs_2"):
            state[f"{tag}.{i}.lin_l.weight"] = t[f"{tag}.{i}.lin_l.w"].T.contiguous()
            state[f"{tag}.{i}.lin_l.bias"] = t[f"{tag}.{i}.lin_l.b"]
            state[f"{tag}.{i}.lin_r.weight"] = t[f"{tag}.{i}.lin_r.w"].T.contiguous()
    state["lns.0.weight"], state["lns.0.bias"] = t["ln.scale"], t["ln.bias"]
    for i in (1, 2, 3):
        state[f"conv{i}.weight"], state[f"conv{i}.bias"] = t[f"conv{i}.w"], t[f"conv{i}.b"]
    return state


class _Launches:
    """``subprocess.Popen`` while a sample runs: every process started is
    recorded by its program's name."""

    def __init__(self):
        self.names: List[str] = []
        self.real = subprocess.Popen

    def __enter__(self):
        names, real = self.names, self.real

        class Popen(real):
            def __init__(self, args, *a, **kw):
                first = args if isinstance(args, (str, bytes, os.PathLike)) else args[0]
                names.append(Path(os.fsdecode(first)).name.split()[0] if first else "")
                super().__init__(args, *a, **kw)

        subprocess.Popen = Popen
        return self

    def __exit__(self, *exc):
        subprocess.Popen = self.real
        return False


class Driver:
    """See the module's docstring; the interface is ``harness/cell.py``'s."""

    def __init__(self, config: Mapping, mix: Mapping, seed: int, device: torch.device,
                 tmp: Path):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.tmp = tmp
        self.reference_s = 0.0
        self.launches = _Launches()
        self.kept: List[Dict[str, str]] = []
        self.timing = {"stage_s": 0.0, "remove_s": 0.0, "depth_read_s": 0.0, "keep_s": 0.0,
                       "cpu_s": 0.0, "steal_s": 0.0}
        #: (wall, CPU, host-steal) seconds of each sample
        self.walls: List[tuple] = []

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from palace_tpu_torch.graph.depth import DepthStore
        from palace_tpu_torch.io.bam import BamFile, write_bam
        from palace_tpu_torch.models import gcn
        from palace_tpu_torch.native import _build as native_build
        from palace_tpu_torch.ops import _build as kernel_build
        from palace_tpu_torch.pipeline import driver as pipeline

        if gcn.GCNConfig(**self.config["gcn"]) != gcn.DEFAULT_CONFIG:
            raise SystemExit("portbench: the pipeline scores with gcn.DEFAULT_CONFIG; the "
                             f"configuration's gcn {self.config['gcn']} differs")
        t = time.perf_counter()
        w = self.world = make_world(self.mix, self.seed)
        parts = {"world_s": time.perf_counter() - t}

        src = self.tmp / "world"
        self.files: Dict[str, Path] = {}
        prefix = self.mix["prefix"]
        layout = {"fastq1": f"01-qc/{prefix}_1_filter.fastq",
                  "fastq2": f"01-qc/{prefix}_2_filter.fastq",
                  "contigs": "02-assembly/contigs.fasta",
                  "assembly": "02-assembly/assembly_graph.fasta",
                  "fastg": "02-assembly/assembly_graph.fastg",
                  "paths": "02-assembly/contigs.paths",
                  "bam": f"02-assembly/{prefix}_reads_pe_primary.sort.bam",
                  "hits": "03-search/hit_seqs.out",
                  "phagedb": "phagedb.fasta", "proteins": "protein_db/proteins.fasta",
                  "model": "gcn_model.pt"}
        for key, rel in layout.items():
            self.files[key] = src / rel
            self.files[key].parent.mkdir(parents=True, exist_ok=True)
        f = self.files
        contigs_fa = _fasta(w["contigs"])
        _write(f["contigs"], contigs_fa)
        _write(f["assembly"], contigs_fa)
        links: Dict[str, List[str]] = {}
        for a, b in w["junctions"]:
            links.setdefault(a, []).append(b)
        _write(f["fastg"], "".join(
            (f">{n}:{','.join(links[n])};" if n in links else f">{n};") + f"\n{s}\n"
            for n, s in w["contigs"]).encode())
        _write(f["paths"], "".join(
            f"NODE_{i}_length_{len(g['seq'])}_cov_{self.mix['phage_depth']}\n"
            + ",".join(f"{m.split('_')[1]}+" for m in g["members"]) + ";\n"
            for i, g in enumerate(w["genomes"], 1)).encode())
        _write(f["hits"], "".join(f"{m}\t{self.mix['gene_hits']}\n"
                                  for g in w["genomes"] for m in g["members"]).encode())
        _write(f["fastq1"], fastq(w["reads"], 1))
        _write(f["fastq2"], fastq(w["reads"], 2))
        _write(f["phagedb"], _fasta(w["refs"]))
        _write(f["proteins"], b">prot1\nMAAAKKK\n")
        write_bam(f["bam"], BamFile(references=[(n, len(s)) for n, s in w["contigs"]],
                                    records=bam_records(w["bam"], w["contigs"],
                                                        self.mix["read_len"])))
        _fsync(f["bam"])
        parts["write_s"] = time.perf_counter() - t - sum(parts.values())

        cfg = self.config["gcn"]
        self.params = weights.gcn_params(cfg, self.seed, self.device)
        step = max(1, len(w["contigs"]) // weights.HEAD_CONTIGS)
        head = [s for _, s in w["contigs"][::step]][:weights.HEAD_CONTIGS]
        r = time.perf_counter()
        weights.centre_head(self.params, head, cfg, self.device)
        # the head is set from the plain reference's activations: its
        # seconds are the reference's, not the set-up's
        self.reference_s = time.perf_counter() - r
        torch.save(checkpoint(self.params, cfg), f["model"])
        _fsync(f["model"])
        parts["weights_s"] = time.perf_counter() - t - sum(parts.values())

        # every kernel and the native programs built before a sample runs,
        # with the PATH the compilers need; the samples find no tool
        if self.device.type == "cuda":
            kernel_build.build_all()
        native_build.build_all()
        self.no_tools = self.tmp / "no_tools"
        self.no_tools.mkdir()
        self.run_dir = self.tmp / "sample"
        self._pipeline, self._depth_store = pipeline, DepthStore
        read = DepthStore.__dict__["read_text"]
        self._read_text = read
        timing = self.timing

        def timed_read(cls, path):
            t0 = time.perf_counter()
            with record_function("portbench.depth_read"):
                store = read.__func__(cls, path)
            timing["depth_read_s"] += time.perf_counter() - t0
            return store

        DepthStore.read_text = classmethod(timed_read)
        self.sample()  # warm: every shape a sample runs
        self.kept.clear()
        self.launches.names.clear()
        self.timing.update(dict.fromkeys(self.timing, 0.0))
        self.walls.clear()
        parts["warm_s"] = time.perf_counter() - t - sum(parts.values())
        parts["reference_s"] = self.reference_s
        self.setup_parts = parts

    def _stage(self) -> Path:
        """A fresh directory with steps 1-2's outputs, the protein hits, the
        phagedb, the protein database and the checkpoint linked in, and the
        config file; returns the config file."""
        out = self.run_dir / "output"
        for key, path in self.files.items():
            dest = (self.run_dir if key in ("phagedb", "proteins", "model") else out) \
                / path.relative_to(self.tmp / "world")
            dest.parent.mkdir(parents=True, exist_ok=True)
            os.link(path, dest)
        keys = {"fastq1": out / "01-qc" / self.files["fastq1"].name,
                "fastq2": out / "01-qc" / self.files["fastq2"].name,
                "phagedb": self.run_dir / "phagedb.fasta",
                "protein_db": self.run_dir / "protein_db",
                "gcn_model": self.run_dir / "gcn_model.pt",
                "out_dir": out, "prefix": self.mix["prefix"], **self.mix["config_keys"]}
        for group in ("kmer", "score"):
            keys.update({f"{group}_{k}": v for k, v in self.config[group].items()})
        config = self.run_dir / "config.txt"
        config.write_text("".join(f"{k}={v}\n" for k, v in keys.items()))
        return config

    # -- the timed call ------------------------------------------------------
    def sample(self) -> None:
        from palace_tpu_torch.config import PalaceConfig

        t, cpu, steal = time.perf_counter(), _cpu_s(), _steal_s()
        if self.run_dir.exists():
            shutil.rmtree(self.run_dir)
        t1 = time.perf_counter()
        config = self._stage()
        t2 = time.perf_counter()
        self.timing["remove_s"] += t1 - t
        self.timing["stage_s"] += t2 - t1
        path = os.environ.get("PATH")
        os.environ["PATH"] = str(self.no_tools)
        try:
            with self.launches:
                self._pipeline.run_pipeline(PalaceConfig.from_file(config), device=self.device)
        finally:
            if path is None:
                del os.environ["PATH"]
            else:
                os.environ["PATH"] = path
        t3 = time.perf_counter()
        cpu, steal = _cpu_s() - cpu, _steal_s() - steal
        self.timing["cpu_s"] += cpu
        self.timing["steal_s"] += steal
        self.walls.append((t3 - t, cpu, steal))
        self.kept.append(self._outputs())
        self.timing["keep_s"] += time.perf_counter() - t3

    def _records(self):
        """The BAM's records as (tid, 0-based position, CIGAR), in its order."""
        return cigars(self.world["bam"], self.mix["read_len"])

    def _outputs(self) -> Dict[str, Optional[str]]:
        """The text of each of ``KEPT``, None where the file is missing."""
        out = {}
        for key, rel in KEPT.items():
            try:
                out[key] = (self.run_dir / "output" / rel.format(p=self.mix["prefix"])).read_text()
            except OSError:
                out[key] = None
        return out

    def work(self, samples: int) -> Dict[str, float]:
        w = self.world
        return {"samples": samples, "contigs": samples * len(w["contigs"]),
                "bam_records": samples * int(w["bam"]["tid"].size),
                "read_pairs": samples * int(w["reads"].shape[0]),
                "refs": samples * len(w["refs"]),
                "assembly_bp": samples * sum(len(s) for _, s in w["contigs"]),
                **self.timing}

    def end_to_end(self, metrics: Sequence[Mapping], samples: int,
                   window_s: float) -> Dict[str, float]:
        """The window's seconds a sample, under the name of each of
        ``metrics`` in that unit."""
        return {m["name"]: window_s / samples for m in metrics if m["unit"] == TIME_UNIT}

    def release(self) -> None:
        """The pipeline keeps no state between calls; the read of the depth
        file is the program's own again."""
        if hasattr(self, "_read_text"):
            self._depth_store.read_text = self._read_text

    # -- the check -----------------------------------------------------------
    def check(self, quant: Optional[str] = None, table_bits: Optional[int] = None,
              soft_clips: bool = False) -> Dict[str, float]:
        """Every sample's scores, reference report, junction graph and final
        FASTA, and the last sample's depth file, against the plain
        references; the processes the samples started.  The control's
        arguments put a reference computed one step lower in the program's
        place: ``quant`` ("tf32") the scorer's, ``table_bits`` eref's table,
        ``soft_clips`` the depth's count."""
        t = time.perf_counter()
        w = self.world
        names = [n for n, _ in w["contigs"]]
        seqs = [s for _, s in w["contigs"]]
        info: Dict[str, object] = {}
        numbers: Dict[str, float] = {}
        runs = self.kept or [self._outputs()]

        ref = gcn_ref.probabilities(self.params, seqs, self.config["gcn"], self.device)
        if quant is not None:
            p = gcn_ref.probabilities(self.params, seqs, self.config["gcn"], self.device, quant)
            scores = [list(zip(names, p.tolist()))]
        else:
            scores = [_scores(r["node_score"]) for r in runs]
        self.params = None
        want = want_p = dict(zip(names, ref.tolist()))
        wrong, gaps = 0, []
        for got in scores:
            got_names = [n for n, _ in got]
            wrong += len(set(got_names) ^ set(names)) or int(got_names != names)
            gaps.append(np.array([abs(p - want[n]) for n, p in got if n in want] or [np.inf]))
        gap = np.concatenate(gaps)
        numbers.update(contigs_misnamed=float(wrong), prob_gap_max=float(gap.max()),
                       prob_gap_mean=float(gap.mean()))
        info["reference_p_quantiles"] = np.quantile(ref, [0, 0.01, 0.5, 0.99, 1]).tolist()

        kmer = self.config["kmer"]
        reads = torch.from_numpy(eref_ref.BASE_CODES[w["reads"].reshape(-1, w["reads"].shape[2])])
        db = np.frombuffer("".join(s for _, s in w["refs"]).encode(), np.uint8)
        bases = torch.from_numpy(eref_ref.BASE_CODES[db]).to(self.device)
        lengths = np.array([len(s) for _, s in w["refs"]], np.int64)
        table = eref_ref.count_table(reads.to(self.device), kmer)
        lines = eref_ref.hit_lines(table, bases, lengths, kmer)
        del table
        if table_bits is not None:
            control = eref_ref.count_table(reads.to(self.device), kmer, table_bits)
            reports = [eref_ref.hit_lines(control, bases, lengths, kmer, table_bits)]
            del control
        else:
            reports = [(r["ref_names"] or "").splitlines() for r in runs]
        del reads, bases
        numbers["report_lines_wrong"] = float(sum(
            len(set(rep) ^ set(lines)) or int(rep != lines) for rep in reports))
        index = {name: i + 1 for i, (name, _) in enumerate(w["refs"])}
        reported = {int(line.split("\t")[1]) for line in lines}
        info["reference_refs"] = len(lines)
        info["planted_refs_reported"] = sum(index[g["name"]] in reported for g in w["genomes"])

        contig_len = [len(s) for s in seqs]
        want = depth_ref.depth_text(names, contig_len, depth_ref.depths(contig_len,
                                                                        self._records()))
        if soft_clips:
            got = depth_ref.depth_text(names, contig_len, depth_ref.depths(
                contig_len, self._records(), soft_clips=True))
        else:
            bam = self.run_dir / "output" / "02-assembly" / self.files["bam"].name
            try:
                got = Path(f"{bam}.depth").read_bytes()
            except OSError:
                got = b""
        numbers["depth_lines_wrong"] = float(depth_ref.lines_wrong(got, want))
        info["depth_lines"] = want.count(b"\n")

        planted = asm_ref.planted_junctions(w["genomes"])
        numbers["junctions_wrong"] = float(sum(
            len(planted ^ asm_ref.graph_junctions(r["graph"] or "")) for r in runs))
        numbers["planted_missing"] = float(sum(
            len(asm_ref.genomes_missing(r["final_fasta"] or "", w["genomes"])) for r in runs))
        gates = self.mix["final_gates"]
        finals = [asm_ref.records_wrong(r["final_fasta"] or "", w["genomes"], w["contigs"],
                                        want_p, self.mix["config_keys"]["MIN_LEN"],
                                        gates["score"], gates["margin"]) for r in runs]
        numbers["final_records_wrong"] = float(sum(n for n, _ in finals))
        info["final_records"] = [len(asm_ref.fasta_bodies(r["final_fasta"] or "")) for r in runs]
        info["final_parts"] = finals[-1][1]
        tools = set(self.mix["external_tools"])
        numbers["external_runs"] = float(sum(n in tools for n in self.launches.names))
        info["processes"] = sorted(set(self.launches.names))
        info["sample_wall_cpu_steal_s"] = self.walls
        info["check_s"] = time.perf_counter() - t
        self.info = info
        return numbers

    def close(self) -> None:
        self.release()


def _cpu_s() -> float:
    """This process's and its ended children's CPU seconds."""
    t = os.times()
    return t.user + t.system + t.children_user + t.children_system


def _steal_s() -> float:
    """Seconds the host's hypervisor ran something else on this machine's
    cores, summed over the cores (``/proc/stat``); 0 where unreadable."""
    try:
        with open("/proc/stat") as fh:
            fields = fh.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def cigars(bam: Mapping[str, np.ndarray], read_len: int):
    """(tid, 0-based position, CIGAR) of each record of ``alignments``."""
    for t, p, left, right, primary in zip(bam["tid"].tolist(), bam["pos"].tolist(),
                                          bam["left"].tolist(), bam["right"].tolist(),
                                          bam["primary"].tolist()):
        if right == 0:
            yield t, p, [(read_len, "M")]
        else:
            yield t, p, [(left, "S" if primary else "M"), (right, "M" if primary else "S")]


def bam_records(bam: Mapping[str, np.ndarray], contigs: Sequence, read_len: int) -> list:
    """``alignments``' records as the program's ``BamRecord``s: named as the
    FASTQ names the pair, mapping quality 60, no mismatch."""
    from palace_tpu_torch.io.bam import (FLAG_MREVERSE, FLAG_PAIRED, FLAG_REVERSE, BamRecord)

    width = len(str(max(int(bam["pair"].max(initial=0)), 0)))
    names = [n for n, _ in contigs]
    out = []
    cols = zip(cigars(bam, read_len), bam["pair"].tolist(), bam["mate"].tolist(),
               bam["rev"].tolist(), bam["mtid"].tolist(), bam["mpos"].tolist(),
               bam["mrev"].tolist(), bam["tlen"].tolist(), bam["sa_tid"].tolist(),
               bam["sa_pos"].tolist())
    for (t, p, cigar), pair, mate, rev, mt, mp, mrev, tlen, sa_tid, sa_pos in cols:
        flag = (FLAG_PAIRED | (FLAG_PROPER if mt == t else 0) | (FLAG_REVERSE if rev else 0)
                | (FLAG_MREVERSE if mrev else 0) | (FLAG_MATE2 if mate else FLAG_MATE1))
        tags = {"NM": 0}
        if sa_tid >= 0:
            other = "".join(f"{n}{'M' if op == 'S' else 'S'}" for n, op in cigar)
            tags["SA"] = f"{names[sa_tid]},{sa_pos},{'-' if rev else '+'},{other},60,0;"
        out.append(BamRecord(f"p{pair:0{width}d}", flag, t, p, 60, cigar, mt, mp, tlen,
                             read_len, tags))
    return out


def _scores(text: Optional[str]) -> List[tuple]:
    """``node_scores.out``'s (name, probability) rows."""
    rows = []
    for line in (text or "").splitlines():
        f = line.split("\t")
        if len(f) >= 2:
            rows.append((f[0], float(f[1])))
    return rows
