"""End-to-end pipeline driver — the ``palace --config`` equivalent.

    python -m palace_tpu_torch --config config.txt [--force] [--device cuda|cpu]

Orchestrates the six reference steps (palace:343-883) over the port's
stages:

1. QC (external fastp)
2. Assembly + alignment (external SPAdes/bwa/samtools; FASTG→FASTA and
   faidx are ours)
3. Search — protein hits (tblastn wrapper), GCN contig scoring on the
   device (kernels K1-K3), k-mer reference search on the device (eref,
   kernel K4's ``scan_chunk``), reference extraction
4. Graph + matching — depth (native), junction graph (native),
   filter_graph, matching solver, filter_result, filtered blast
5. Second pass — subgraphs, per-subgraph matching, RagTag (external,
   with the reference's fallbacks), parse_remain / filter_by_blast
6. Final — cycle/gene/score gates, majority vote, corrected_dup,
   final FASTA

Every stage checkpoints on its output artifacts (skip-if-exists,
palace:140-149) so any run is resumable.  External-tool stages degrade
exactly like the reference's no-reference branches (touch-empty,
palace:509-534) when a tool is unavailable — but stages whose inputs
are missing entirely raise, pointing at what must be pre-staged.

The device is the CUDA card unless the caller passes ``device="cpu"``
(``--device cpu``); without a card the pipeline raises before any stage
runs.  Only the scorer and eref run on the device; every other step,
the step-5 thread pool included, is host work.  Nothing catches an error
of the scorer or of eref, and no step moves to the CPU when the card was
asked for.

Across devices (``run_pipeline(cfg, mesh=...)``, a library argument as in
the JAX package; the CLI builds no mesh) every rank of the mesh runs the
pipeline: all of them run the scorer and eref together, and rank 0 alone
runs and writes every host stage while the others wait at a barrier.
"""
from __future__ import annotations

import os
import shutil
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from palace_tpu_torch.assembly.path_fa import make_fa_from_path
from palace_tpu_torch.config import PalaceConfig
from palace_tpu_torch.device import resolve_device
from palace_tpu_torch.filters.blast_filter import filter_by_blast
from palace_tpu_torch.filters.common_result import find_most_common_result
from palace_tpu_torch.filters.cycle_filter import filter_cycle_gene_score
from palace_tpu_torch.filters.dedup import corrected_dup
from palace_tpu_torch.filters.final_fa import make_final_fa
from palace_tpu_torch.filters.gene_matches import find_phage_gene_matches
from palace_tpu_torch.filters.result_filter import filter_result
from palace_tpu_torch.filters.second_pass import (
    filter_ragtag,
    generate_second_with_blast,
    get_main_path,
    parse_remain,
)
from palace_tpu_torch.filters.subgraph import create_sub_graphs
from palace_tpu_torch.graph.depth import DepthStore
from palace_tpu_torch.graph.filter import filter_graph, uniq_file
from palace_tpu_torch.graph.native import build_graph, compute_depth_file
from palace_tpu_torch.io.fasta import FastaStore, build_fai
from palace_tpu_torch.io.fastg import fastg_to_node_fasta
from palace_tpu_torch.io.paths_io import remove_duplicate_pairs
from palace_tpu_torch.matching.solver import MatchingOptions, solve_graph_file
from palace_tpu_torch.parallel.collectives import all_reduce_
from palace_tpu_torch.parallel.mesh import Mesh
from palace_tpu_torch.pipeline import external
from palace_tpu_torch.pipeline.stages import Stage, StageRunner, file_exists_with_content
from palace_tpu_torch.search.eref import run_search
from palace_tpu_torch.search.index import load_or_build_index
from palace_tpu_torch.search.refs import extract_reference_sequences
from palace_tpu_torch.utils.logging import SUCCESS, get_logger, show_progress
from palace_tpu_torch.utils.timers import GLOBAL_METRICS, StageTimer

logger = get_logger("palace")


class PalacePipeline:
    def __init__(
        self,
        cfg: PalaceConfig,
        force: bool = False,
        scorer: Optional[Callable[[str, str], int]] = None,
        device: str = "cuda",
        mesh: Optional[Mesh] = None,
    ):
        """``scorer(fasta, out)`` may be injected (tests, custom models);
        the default builds the full-size GCN from ``cfg.gcn_model``.
        ``device`` is resolved here: without a card, ``"cuda"`` raises
        before any stage runs.  Under a ``mesh`` every rank builds and runs
        the pipeline on ``mesh.device`` (``device`` is not read): the
        scorer (the default one as ``score_fasta(mesh=...)``, an injected
        one on every rank) and eref (``run_search(mesh=...)``) run on every
        rank, each on rank 0's decision whether to skip it, and every other
        stage on rank 0 alone."""
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.rank0 = mesh is None or mesh.rank == 0
        self.cfg = cfg
        self.runner = StageRunner(force=force)
        self.scorer = scorer
        self.out = cfg.output_files()
        self.out_dir = Path(cfg.out_dir)

    # ------------------------------------------------------------------
    def _default_scorer(self, fasta: str, out_path: str) -> int:
        import torch

        from palace_tpu_torch.models import gcn
        from palace_tpu_torch.models.scoring import resolve_dtype, score_fasta

        config = gcn.DEFAULT_CONFIG
        if self.cfg.gcn_model and os.path.isfile(self.cfg.gcn_model):
            params = gcn.load_torch_state_dict(self.cfg.gcn_model, config)
        elif self.cfg.score.allow_random_weights or os.environ.get(
                "PALACE_ALLOW_RANDOM_WEIGHTS"):
            logger.warning(
                "gcn_model checkpoint missing — scoring with RANDOM weights "
                "(explicitly allowed)"
            )
            params = gcn.init_params(torch.Generator().manual_seed(0), config)
        else:
            raise RuntimeError(
                f"gcn_model checkpoint not found: {self.cfg.gcn_model!r}. "
                "Scores from random weights are garbage; point config key "
                "gcn_model at GCN_model_retrained.pt, or opt in explicitly "
                "with score.allow_random_weights=true / "
                "PALACE_ALLOW_RANDOM_WEIGHTS=1."
            )
        return score_fasta(
            params, fasta, out_path, config,
            batch_size=self.cfg.score.batch_size,
            dtype=resolve_dtype(self.cfg.score.dtype),
            fuse_k=self.cfg.score.fuse_k if self.mesh is None else 1,
            device=self.device, mesh=self.mesh,
        )

    # ------------------------------------------------------------------
    def _stage(self, name: str, fn, outputs, allow_empty: bool = False,
               collective: bool = False):
        """Run one sub-step through the StageRunner — skip-if-exists when
        ``force`` is off (palace:140-149), always re-run when on.  Under a
        mesh a host stage runs on rank 0 alone; a ``collective`` stage runs
        on every rank or on none, as rank 0 decides from the files it sees
        (ranks that saw the file system at different moments would disagree,
        and a rank left out of a collective hangs the others)."""
        stage = Stage(name, fn, outputs, allow_empty)
        if self.mesh is None:
            return self.runner.run(stage)
        if collective:
            runs = self._rank0_says(self.runner.force or not stage.is_complete())
            if runs and not self.rank0:
                fn()
        return self.runner.run(stage) if self.rank0 else None

    def _rank0_says(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank of the mesh."""
        t = torch.tensor([int(flag and self.rank0)], device=self.device)
        return bool(all_reduce_(t, self.mesh.group_all).item())

    def _barrier(self) -> None:
        """Every rank of the mesh waits for the others (nothing without one)."""
        if self.mesh is not None and self.mesh.group_all is not None:
            dist.barrier(group=self.mesh.group_all)

    def _host(self, step) -> None:
        """A host step: on rank 0 alone under a mesh, the others waiting."""
        if self.rank0:
            step()
        self._barrier()

    def step1_qc(self) -> None:
        o1, o2 = self.out["filter_fastq1"], self.out["filter_fastq2"]

        def _run() -> None:
            ran = external.run_fastp(
                self.cfg.fastq1, self.cfg.fastq2, o1, o2, self.cfg.threads,
                o1.parent / f"{self.cfg.prefix}_fastp.json",
                o1.parent / f"{self.cfg.prefix}_fastp.html",
            )
            if not ran:
                if file_exists_with_content(o1) and file_exists_with_content(o2):
                    logger.warning(
                        "fastp unavailable — keeping pre-staged QC outputs")
                    return
                raise RuntimeError(
                    "fastp unavailable and QC outputs not pre-staged: "
                    f"{o1}, {o2}"
                )

        self._stage("qc", _run, [o1, o2])

    def step2_assembly(self) -> None:
        contigs = self.out_dir / "02-assembly" / "contigs.fasta"
        fasta = self.out["assembly_fasta"]
        fastg = self.out["assembly_fastg"]
        bam = self.out["first_bam"]

        def _assemble() -> None:
            if not external.run_spades_meta(
                self.out["filter_fastq1"], self.out["filter_fastq2"],
                self.out_dir / "02-assembly", self.cfg.threads,
            ):
                if file_exists_with_content(contigs):
                    logger.warning(
                        "SPAdes unavailable — keeping pre-staged assembly")
                    return
                raise RuntimeError(
                    f"SPAdes unavailable and assembly not pre-staged: {contigs}"
                )

        self._stage("assembly", _assemble, [contigs])
        self._stage("fastg2fa", lambda: fastg_to_node_fasta(fastg, fasta), [fasta])
        for f in (fasta, fastg):
            if not Path(str(f) + ".fai").exists():
                build_fai(f)

        def _align() -> None:
            if not external.run_bwa_samtools(
                fasta, self.out["filter_fastq1"], self.out["filter_fastq2"],
                bam, self.cfg.threads,
            ):
                if file_exists_with_content(bam):
                    logger.warning(
                        "bwa/samtools unavailable — keeping pre-staged BAM")
                    return
                raise RuntimeError(
                    f"bwa/samtools unavailable and BAM not pre-staged: {bam}"
                )

        self._stage("align", _align, [bam])

    def step3_search(self) -> None:
        search_dir = self.out_dir / "03-search"
        if self.rank0:
            search_dir.mkdir(parents=True, exist_ok=True)
        fasta = self.out["assembly_fasta"]

        self._stage(
            "gene_matches",
            lambda: find_phage_gene_matches(
                fasta, self.cfg.protein_db, search_dir, self.cfg.threads),
            [self.out["hit_out"]],
        )

        def _score() -> None:
            scorer = self.scorer or self._default_scorer
            scorer(str(fasta), str(self.out["node_score"]))

        self._stage("score", _score, [self.out["node_score"]], collective=True)

        def _index():
            return load_or_build_index(self.cfg.phagedb, self.cfg.kmer.k,
                                       self.cfg.kmer.coder_seed)

        def _eref() -> None:
            # under a mesh rank 0 builds and saves the index before the
            # others load it
            index = _index() if self.rank0 else None
            self._barrier()
            run_search(
                self.out["filter_fastq1"], self.out["filter_fastq2"], index or _index(),
                self.cfg.kmer, self.out["ref_names"], device=self.device, mesh=self.mesh,
            )

        self._stage("eref", _eref, [self.out["ref_names"]], collective=True)

        refs = self.out["phage_refs"]

        def _extract_refs() -> None:
            if not Path(str(self.cfg.phagedb) + ".fai").exists():
                build_fai(self.cfg.phagedb)
            extract_reference_sequences(
                self.cfg.phagedb, self.out["ref_names"], refs,
                self.out["ref_percent"],
            )
            if file_exists_with_content(refs):
                build_fai(refs)
            else:
                logger.warning(
                    "No reference sequences found — pipeline continues "
                    "without reference-based steps"
                )
                Path(str(refs) + ".fai").touch()

        # the ref FASTA is legitimately empty when eref reported nothing
        self._stage("extract_refs", _extract_refs, [refs], allow_empty=True)

    # ------------------------------------------------------------------
    def step4_graph_match(self) -> Dict[str, Path]:
        cfg = self.cfg
        match_dir = self.out_dir / "04-match"
        match_dir.mkdir(parents=True, exist_ok=True)
        fasta = self.out["assembly_fasta"]
        refs = self.out["phage_refs"]
        has_refs = file_exists_with_content(refs)
        prefix = cfg.prefix

        # 4.1 blast contigs vs refs (layout A)
        blast_out = Path(str(fasta) + ".blast")

        def _blast_contigs() -> None:
            if has_refs and external.run_makeblastdb(refs, refs):
                external.run_blastn(fasta, refs, blast_out, cfg.threads,
                                    external.OUTFMT_A)
            else:
                blast_out.touch()

        self._stage("blast_contigs", _blast_contigs, [blast_out],
                    allow_empty=True)

        # 4.2 depth
        bam = self.out["first_bam"]
        depth_file = Path(str(bam) + ".depth")
        depth_gz = Path(str(depth_file) + ".gz")

        def _depth() -> None:
            if file_exists_with_content(depth_gz) and not self.runner.force:
                return  # pre-staged bgzip depth (reference tabix artifact)
            compute_depth_file(bam, depth_file)

        if file_exists_with_content(depth_gz) and not file_exists_with_content(depth_file):
            self._stage("depth", _depth, [depth_gz])
        else:
            self._stage("depth", _depth, [depth_file])
        store = DepthStore.read_text(
            depth_file if depth_file.exists() else depth_gz
        )
        first_depth = store.global_average()
        logger.info("Average sequencing depth: %s", first_depth)

        # 4.3 junction graph
        graph_file = self.out["graph"]
        self._stage(
            "graph",
            lambda: build_graph(bam, str(self.out["assembly_fastg"]) + ".fai",
                                graph_file, first_depth),
            [graph_file],
        )

        # 4.4 filter graph
        filtered = self.out["filtered_graph"]

        def _filter_graph() -> None:
            pre = match_dir / f"{prefix}_filtered_graph_pre.txt"
            filter_graph(
                str(self.out["assembly_fastg"]) + ".fai", graph_file, pre,
                self.out["hit_out"], self.out["node_score"], blast_out,
                cfg.blast_ratio, str(fasta) + ".fai",
                match_dir / "all_hit_segs.txt",
                self.out_dir / "02-assembly" / "contigs.paths",
                cfg.score.score_threshold,
            )
            uniq_file(pre, filtered)

        self._stage("filter_graph", _filter_graph, [filtered])

        # 4.5 matching
        linear = match_dir / f"{prefix}_linear.txt"
        cycle = match_dir / f"{prefix}_cycle.txt"
        cycle_nodup = match_dir / f"{prefix}_cycle_nodup.txt"
        all_result = match_dir / f"{prefix}_all_result.txt"

        def _matching() -> None:
            solve_graph_file(
                filtered, linear, cycle,
                MatchingOptions(
                    iterations=cfg.matching_iters, single_graph=True,
                    hints_path=str(self.out_dir / "02-assembly" / "contigs.paths"),
                    exact=(None if cfg.matching_exact == ""
                           else cfg.matching_exact == "1"),
                    aggressive=bool(cfg.matching_aggressive),
                ),
            )
            remove_duplicate_pairs(cycle, cycle_nodup)
            with open(all_result, "w") as out:
                out.write(open(linear).read())
                out.write(open(cycle_nodup).read())

        self._stage("matching", _matching, [all_result], allow_empty=True)

        filtered_fasta = match_dir / f"{prefix}_filtered.fasta"
        filtered_cycle = match_dir / f"{prefix}_filtered_cycle.txt"
        self._stage(
            "filter_result",
            lambda: filter_result(
                fasta, all_result, filtered_fasta, blast_out,
                cfg.filter_blast_ratio, self.out["hit_out"],
                self.out["node_score"], filtered_cycle,
            ),
            [filtered_fasta, filtered_cycle],
            allow_empty=True,
        )

        filtered_blast = Path(str(filtered_fasta) + ".blast")

        def _blast_filtered() -> None:
            if has_refs and file_exists_with_content(filtered_fasta) and \
                    external.run_makeblastdb(refs, refs):
                external.run_blastn(filtered_fasta, refs, filtered_blast,
                                    cfg.threads, external.OUTFMT_B)
            else:
                filtered_blast.touch()

        self._stage("blast_filtered", _blast_filtered, [filtered_blast],
                    allow_empty=True)
        return {
            "depth_store": store,
            "filtered_graph": filtered,
            "filtered_fasta": filtered_fasta,
            "filtered_blast": filtered_blast,
            "cycle_nodup": cycle_nodup,
            "blast_out": blast_out,
            "has_refs": has_refs,
        }

    # ------------------------------------------------------------------
    def step5_second_pass(self, s4: Dict) -> None:
        cfg = self.cfg
        prefix = cfg.prefix
        furth = self.out_dir / "05-furth"
        sm_dir = furth / "second_match"
        sm_dir.mkdir(parents=True, exist_ok=True)
        fasta = self.out["assembly_fasta"]

        need_second = furth / "need_second_match.txt"
        if s4["has_refs"]:
            generate_second_with_blast(s4["filtered_blast"], need_second)
        else:
            need_second.touch()

        create_sub_graphs(
            s4["filtered_graph"], sm_dir / prefix, need_second,
            s4["depth_store"], s4["blast_out"], furth / "similar_ref.txt",
            self.out["ref_percent"],
        )

        subgraphs = sorted(sm_dir.glob("*.second"))
        logger.info("Found %d subgraph(s) to process", len(subgraphs))

        def _one(fullname: Path) -> None:
            second = str(fullname)[: -len(".second")]
            refname = Path(second).name
            refname = refname[refname.find("_ref") + 4 :]
            if refname.endswith("ref"):
                refname = refname[:-3]
            self._process_subgraph(fullname, second, refname, s4)

        # The reference runs this loop serially (palace:672-806) though
        # every subgraph is independent (distinct file names, read-only
        # shared inputs).  Thread pool: the heavy parts are external
        # RagTag/BLAST subprocesses, which release the GIL.  Host work
        # only: nothing here touches the device.
        workers = min(len(subgraphs), max(1, int(cfg.threads)))
        # shared lazy artifacts must exist BEFORE workers race on them
        if workers > 1 and file_exists_with_content(fasta):
            if not Path(str(fasta) + ".fai").exists():
                build_fai(fasta)
        # divide the per-process BLAST thread budget among workers
        self._blast_threads = max(1, int(cfg.threads) // workers)
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as pool:
                for _ in pool.map(_one, subgraphs):
                    pass
        else:
            for fullname in subgraphs:
                _one(fullname)

    def _process_subgraph(self, fullname: Path, second: str, refname: str, s4) -> None:
        cfg = self.cfg
        sm_dir = fullname.parent
        fasta = self.out["assembly_fasta"]
        linear = Path(f"{second}_linear.txt")
        cycle = Path(f"{second}_cycle.txt")
        solve_graph_file(
            fullname, linear, cycle,
            MatchingOptions(
                iterations=cfg.matching_iters, subgraph=True, aggressive=True,
                hints_path=str(self.out_dir / "02-assembly" / "contigs.paths"),
            ),
        )
        result_cycle = Path(f"{second}_result_cycle.txt")
        if file_exists_with_content(cycle):
            nodup = Path(f"{second}_cycle_nodup.txt")
            remove_duplicate_pairs(cycle, nodup)
            with open(result_cycle, "w") as out:
                out.write(open(linear).read())
                out.write(open(nodup).read())
        else:
            shutil.copy(linear, result_cycle)

        unfiltered = Path(f"{second}_unfiltered.fasta")
        make_fa_from_path(fasta, result_cycle, unfiltered, 1)

        if refname == "remain":
            scaffolds = self.out_dir / "02-assembly" / "scaffolds.fasta"
            rag_out = sm_dir / f"{refname}_ragtag"
            rag_txt = sm_dir / f"{refname}.rag.txt"
            if file_exists_with_content(scaffolds) and external.run_ragtag(
                scaffolds, unfiltered, rag_out
            ):
                agp = rag_out / "ragtag.scaffold.agp"
                if file_exists_with_content(agp):
                    filter_ragtag(agp, rag_txt, is_remain=True)
                else:
                    shutil.copy(result_cycle, rag_txt)
                parse_remain(
                    fullname, rag_txt, sm_dir / f"{refname}.result.txt",
                    0.6, cfg.min_len, Path(f"{second}_all_result_before_cut.txt"),
                    self.out["hit_out"],
                )
            else:
                logger.warning("scaffolds.fasta/RagTag unavailable — remain fallback")
                shutil.copy(result_cycle, sm_dir / f"{refname}.result.txt")
                shutil.copy(result_cycle, Path(f"{second}_all_result_before_cut.txt"))
            return

        # reference subgraph
        refs = self.out["phage_refs"]
        safe_ref = refname.replace("|", "_")
        ref_fasta = sm_dir / f"{safe_ref}.fasta"
        store = FastaStore(refs)
        if refname in store:
            with open(ref_fasta, "w") as fh:
                fh.write(f">{refname}\n{store.fetch(refname)}\n")
        store.close()

        part_txt = sm_dir / f"{safe_ref}_ragtag_scaffold_part.txt"
        scaffold_fa = sm_dir / f"{safe_ref}_ragtag_scaffold.fasta"
        rag_out = sm_dir / f"{safe_ref}_ragtag"
        ran_ragtag = external.run_ragtag(ref_fasta, unfiltered, rag_out)
        agp = rag_out / "ragtag.scaffold.agp"
        if ran_ragtag and file_exists_with_content(agp):
            filter_ragtag(agp, part_txt, is_remain=False)
            # extract the scaffolded record (palace:770-771)
            rag_fa = rag_out / "ragtag.scaffold.fasta"
            rag_store = FastaStore(rag_fa)
            target = f"{refname}_RagTag"
            with open(scaffold_fa, "w") as fh:
                if target in rag_store:
                    fh.write(f">{target}\n{rag_store.fetch(target)}\n")
            rag_store.close()
        else:
            get_main_path(fullname, result_cycle, part_txt)
            make_fa_from_path(fasta, part_txt, scaffold_fa, 1)

        # rename scaffold header to the path line (palace:784-785)
        first_line = open(part_txt).readline().strip("\n")
        content = open(scaffold_fa).read().replace(f"{refname}_RagTag", first_line)
        with open(scaffold_fa, "w") as fh:
            fh.write(content)

        scaffold_blast = Path(str(scaffold_fa) + ".blast")
        if external.run_makeblastdb(ref_fasta, ref_fasta):
            external.run_blastn(scaffold_fa, ref_fasta, scaffold_blast,
                                getattr(self, "_blast_threads", cfg.threads),
                                external.OUTFMT_B)
        elif cfg.dev_fabricate_blast or os.environ.get("PALACE_FABRICATE_BLAST"):
            # dev/test ONLY (config dev_fabricate_blast=1): fabricate
            # full-coverage hits so filter_by_blast can operate without
            # the blast toolchain.
            logger.warning(
                "blastn unavailable — FABRICATING full-coverage scaffold "
                "blast hits for %s (dev_fabricate_blast=1; results are NOT "
                "based on real alignments)", refname)
            self._fallback_scaffold_blast(scaffold_fa, ref_fasta, refname,
                                          scaffold_blast)
        else:
            # production degrade: empty blast output, exactly like the
            # reference when blast fails (palace:509-534)
            logger.warning(
                "blastn unavailable — writing empty scaffold blast for %s "
                "(set dev_fabricate_blast=1 to fabricate hits in dev runs)",
                refname)
            Path(scaffold_blast).touch()

        printed = filter_by_blast(
            scaffold_blast, s4["cycle_nodup"], str(fasta) + ".fai",
            Path(f"{second}_tmp.txt"), "0", 0.7, 2000,
            single_ref=refname,
            gene_hit=self.out["hit_out"], score=self.out["node_score"],
            before_cut=Path(f"{second}_all_result_before_cut.txt"),
        )
        with open(f"{second}_all_result.txt", "w") as fh:
            for line in printed:
                fh.write(line + "\n")

    def _fallback_scaffold_blast(self, scaffold_fa, ref_fasta, refname, out) -> None:
        """Write layout-B rows claiming full-length scaffold↔ref identity;
        keeps the pipeline runnable without the blast toolchain."""
        try:
            q_store = FastaStore(scaffold_fa)
            r_store = FastaStore(ref_fasta)
            slen = r_store.length(refname) if refname in r_store else 0
            with open(out, "w") as fh:
                for q in q_store.names():
                    qlen = q_store.length(q)
                    aln = min(qlen, slen) if slen else qlen
                    fh.write(
                        f"{q}\t{refname}\t100.0\t{qlen}\t{slen}\t{aln}\t0\t0\t"
                        f"1\t{aln}\t1\t{aln}\t0.0\t{aln}\n"
                    )
            q_store.close()
            r_store.close()
        except Exception:
            Path(out).touch()

    # ------------------------------------------------------------------
    def step6_final(self, s4: Dict) -> Path:
        cfg = self.cfg
        prefix = cfg.prefix
        final_dir = self.out_dir / "final_result"
        final_dir.mkdir(parents=True, exist_ok=True)
        sm_dir = self.out_dir / "05-furth" / "second_match"

        cycle_tmp = final_dir / "filtered_cycle_res_tmp.txt"
        filter_cycle_gene_score(
            self.out_dir / "04-match" / f"{prefix}_filtered_cycle.txt", 0,
            self.out["hit_out"], self.out["node_score"], cycle_tmp,
        )

        final_tmp = final_dir / f"{prefix}_final_tmp.txt"
        with open(final_tmp, "w") as out:
            if cycle_tmp.exists():
                out.write(open(cycle_tmp).read())

        parts = sorted(sm_dir.glob("*_ragtag_scaffold_part.txt"))
        if s4["has_refs"] and parts:
            find_most_common_result(
                sm_dir, self.out_dir / "05-furth" / "similar_ref.txt", final_tmp
            )

        remain_result = sm_dir / "remain.result.txt"
        if remain_result.exists():
            with open(final_tmp, "a") as out:
                out.write(open(remain_result).read())

        before_cut = final_dir / f"{prefix}_all_before_cut.txt"
        cuts = sorted(sm_dir.glob("*_all_result_before_cut.txt"))
        with open(before_cut, "w") as out:
            for c in cuts:
                out.write(open(c).read())

        filtered_final_tmp = final_dir / f"{prefix}_filtered_final_tmp.txt"
        filter_cycle_gene_score(
            final_tmp, 0, self.out["hit_out"], self.out["node_score"],
            filtered_final_tmp,
        )

        final_txt = final_dir / f"{prefix}_final.txt"
        corrected_dup(
            cycle_tmp, filtered_final_tmp, final_txt,
            str(self.out["assembly_fasta"]) + ".fai", s4["depth_store"],
            before_cut, cfg.min_len,
        )

        final_fa = self.out["final_fasta"]
        make_final_fa(
            final_txt, s4["filtered_graph"], self.out["assembly_fasta"],
            final_fa, prefix, trim_threshold=300, min_cycle_length=cfg.min_len,
        )
        logger.log(SUCCESS, "Final results: %s", final_fa)
        return final_fa

    # ------------------------------------------------------------------
    def run(self) -> Path:
        t0 = time.perf_counter()
        total = 6
        show_progress(1, total, "Quality Control")
        with StageTimer("step1.qc"):
            self._host(self.step1_qc)
        show_progress(2, total, "Assembly and Alignment")
        with StageTimer("step2.assembly"):
            self._host(self.step2_assembly)
        show_progress(3, total, "Reference and Protein Search")
        with StageTimer("step3.search"):
            self.step3_search()
        if self.rank0:
            show_progress(4, total, "Graph Construction and Matching")
            with StageTimer("step4.graph_match"):
                s4 = self.step4_graph_match()
            show_progress(5, total, "Further Assembly")
            with StageTimer("step5.second_pass"):
                self.step5_second_pass(s4)
            show_progress(6, total, "Generating Final Results")
            with StageTimer("step6.final"):
                final = self.step6_final(s4)
            self._report(final, time.perf_counter() - t0)
        self._barrier()
        return self.out["final_fasta"]

    def _report(self, final_fa: Path, wall_s: float) -> None:
        """End-of-run summary (reference report, palace:893-918) plus a
        machine-readable per-stage metrics artifact."""
        metrics_path = self.out_dir / f"{self.cfg.prefix}_metrics.json"
        GLOBAL_METRICS.dump_json(str(metrics_path))
        n_seqs = 0
        if final_fa.exists():
            with open(final_fa) as fh:
                n_seqs = sum(1 for line in fh if line.startswith(">"))
        logger.info("=" * 52)
        logger.info("Run complete: %d phage sequence(s) in %s", n_seqs, final_fa)
        logger.info("Total wall time: %.1f s", wall_s)
        for name, rec in sorted(GLOBAL_METRICS.stages.items()):
            if rec.items:
                logger.info("  %-24s %8.2fs  %10.1f %s/s",
                            name, rec.seconds, rec.throughput, rec.unit)
            else:
                logger.info("  %-24s %8.2fs", name, rec.seconds)
        logger.info("Per-stage metrics: %s", metrics_path)
        logger.info("=" * 52)


def run_pipeline(cfg: PalaceConfig, force: bool = False, scorer=None,
                 device: str = "cuda", mesh: Optional[Mesh] = None) -> Path:
    """The six steps to the final FASTA, whose path every rank returns once
    it is written (``PalacePipeline``)."""
    return PalacePipeline(cfg, force=force, scorer=scorer, device=device, mesh=mesh).run()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="palace_tpu_torch")
    ap.add_argument("--config", required=True)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu; there is no fallback between them")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        logger.error("%s", exc)
        return 1
    cfg = PalaceConfig.from_file(args.config)
    problems = cfg.validate()
    for p in problems:
        logger.error(p)
    if problems:
        return 1
    run_pipeline(cfg, force=args.force, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
