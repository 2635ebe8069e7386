"""File formats of the port: FASTA/FASTQ (and the native FASTQ loader),
BAM, FASTG, the SEG/JUNC graph file, path files and BLAST tables."""
from palace_tpu_torch.io.fasta import (
    FastaIndex,
    FastaStore,
    build_fai,
    iter_fasta,
    iter_fastq,
    read_fasta_dict,
    reverse_complement,
    write_fasta,
)
from palace_tpu_torch.io.graph_io import (
    Graph,
    JuncRecord,
    SegRecord,
    parse_graph_file,
    write_graph_file,
)
from palace_tpu_torch.io.paths_io import (
    PathLine,
    iter_path_lines,
    oriented_tokens,
    parse_spades_paths,
    path_signature,
    reverse_flip,
    split_concatenated_path,
    strip_tags,
)
from palace_tpu_torch.io.blast import BlastHit, read_outfmt6
