"""File formats of the port: FASTA/FASTQ (and the native FASTQ loader),
BAM, FASTG, the SEG/JUNC graph file, path files and BLAST tables."""
