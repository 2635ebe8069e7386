"""The GCN phage-contig scorer and the scoring stage."""
