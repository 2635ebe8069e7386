"""score_bf16.k3_roofline: score.k3_roofline read in the bfloat16 cell, where it moves
contigs_per_s.bf16 (that cell's own rate, whose runs spread wider than the
float32 cell's)."""
from portbench.harness.cell import load_reader

read = load_reader("score.k3_roofline")
