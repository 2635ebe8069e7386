"""score_bf16.mfu: score.mfu read in the bfloat16 cell, where it moves
contigs_per_s.bf16 (that cell's own rate, whose runs spread wider than the
float32 cell's)."""
from portbench.harness.cell import load_reader

read = load_reader("score.mfu")
