"""score_bf16.host_wait_ms: score.host_wait_ms read in the bfloat16 cell,
where it moves contigs_per_s.bf16."""
from portbench.harness.cell import load_reader

read = load_reader("score.host_wait_ms")
