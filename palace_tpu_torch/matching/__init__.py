"""The conjugate-graph decomposition (the reference's bin/matching)."""
from palace_tpu_torch.matching.solver import MatchingOptions, solve_graph_file, solve_matching
