"""The graph stage: the junction graph and per-base depth from a BAM
(``builder``, ``depth``, the native program through ``native``), and
the graph filter (``filter``)."""
from palace_tpu_torch.graph.builder import GraphParams, build_graph_from_bam, write_graph_output
from palace_tpu_torch.graph.depth import DepthStore, average_depth_of_file, compute_depth
