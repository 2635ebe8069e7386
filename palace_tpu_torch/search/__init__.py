"""The eref k-mer reference search: phage index and the two-phase scan."""
from palace_tpu_torch.search.index import PhageIndex, build_index, load_or_build_index
from palace_tpu_torch.search.eref import count_reads_into_table, search_references, write_ref_names
