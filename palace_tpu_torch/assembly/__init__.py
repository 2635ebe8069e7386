"""Path file → FASTA (the reference's make_fa_from_path.py)."""
from palace_tpu_torch.assembly.path_fa import make_fa_from_path
