"""Device compute: the transition-count encoder and the CUDA kernels."""
from palace_tpu_torch.ops.encoder import (
    encode_batch,
    encode_sequences,
    seq_to_kmer_locs,
    transition_features,
)
