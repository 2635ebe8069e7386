"""palace_tpu_torch — the PyTorch/CUDA port of palace_tpu for NVIDIA Hopper.

The JAX package ``palace_tpu`` stays the reference; this package is a
second implementation of its contig-scoring stage (contig FASTA →
``node_scores.out``) in PyTorch, with hand-written CUDA kernels for
``sm_90a`` in place of the Pallas TPU kernels:

* ``palace_tpu_torch.ops``    — host 2-bit packer, the transition-count
  encoder, and ``ops.kernels``: the three CUDA kernels (transition
  counts, SAGE rounds, conv head), each beside its plain PyTorch version.
* ``palace_tpu_torch.models`` — the GCN scorer (eval forward) and the
  scoring stage.
* ``palace_tpu_torch.io``     — FASTA reading and writing.

It imports neither JAX nor ``palace_tpu``.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; without a card
they raise instead of falling back.
"""

__version__ = "0.1.0"
