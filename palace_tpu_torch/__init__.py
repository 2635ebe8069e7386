"""palace_tpu_torch — the PyTorch/CUDA port of palace_tpu for NVIDIA Hopper.

The JAX package ``palace_tpu`` stays the reference; this package is a
second implementation of the whole PALACE pipeline in PyTorch, with
hand-written CUDA kernels for ``sm_90a`` in place of the Pallas TPU
kernels:

    python -m palace_tpu_torch --config config.txt [--force] [--device cpu]

runs the six steps from a ``key=value`` config to the final phage FASTA:
the contig-scoring stage (contig FASTA → ``node_scores.out``) and the
eref k-mer reference search (reads + phagedb → ``ref_names.txt``) on the
card, and the host stages (BAM + FASTG → junction graph → matching →
filters → final FASTA) on the host.

* ``palace_tpu_torch.ops``    — host 2-bit packer, the transition-count
  encoder, k-mer hashing, the count table, the window scan, and
  ``ops.kernels``: the four CUDA kernels (transition counts, SAGE rounds,
  conv head, good windows), each beside its plain PyTorch version.
* ``palace_tpu_torch.models`` — the GCN scorer (eval forward) and the
  scoring stage; training (``models.train``: the training forward with
  dropout, optax's Adam, ``train_step`` and ``fit``) and its checkpoints
  (``models.checkpoint``).
* ``palace_tpu_torch.search`` — the phage index and the eref stage.
* ``palace_tpu_torch.io``     — FASTA/FASTQ (with the native FASTQ loader),
  BAM, FASTG, graph, path and BLAST files.
* ``palace_tpu_torch.graph``  — the junction graph and depth (the native
  ``palace_native`` program, or Python), and the graph filter.
* ``palace_tpu_torch.matching``, ``palace_tpu_torch.assembly`` — the
  graph decomposition and the path FASTA.
* ``palace_tpu_torch.filters`` — the filter stages of steps 4-6.
* ``palace_tpu_torch.pipeline`` — the stage engine, the external tools'
  wrappers and the six-step driver; ``config`` parses its config file.
* ``palace_tpu_torch.native`` — the host C++ sources and their g++ build.

It imports neither JAX nor ``palace_tpu``.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; without a card
they raise instead of falling back.  The host stages run on the host;
where g++ cannot build the native sources they take their Python
versions, which write the same files.
"""

__version__ = "0.1.0"
