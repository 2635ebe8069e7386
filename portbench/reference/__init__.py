"""Plain references the benchmark holds the port to.

Written in plain PyTorch and NumPy from the published semantics of
PALACE (phage_scoring.py's GCN, encode.pyx's transition features,
extract_ref.cpp's k-mer search).  Nothing here imports the package under
test, JAX or the JAX package, and nothing takes what the program made:
each reference works its inputs out again from what the benchmark
generated.
"""
