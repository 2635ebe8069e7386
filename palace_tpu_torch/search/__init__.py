"""The eref k-mer reference search: phage index and the two-phase scan."""
