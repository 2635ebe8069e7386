"""The pipeline's filter stages (steps 4-6): gene hits, result and
BLAST filters, the second pass's subgraphs, the cycle/gene/score gates,
the majority vote, the duplicate correction and the final FASTA."""
