"""File formats the scoring stage reads and writes."""
