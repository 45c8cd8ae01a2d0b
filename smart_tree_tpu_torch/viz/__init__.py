"""Host-side geometry for output files."""
