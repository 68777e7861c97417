"""Debug summaries."""
