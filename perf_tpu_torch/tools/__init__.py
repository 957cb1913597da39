"""Command-line tools of the port (benchmarks)."""
