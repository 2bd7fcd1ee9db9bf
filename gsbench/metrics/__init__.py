"""One reader a metric: read(ctx) -> float, or None where the run has
nothing for it to read (gsbench.harness.Context)."""
