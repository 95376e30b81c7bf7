"""Readers of the benchmark's metrics, one file a metric or family of
metrics, found by the metric's name in BENCHMARK.json: metrics/<name>.py,
else metrics/<the name up to its first dot>.py.  Each has read(run), which
returns the number, or None where it finds nothing to read (the harness
then leaves the metric out of the line)."""
