"""The general harness: cell discovery, the run, the trace and the
result line."""
