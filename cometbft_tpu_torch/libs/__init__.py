"""Runtime tooling of the port (the profiling endpoints)."""
