"""Host-side helpers of the port (profiling and timing)."""
