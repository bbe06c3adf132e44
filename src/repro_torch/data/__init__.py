"""Graph data at scale: chunked R-MAT synthesis and partition containers."""
