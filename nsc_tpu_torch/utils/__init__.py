"""Host-side utilities (audio I/O)."""
