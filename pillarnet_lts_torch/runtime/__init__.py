"""Weight conversion and serving for the port."""
