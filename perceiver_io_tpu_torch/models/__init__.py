"""Task models of the port."""
