"""Entry points of the port (serving so far)."""
