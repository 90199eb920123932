"""Launch entry points of the port (training, serving, the data mesh)."""
