"""Launch entry points of the port (serving)."""
