"""Runnable training recipes of the port (counterparts of the repo's
``examples/`` mains)."""
