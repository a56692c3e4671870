"""Entry points of the port's probe tools (run with ``python -m``)."""
