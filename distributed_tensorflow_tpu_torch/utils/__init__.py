"""Utilities of the port: the reference-format step logger."""
