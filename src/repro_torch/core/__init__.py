"""Compile-and-admit path of the port (isolated placement)."""
