"""Measurement scripts of the port that need a GPU."""
