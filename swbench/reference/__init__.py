"""The plain reference: Smith-Waterman scores in plain PyTorch (``sw``)
and the comparison that decides a run's ``correct`` (``check``).  It
imports nothing of the engine under test and takes from a run only the
database arrays, the queries and the answers it judges."""
