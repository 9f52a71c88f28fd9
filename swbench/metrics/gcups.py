"""gcups: the work of every query answered in the window (query residues
x real database residues) over the window's host seconds, from the first
query sent to the last answer on the host, in billions of cells a second
(the reference's makeBenchmarkStats)."""


def read(run):
    w = run.window
    return w.residues * run.db.residues / w.seconds / 1e9 if w.seconds > 0 else None
