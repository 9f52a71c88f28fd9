"""setup_s: seconds from the process's start to the first timed query:
the database and queries from the seed, packing and placement, the kernel
library's build or load, and warm-up."""


def read(run):
    return run.setup_s
