"""device.idle_share: the share of the traced window in which no kernel
and no copy ran on the fullest-loaded card, in %, in the cells that report
``gcups``."""


def read(run):
    return run.trace.idle_share() if run.trace else None
