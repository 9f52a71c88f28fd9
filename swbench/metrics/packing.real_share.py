"""packing.real_share: real residues over the residue slots of the packed
tiles (tiles x L x lanes over every bucket), in %; the rest is padding,
which every kernel computes."""


def read(run):
    slots = sum(b.num_tiles * b.L * b.NS for b in run.engine.packed.buckets)
    return 100.0 * run.db.residues / slots if slots else None
