"""The database and the queries of a cell, from the configuration, the
traffic mix and ``--seed``.

Lengths come from the configuration's length model, the same for every
seed (``spec.LENGTH_MODELS``): a log-normal of the given median and sigma,
clipped to [min_length, max_length] and drawn from the fixed
``length_seed``, or one fixed length.  The traffic's ``member_lengths`` are
put in among them (each query of a query file is an entry of the database,
as the reference's queries are Swiss-Prot entries), sorted ascending as the
database format requires.  Residues are uniform over the 20 amino acids,
drawn from ``--seed`` on the given device in one call.  Every query is an
entry of the database, named by its id: its own hit is in every answer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: Codes 0..19 are the amino acids, 20 pads a sequence to a multiple of 4
#: (the database format's padding).
PAD = 20


@dataclass
class Database:
    """The arrays of a database in the engine's format (``DBData``'s
    fields), which the engine and the reference both read."""

    chars: np.ndarray  # int8 [sum of padded lengths]
    offsets: np.ndarray  # uint64 [n + 1]
    lengths: np.ndarray  # int32 [n], ascending

    @property
    def num_sequences(self) -> int:
        return len(self.lengths)

    @property
    def residues(self) -> int:
        return int(self.lengths.sum(dtype=np.int64))

    def sequence(self, i: int) -> np.ndarray:
        off = int(self.offsets[i])
        return self.chars[off : off + int(self.lengths[i])]


def model_lengths(db_spec: dict, members=()) -> np.ndarray:
    """The database's lengths: ``num_sequences - len(members)`` of the
    length model, and ``members``, sorted."""
    n = int(db_spec["num_sequences"]) - len(members)
    if db_spec["length_model"] == "fixed":
        lengths = np.full(n, int(db_spec["length"]), np.int32)
    else:
        rng = np.random.default_rng(int(db_spec["length_seed"]))
        draws = rng.lognormal(np.log(float(db_spec["median"])), float(db_spec["sigma"]), n)
        lengths = np.clip(draws, db_spec["min_length"], db_spec["max_length"]).astype(np.int32)
    lengths = np.concatenate([lengths, np.asarray(members, np.int32)])
    lengths.sort(kind="stable")
    return lengths


def make_database(db_spec: dict, seed: int, device, members=()) -> Database:
    """The database of ``db_spec`` with residues from ``seed``, drawn on
    ``device`` (a ``torch.Generator`` there) and brought to the host."""
    lengths = model_lengths(db_spec, members)
    padded = (lengths.astype(np.int64) + 3) // 4 * 4
    offsets = np.zeros(len(lengths) + 1, np.uint64)
    np.cumsum(padded, out=offsets[1:])
    total = int(offsets[-1])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    chars = torch.randint(0, 20, (total,), generator=gen, device=device,
                          dtype=torch.int8).cpu().numpy()
    # The padding after each sequence (0 to 3 places) holds PAD, as the
    # format's files do.
    ends = offsets[:-1].astype(np.int64) + lengths
    for d in range(3):
        chars[(ends + d)[lengths + d < padded]] = PAD
    return Database(chars=chars, offsets=offsets, lengths=lengths)


def query_ids(lengths: np.ndarray, spec: dict) -> list[int]:
    """Database entries that serve as the queries of a traffic mix's
    ``queries`` spec (round 0 of ``Queries``), in the mix's order:

    - ``member_lengths``: for each length, an entry of that length (the
      traffic put them in the database; repeated lengths take successive
      entries);
    - ``quantiles`` K: the entries at ranks (i + 0.5) / K of the sorted
      database, i = 0..K-1, so that the query lengths follow the database's
      own length model;
    - ``longest_member``: then the database's longest entry, a titin-class
      query whose own hit scores past int16 state's range."""
    ids: list[int] = []
    for length in spec.get("member_lengths", ()):
        i = int(np.searchsorted(lengths, length, side="left"))
        while i in ids:
            i += 1
        if i >= len(lengths) or lengths[i] != length:
            raise ValueError(f"no database entry of length {length}")
        ids.append(i)
    k = int(spec.get("quantiles", 0))
    ids += [int((i + 0.5) / k * len(lengths)) for i in range(k)]
    if spec.get("longest_member"):
        ids.append(len(lengths) - 1)
    return ids


class Queries:
    """The query entries of a traffic mix, round by round: ``query_ids``
    in every round, or with ``fresh``, in round r for each of them an entry
    of the same length drawn from ``seed`` and r, so that every round and
    every seed search the same lengths with other residues."""

    def __init__(self, lengths: np.ndarray, spec: dict, seed: int):
        self.base = query_ids(lengths, spec)
        self.seed = int(seed)
        # The entries of each query's length: a run of the sorted lengths.
        self.runs = ([(int(np.searchsorted(lengths, lengths[i], "left")),
                       int(np.searchsorted(lengths, lengths[i], "right"))) for i in self.base]
                     if spec.get("fresh") else None)

    def round(self, r: int) -> list[int]:
        if self.runs is None:
            return list(self.base)
        rng = np.random.default_rng([self.seed, r])
        return [int(lo + rng.integers(hi - lo)) for lo, hi in self.runs]
