"""What a configuration and a traffic mix may state, and the values the
harness runs.

A run checks both files before its set-up: a key the harness does not
know, a missing one, or a value it does not run stops it with an error, so
that nothing a file states is silently ignored.  Keys in ``DESCRIPTIVE``
are read by people, not run.
"""

from __future__ import annotations

from .reference import scoring

DESCRIPTIVE = {"name", "source", "deployment", "scores", "reduced", "cuts", "assumed", "what"}

#: Configuration keys every file states, and the keys each choice adds.
CONFIG_KEYS = {"num_sequences", "length_model", "residues", "matrix", "gap_open", "gap_extend",
               "num_top", "state", "placement", "chips", "check_residues"}
LENGTH_MODELS = {
    # log-normal of the given median and sigma, clipped, drawn from length_seed
    "log-normal": {"median", "sigma", "min_length", "max_length", "length_seed"},
    # every entry of one length (runpeakbenchmark.sh's pseudo databases)
    "fixed": {"length"},
}
PLACEMENTS = {"resident": set(), "streamed": {"max_device_bytes", "stream_chunk_bytes"},
              "mesh": set()}
#: int32: exact state; int16: int16 state with the engine's overflow
#: re-score (align --dpx), exact too.
STATES = {"int32", "int16"}
RESIDUES = {"uniform"}

#: Traffic keys: the entry the window drives, the queries, the arrivals.
TRAFFIC_KEYS = {"entry", "queries"}
ENTRIES = {"scan", "scan_many"}
QUERY_KEYS = {"member_lengths", "quantiles", "longest_member", "fresh"}
ARRIVALS = {
    # one client sends the next query, or pass, when the last is answered
    "closed": set(),
    # queries due at exponential gaps of mean 1 / rate_per_s
    "poisson": {"rate_per_s"},
}


def _choice(what: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{what} {value!r} is not one of {sorted(allowed)}")


def _keys(what: str, data: dict, need: set, may: set = frozenset()) -> None:
    missing, unknown = need - set(data), set(data) - need - set(may) - DESCRIPTIVE
    if missing or unknown:
        raise ValueError(f"{what}: missing {sorted(missing)}, unknown {sorted(unknown)}")


def check_config(c: dict) -> None:
    """Raise ValueError unless the harness runs every key of configuration ``c``."""
    _keys("configuration", c, CONFIG_KEYS, set().union(*LENGTH_MODELS.values(),
                                                      *PLACEMENTS.values()))
    _choice("length_model", c["length_model"], LENGTH_MODELS)
    _choice("placement", c["placement"], PLACEMENTS)
    _keys(f"configuration of {c['length_model']} lengths placed {c['placement']}", c,
          CONFIG_KEYS | LENGTH_MODELS[c["length_model"]] | PLACEMENTS[c["placement"]])
    _choice("state", c["state"], STATES)
    _choice("residues", c["residues"], RESIDUES)
    _choice("matrix", c["matrix"], scoring.names())
    if not 0 < int(c["gap_extend"]) <= int(c["gap_open"]):
        raise ValueError(f"gaps need 0 < gap_extend <= gap_open, got {c['gap_open']}, "
                         f"{c['gap_extend']}")
    if int(c["num_top"]) < 1 or int(c["num_sequences"]) < 1:
        raise ValueError("num_top and num_sequences must be positive")


def check_traffic(t: dict) -> None:
    """Raise ValueError unless the harness runs every key of traffic mix ``t``."""
    _keys("traffic", t, TRAFFIC_KEYS, {"arrivals"})
    _choice("entry", t["entry"], ENTRIES)
    _keys("traffic queries", t["queries"], set(), QUERY_KEYS)
    arrivals = t.get("arrivals", {"kind": "closed"})
    _choice("arrivals kind", arrivals.get("kind"), ARRIVALS)
    _keys("arrivals", arrivals, {"kind"} | ARRIVALS[arrivals["kind"]])
