"""The comparison that decides a run's ``correct``.

Every answer of the window is judged; each number below is a count of
answers, compared exactly (limit 0):

- ``wrong_score``: answers with a hit whose score is not the reference's
  score of that query and entry;
- ``misordered``: answers that are not the top ``num_top`` form: fewer or
  more hits than min(num_top, entries), an id twice or out of range, or
  hits not in descending score, then ascending id;
- ``wrong_top``: answers of the sampled queries that differ from the
  reference's own top ``num_top`` over the whole database, in ids, scores
  or order.  The sample is drawn from ``seed`` among the queries answered
  in the window: in the seed's order, each one that fits the remaining
  budget of query residues (the full scan costs query residues x
  database residues), at least the shortest;
- ``missed_own``: answers that leave out the query's own entry (every
  query is an entry of the database) though its exact score, which the
  reference computes, ranks it above the answer's last hit: an answer
  that cannot be the top ``num_top``, checked on every answer, so that the
  queries too long for the full scan are held to their whole database
  as well;
- ``outranked_long``: answers of one query too long for the budget that
  an entry left out of them outranks, among a 1/SLICES of the database
  that the reference scans whole.  The query (of those answered, by id)
  and the slice (the entries whose id is r modulo SLICES) rotate with
  ``seed``, so that runs on many seeds cover every long query and all of
  the database: scanning one whole takes longer than a run may;
- ``unanswered``: queries sent in the window that got no answer.
"""

from __future__ import annotations

import time

import numpy as np

from .sw import Scorer, top_n

#: The numbers and their limits: exact comparisons.
LIMITS = {"wrong_score": 0, "misordered": 0, "wrong_top": 0, "missed_own": 0,
          "outranked_long": 0, "unanswered": 0}

#: The long query's scan covers the entries of one residue class of ids.
SLICES = 32


def sample(query_ids, lengths, seed: int, budget: int) -> list:
    """Queries (of ``query_ids``, by their ``lengths``) for the full scan:
    in a seeded order, each that fits ``budget`` residues; at least the
    shortest."""
    ids = sorted(set(query_ids))
    order = np.random.default_rng(seed).permutation(len(ids))
    out, left = [], budget
    for k in order:
        if lengths[ids[k]] <= left:
            out.append(ids[k])
            left -= lengths[ids[k]]
    return out or [min(ids, key=lambda q: lengths[q])]


def judge(db, answers, sent: int, config: dict, seed: int, device) -> dict:
    """The numbers of a run.  ``db``: the database arrays (``chars``,
    ``offsets``, ``lengths``, ``sequence(i)``); ``answers``: [(the query's
    own entry id, scores, ids)] in the window; ``sent``: queries sent in
    the window; ``config``: the configuration (its matrix, gaps,
    ``num_top`` and ``check_residues``).  Returns {name: (value, limit)},
    the sampled queries under ``"sampled"``, the answers that fail any
    check, with the unanswered queries, under ``"failed"``, and the seconds
    of the pairs' and of the full scans' scoring under ``"seconds"``."""
    n = len(db.lengths)
    want_len = min(int(config["num_top"]), n)
    ref = Scorer(db.chars, db.offsets, db.lengths, device, config["matrix"],
                 -int(config["gap_open"]), -int(config["gap_extend"]))

    bad = {name: set() for name in LIMITS if name != "unanswered"}
    for k, (_, scores, ids) in enumerate(answers):
        s, i = np.asarray(scores, np.int64), np.asarray(ids, np.int64)
        ok = (len(s) == want_len == len(i) and len(set(i.tolist())) == len(i)
              and (len(i) == 0 or (i.min() >= 0 and i.max() < n))
              and np.array_equal(np.lexsort((i, -s)), np.arange(len(i))))
        if not ok:
            bad["misordered"].add(k)

    t0 = time.perf_counter()
    pairs = sorted({(q, int(i)) for q, _, ids in answers for i in ids if 0 <= int(i) < n}
                   | {(q, q) for q, _, _ in answers})
    exact = dict(zip(pairs, ref.pairs([db.sequence(q) for q, _ in pairs], [i for _, i in pairs])))
    for k, (q, scores, ids) in enumerate(answers):
        if any(exact.get((q, int(i))) != int(s) for s, i in zip(scores, ids)):
            bad["wrong_score"].add(k)
        so = exact[(q, q)]
        if q not in ids and len(ids) and (so, -q) > (int(scores[-1]), -int(ids[-1])):
            bad["missed_own"].add(k)

    t1 = time.perf_counter()
    picked = (sample([q for q, _, _ in answers], db.lengths, seed, int(config["check_residues"]))
              if answers else [])
    full = ref.database([db.sequence(q) for q in picked]) if picked else []
    best = {q: top_n(row, want_len) for q, row in zip(picked, full)}
    for k, (q, scores, ids) in enumerate(answers):
        if q in best and not (np.array_equal(np.asarray(scores, np.int64), best[q][0])
                              and np.array_equal(np.asarray(ids, np.int64), best[q][1])):
            bad["wrong_top"].add(k)

    longs = sorted({q for q, _, _ in answers if db.lengths[q] > int(config["check_residues"])})
    q_long = longs[seed % len(longs)] if longs else None
    if q_long is not None:
        part = np.arange((seed // len(longs)) % SLICES, n, SLICES)
        got = ref.database([db.sequence(q_long)], part)[0]
        for k, (q, scores, ids) in enumerate(answers):
            if q == q_long and len(ids):
                above = (got > int(scores[-1])) | ((got == int(scores[-1])) & (part < int(ids[-1])))
                if np.setdiff1d(part[above], np.asarray(ids, np.int64)).size:
                    bad["outranked_long"].add(k)

    out = {name: (len(ks), LIMITS[name]) for name, ks in bad.items()}
    out["unanswered"] = (sent - len(answers), LIMITS["unanswered"])
    out["sampled"] = (picked, q_long)
    out["failed"] = len(set().union(*bad.values())) + sent - len(answers)
    out["seconds"] = (t1 - t0, time.perf_counter() - t1)
    return out
