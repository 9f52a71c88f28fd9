"""The lower-precision control: the engine in int16 state, the nearest
precision below the configurations' exact int32 state, without the
overflow re-score that makes the engine's int16 mode exact.

Where the engine has int16 state of its own (a resident or sharded
database: ``state16``, the reference's 16-bit kernel families) it is
switched on and its re-score taken out, so a score that reaches SAT is
reported as the int16 state leaves it.  A streamed pass and a query past
QCAP always run int32 state, so there every score the engine reports is
held to int16's range as well (saturating at 32767).  Each traffic mix
holds the database's longest entry as a query, whose own hit scores past
int16's range, so the control has to come out not correct.

It runs only by hand (``python3 -m swbench.run ... --control int16``),
never in the benchmark's own runs.
"""

from __future__ import annotations

INT16_MAX = 32767


def _saturated(result):
    result.scores = [min(int(s), INT16_MAX) for s in result.scores]
    return result


def int16_control(engine) -> None:
    """Switch ``engine``, of a configuration in int32 state, to the control
    (see the module docstring)."""
    if engine.state16:
        raise ValueError("the int16 control is the control of int32 state; the engine "
                         "already runs int16 state")
    if not engine.streaming:
        engine.state16 = True
        engine._rescore_overflow = lambda tmaxes, vals, ids, codes: (vals, ids)
        engine._rescore_overflow_mesh = lambda tmaxes, vals, ids, codes: (vals, ids)
    scan, scan_many = engine.scan, engine.scan_many
    engine.scan = lambda seq: _saturated(scan(seq))
    engine.scan_many = lambda seqs, window=3: (_saturated(r) for r in scan_many(seqs, window))
