"""The benchmark of cudasw4_tpu_torch, the PyTorch and CUDA search engine.

One command runs one cell once, from the root of a checkout:

    python3 -m swbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the database model, its scale and placement, the scoring) and a traffic mix
(``traffic/<name>.json``: which queries, through which entry, in what
loop).  Every metric is read by a reader of its own, ``metrics/<name>.py``.
The harness finds all three by name, so a cell, a mix or a metric is added
by adding files.

Parts:

- ``spec``: the keys a configuration and a traffic mix may state, and the
  values the harness runs; a run stops on any other, so that nothing a
  file states is ignored;
- ``dbgen``: the database and the queries from ``--seed``;
- ``drive``: set-up, warm-up and the measured window over the engine;
- ``trace``: the reduction of a ``torch.profiler`` trace of the window;
- ``peaks``: the card's peaks and the roofline arithmetic;
- ``reference``: a plain PyTorch Smith-Waterman scorer, its substitution
  matrices (one file each, found by the configuration's ``matrix``) and
  the comparison that decides ``correct``; it imports nothing of the
  engine;
- ``control``: the lower-precision control, run by hand, never by a run.

The harness imports neither JAX nor the JAX package, and reads nothing of
the repository outside this folder but the engine it measures.
"""
