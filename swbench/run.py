"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m swbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration and traffic files are checked first (``spec``):
a key or value the harness does not run stops the run.  Set-up (from
process start to the first timed query): the database and
queries from the seed, the engine's packing and placement, the kernel
library's build or load, and warm-up.  Then the window (``drive``), the
metrics of the cell (``--trace 0``: its end-to-end metrics; ``--trace 1``:
its per-layer metrics, read from a ``torch.profiler`` trace of the window),
the reference's judgement once the engine is freed, and the result: each
compared number beside its limit as the last lines of standard error, and
one JSON line as the last line of standard output.

It exits non-zero and prints no result without enough CUDA cards, outside a
checkout that holds the engine, or when JAX or the JAX package was loaded.
``--control int16`` runs the lower-precision control in place of the
engine's exact state (``control``); the benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level modules that must not be loaded in a run: JAX and the JAX
#: package, compared as whole names (the engine's own name begins with
#: the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "cudasw4_tpu")

#: The engine's switch of int16 state (its STATE16_ENV), which the
#: configuration's ``state`` sets.
STATE_ENV = "CUDASW4_TPU_TORCH_STATE16"


def forbidden_modules(names) -> list[str]:
    """The names among ``names`` whose top-level part is in FORBIDDEN."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m swbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("int16",), default=None)
    return p.parse_args(argv)


def load_cell(name: str, root: Path = ROOT):
    """(benchmark, cell, config, traffic) of workload ``name``: the cell of
    BENCHMARK.json, and the files its ``config`` and ``traffic`` name,
    checked (``spec``) so that the harness runs every key they state."""
    from .spec import check_config, check_traffic

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    check_config(config)
    check_traffic(traffic)
    if int(config["chips"]) != int(cell["chips"]):
        raise SystemExit(f"{name}: the cell asks for {cell['chips']} chips, its "
                         f"configuration states {config['chips']}")
    return bench, cell, config, traffic


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's metrics: end-to-end without trace, per-layer with it.  A
    metric with ``workloads`` belongs to the cells it lists; an end-to-end
    one without to every cell, a per-layer one without to every cell that
    reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def read_metric(name: str, run):
    """The value of metric ``name`` from its reader,
    ``metrics/<name>.py``'s ``read(run)``; None where it finds nothing."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"swbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(bench, cell, config, traffic, seed: int, seconds: float, trace: bool,
             devices, patch=None, t0: float = T0) -> dict:
    """One run of a cell on ``devices``.  ``patch(engine)``, where given,
    is called once the database is placed (the control, or a test's
    fault).  Returns {"result": the result line's object, its compared
    numbers last under "checks", "notes": lines for standard error}."""
    import torch

    from . import dbgen, drive, trace as tracing
    from .reference.check import judge

    # The configuration's state: int16 is the engine's int16 state with its
    # overflow re-score (``spec.STATES``), read when the engine is made.
    os.environ[STATE_ENV] = "1" if config["state"] == "int16" else "0"
    os.environ["CUDASW4_TPU_TORCH_DEBUG_CHECK"] = "0"
    cuda = torch.device(devices[0]).type == "cuda"
    db = dbgen.make_database(config, seed, devices[0],
                             members=traffic["queries"].get("member_lengths", ()))
    queries = dbgen.Queries(db.lengths, traffic["queries"], seed)
    engine = drive.engine_for(config, devices)
    drive.load(engine, db)
    if patch is not None:
        patch(engine)
    drive.warm_up(engine, traffic, db, queries)
    drive.sync(devices)
    setup_s = time.perf_counter() - t0

    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(torch.profiler.record_function(tracing.WINDOW_SPAN))
        window = drive.run_window(engine, traffic, db, queries, seconds, seed, traced=trace)
        drive.sync(devices)
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else None

    run = types.SimpleNamespace(  # what the metrics' readers see
        cell=cell, config=config, traffic=traffic, db=db, queries=queries,
        window=window, setup_s=setup_s, peak_bytes=peak, engine=engine, chips=len(devices),
        device_name=torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
        trace=tracing.from_profiler(prof) if prof is not None else None)
    metrics = {}
    for m in metrics_of(bench, cell["name"], trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu", "kind": run.device_name,
              "count": len(devices), "memory_peak_bytes": peak,
              "power_limit": power_limit() if cuda else None}
    result = {"correct": False, "attempted": window.sent, "failed": 0, "metrics": metrics,
              "device": device}
    if run.trace is not None:
        tr = run.trace
        w0, w1 = tr.window_ns
        busy = [tracing.measure(tr.clipped(tr.busy(d))) for d in tr.devices]
        device["busy_s"] = sum(busy) / len(devices) / 1e9
        device["window_s"] = (w1 - w0) / 1e9
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}

    del run, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    checks = judge(db, window.answers, window.sent, config, seed, devices[0])
    sampled, q_long = checks.pop("sampled")
    pairs_s, full_s = checks.pop("seconds")
    result["failed"] = checks.pop("failed")
    result["correct"] = all(v <= limit for v, limit in checks.values())
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    notes = [f"window: {window.units} calls, {window.sent} queries, {window.seconds:.3f} s; "
             f"set-up {setup_s:.3f} s; reference {time.perf_counter() - t1:.1f} s: "
             f"{len(window.answers)} answers' hits {pairs_s:.1f} s, full scans of queries "
             f"{sampled} ({sum(len(db.sequence(q)) for q in sampled)} residues) and of entry "
             f"{q_long}'s slice {full_s:.1f} s"]
    if window.latencies:
        lens = [int(db.lengths[q]) for q, _, _ in window.answers]
        top = max(lens)
        share = sum(t for t, n in zip(window.latencies, lens) if n == top) / sum(window.latencies)
        notes.append(f"query times: median {statistics.median(window.latencies) * 1e3:.3f} ms, "
                     f"{len(window.latencies)} queries; the longest ({top} aa) "
                     f"{100 * share:.1f}% of their sum")
    return {"result": result, "notes": notes}


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    bench, cell, config, traffic = load_cell(args.workload)
    # Every build and kernel cache inside the checkout, at fixed paths.
    cache = ROOT / "build" / "swbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"swbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    patch = None
    if args.control:
        from .control import int16_control as patch
    out = run_cell(bench, cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                   [torch.device("cuda", i) for i in range(chips)], patch=patch)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"swbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in out["notes"]:
        print(line, file=sys.stderr)
    for name, c in out["result"]["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
