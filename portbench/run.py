"""One run of one cell of the port's benchmark.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Reads ``BENCHMARK.json``, finds the cell, its
configuration (``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<traffic>.json``) and the runner of the mix's kind
(``portbench/kinds/<kind>.py``), its limits
(``portbench/limits/<workload>.json``), the readers of its end-to-end
metrics (``portbench/end_to_end/<metric>.py``) and, with ``--trace 1``, of
its per-layer metrics (``portbench/metrics/<metric>.py``, or the file of the
name's part before its first dot), all by name.  Then:

1. checks the card (CUDA present, enough devices) and the program
   (``pcr_tpu_torch`` importable); exits 1 without a result otherwise;
2. set-up: the inputs from ``--seed``, the program's kernels built or
   loaded from ``build/`` inside the checkout, one warm unit of every shape
   the traffic uses (``setup_s`` runs from the start of this process to
   here);
3. the window: whole units until ``--seconds`` have passed since it opened,
   each ending in ``torch.cuda.synchronize()``; the window closes at the end
   of the last unit that started inside it.  ``--trace 1`` runs the window
   under ``torch.profiler`` with the readers' spans installed, for at most
   the traffic's ``trace_units`` units;
4. reads the peak device memory, frees the program's state, and hands the
   answers of every unit to the plain reference (``reference.py``, through
   the runner's ``judge``): each compared number is printed beside its
   limit on standard error and in the result's ``checks``, which comes last;
5. refuses to print a result if ``jax``, ``jaxlib``, ``flax`` or the JAX
   package ``pcr_tpu`` is in ``sys.modules`` (whole top-level names), and
   prints the result line last on standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pcr_tpu")
PROGRAM = "pcr_tpu_torch"


class Refused(Exception):
    """The run cannot give a result (no card, no program, a bad name)."""


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``modules`` (default ``sys.modules``) that are JAX
    or the JAX package, compared whole: ``pcr_tpu_torch`` is not
    ``pcr_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_spec(root: Path, workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and per-layer metric
    entries, found by name from ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    base = root / HERE.name
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"base": base, "bench": bench, "cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer}


def load_reader(base: Path, name: str):
    """The per-layer reader of metric ``name``: ``<base>/metrics/<name>.py``,
    or else the file of the name's part before its first dot, which every
    ``<part>.<suffix>`` metric then shares."""
    from .work import load_file

    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        path = base / "metrics" / f"{name.split('.')[0]}.py"
    return load_file(path, f"portbench_metric_{name}")


def end_to_end(base: Path, entries, units, window_s: float, setup_s: float) -> dict:
    """{name: (value, unit)} of the end-to-end metrics ``entries`` of a window
    of ``units`` (start, end, work), each read by
    ``<base>/end_to_end/<name>.py``."""
    from .work import load_file

    out = {}
    for m in entries:
        path = base / "end_to_end" / f"{m['name']}.py"
        if not path.is_file():
            raise Refused(f"no reader {path} for end-to-end metric {m['name']!r}")
        reader = load_file(path, f"portbench_e2e_{m['name']}")
        out[m["name"]] = (float(reader.read(units, window_s, setup_s)), m["unit"])
    return out


def run_window(runner, seconds: float, max_units: int | None = None):
    """Whole units until ``seconds`` have passed: [(start, end, work)], the
    window's length, and the units' answers."""
    units, outputs = [], []
    t0 = time.perf_counter()
    k = 0
    while True:
        a = time.perf_counter()
        if units and (a - t0 >= seconds or (max_units is not None and len(units) >= max_units)):
            break
        out = runner.unit(k)
        b = time.perf_counter()
        units.append((a, b, runner.work(out)))
        outputs.append(out)
        k += 1
    return units, units[-1][1] - t0, outputs


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(count)))}


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def check_lines(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limit met, every limited
    number present."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = nums.get(name)
        v = None if v is None else float(v)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and v == v and v <= limit
    return ok, checks


def main(argv=None, root: Path | None = None, fault=None) -> int:
    """Run one cell once; returns the exit code.  ``fault``: a context
    manager factory planted under the timed path (the fault tests)."""
    args = parse(argv)
    root = Path.cwd() if root is None else root
    try:
        spec = load_spec(root, args.workload)
        cell, cfg, traffic = spec["cell"], spec["config"], spec["traffic"]
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"needs {cell['chips']} CUDA device(s); torch sees "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        if importlib.util.find_spec(PROGRAM) is None:
            raise Refused(f"the program {PROGRAM} is not importable from {root}")
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    # the run's files (the program's pose files, the PCD scans it reads) go
    # under TMPDIR and are removed at the end; the program reads its
    # reference root when it is first imported, which is below
    workdir = tempfile.mkdtemp(prefix=f"portbench-{args.workload}-")
    os.environ["PCR_REFERENCE_ROOT"] = os.path.join(workdir, "reference")
    # any extension or Triton cache lives at a fixed path inside the checkout
    # (the program builds its own kernels under build/ there already)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    try:
        return _run(args, spec, cell, cfg, traffic, workdir, torch, fault)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(args, spec, cell, cfg, traffic, workdir, torch, fault) -> int:
    import contextlib

    from . import trace as trace_mod
    from . import work

    # float32 stays float32: no TF32 in the program's matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    runner = work.make(spec["base"], cfg, traffic, args.seed, dev, workdir)
    readers = {}
    if args.trace:
        readers = {m["name"]: (load_reader(spec["base"], m["name"]), m["unit"])
                   for m in spec["per_layer"]}
    fault_ctx = fault() if fault is not None else contextlib.nullcontext()
    with fault_ctx:
        t_inputs = time.perf_counter()
        runner.setup()
        t_warm = time.perf_counter()
        runner.unit(0)                        # warm: every shape the traffic uses
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        if args.trace:
            wraps = {}
            for r, _ in readers.values():
                wraps.update(getattr(r, "WRAPS", {}))
            w = trace_mod.Wraps(wraps)
            with w.installed(), trace_mod.profiler() as prof:
                with torch.profiler.record_function(trace_mod.SPAN_PREFIX + "window"):
                    units, window_s, outputs = run_window(runner, args.seconds,
                                                          traffic.get("trace_units"))
                torch.cuda.synchronize()
        else:
            units, window_s, outputs = run_window(runner, args.seconds)
    device = device_info(torch, cell["chips"])
    result = {"attempted": sum(u[2] for u in units), "failed": 0}
    if args.trace:
        busy, spans, kernels, gaps = trace_mod.reduce(prof, list(wraps))
        tr = trace_mod.Trace(window_s=window_s, busy_s=busy, units=len(units),
                             work=result["attempted"], spans=spans, shapes=w.shapes,
                             outputs=outputs)
        metrics = {}
        for name, (r, unit) in readers.items():
            v = r.read(tr)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}
        device.update(busy_s=busy, window_s=window_s)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
        # a kernel's name is its C++ signature; its first 120 characters name it
        result["breakdown"] = {"device_ops": [[n[:120], s] for n, (s, _) in top],
                               "idle_gaps": [[n, s] for n, s in gaps]}
        del prof
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in
                   end_to_end(spec["base"], spec["end_to_end"], units, window_s,
                              setup_s).items()}
    runner.release()
    torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums = runner.judge(outputs)
    secs = sorted(b - a for a, b, _ in units)
    print(f"portbench: set-up {setup_s:.3f} s (imports and card {t_inputs - T_START:.3f}, "
          f"inputs {t_warm - t_inputs:.3f}, warm unit {T_START + setup_s - t_warm:.3f}), "
          f"window {window_s:.3f} s over {len(units)} units (min {secs[0]:.4f}, median "
          f"{secs[len(secs) // 2]:.4f}, max {secs[-1]:.4f} s), check "
          f"{time.perf_counter() - t_check:.3f} s; host threads {torch.get_num_threads()}, "
          f"cores {len(os.sched_getaffinity(0))}", file=sys.stderr)
    correct, checks = check_lines(nums, spec["limits"])
    if not correct:
        result["failed"] = result["attempted"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 1
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    print(json.dumps(line))
    return 0
