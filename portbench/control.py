"""Readings that set a cell's limits (``limits/<workload>.json``), on the card.

    python3 -m portbench.control --workload <name> --seeds 1,2,... --control-seeds 7,8,9

For each of ``--seeds``: the cell's inputs, its units through the program
(one unit, or one request for each of the circuit's pairs), and the plain
reference's numbers for them: the sound readings.  For each of
``--control-seeds``: the reference itself put in the program's place, one
precision below the configuration's (bfloat16 for the card's float32,
float32 for the host's float64 closed forms), judged the same way: the
control's readings.  Prints one JSON line a seed and, last, each number's
largest sound reading and smallest control reading.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

from . import run, work


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = run.load_spec(Path.cwd(), args.workload)
    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device("cuda", 0)
    sound, control = {}, {}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    for seed, is_control in [(s, False) for s in seeds] + [(s, True) for s in control_seeds]:
        with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
            os.environ["PCR_REFERENCE_ROOT"] = os.path.join(tmp, "reference")
            runner = work.make(spec["base"], cfg, traffic, seed, dev, tmp)
            runner.setup()
            if is_control:
                outs = runner.control(torch.bfloat16)
                outputs = outs if isinstance(outs, list) else [outs]
            else:
                outputs = [runner.unit(k) for k in range(runner.control_units())]
            runner.release()
            nums = runner.judge(outputs)
            del runner, outputs
            torch.cuda.empty_cache()
        side = control if is_control else sound
        for k, v in nums.items():
            side.setdefault(k, []).append(v)
        print(json.dumps({"seed": seed, "control": is_control, "numbers": nums}), flush=True)
    summary = {k: {"sound_max": max(sound.get(k, [float("nan")])),
                   "control_min": min(control.get(k, [float("nan")]))}
               for k in sorted(set(sound) | set(control))}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
