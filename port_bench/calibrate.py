"""The readings a cell's limits are set from, on the card at the cell's
own size; the benchmark's own runs never run this.

    python3 -m port_bench.calibrate --workload <cell> --seeds S1,S2,... \\
        [--controls N] [--faults N] [--seconds 2] [--out FILE]

For each seed, set-up as a run makes it (events, weights, the trainer's
two checked calls, or the captured forward and a short closed loop of
``--seconds`` at the cell's load) and the numbers of the check: the
*sound* readings.  On the first ``--controls`` seeds, the reference in
float8 (e4m3, one scale a tensor) in the program's place: the control.
On the first ``--faults`` seeds, each fault of :mod:`port_bench.faults`
that the cell can have, planted under the timed path.  One JSON line a
reading, then the summary: the largest sound reading of each number and
the least of the control and of each fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

CONTROL = "float8_e4m3"


def _reading(cell, seed: int, seconds: float, device, control=False,
             fault=None) -> dict:
    from port_bench import faults, run

    planted = (faults.planted(fault) if fault else contextlib.nullcontext())
    t = time.perf_counter()
    with planted:
        s = run.session(cell, seed, device)
    if cell.traffic["driver"] == "train":
        numbers = (s.check(program_run=s.control(CONTROL)) if control
                   else s.check())
    else:
        s.window(seconds)
        numbers = s.check(cell.limits, CONTROL if control else None)[0]
    s.free_program()
    kind = "control" if control else (fault or "sound")
    return dict(kind=kind, seed=seed, seconds=time.perf_counter() - t,
                **numbers, details=getattr(s, "details", None))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("port_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from port_bench import faults, manifest, program

    cell = manifest.load_cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(x) for x in args.seeds.split(",")]
    with contextlib.redirect_stdout(sys.stderr):
        program.load_library()
    readings = []
    kinds = faults.TRAIN if cell.traffic["driver"] == "train" else faults.INFER
    jobs = ([(s, False, None) for s in seeds]
            + [(s, True, None) for s in seeds[:args.controls]]
            + [(s, False, f) for f in kinds if f != "unchanged"
               for s in seeds[:args.faults]])
    for seed, control, fault in jobs:
        with contextlib.redirect_stdout(sys.stderr):
            r = _reading(cell, seed, args.seconds, device, control, fault)
        readings.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "details"}),
              flush=True)
    names = [k for k in readings[0]
             if k not in ("kind", "seed", "seconds", "details")]
    summary = {}
    for kind in sorted({r["kind"] for r in readings}):
        rows = [r for r in readings if r["kind"] == kind]
        pick = max if kind == "sound" else min
        summary[kind] = {k: pick(r[k] for r in rows) for k in names}
        summary[kind]["n"] = len(rows)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "summary": summary}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"readings": readings, **out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
