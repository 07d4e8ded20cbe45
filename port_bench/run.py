"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for; without them it exits non-zero and prints no result.  ``setup_s``
runs from the start of this process (imports, the kernels' build on the
first run in a checkout, the events, the weights, the capture and the
checked calls) to the window.  ``--trace 0`` measures the cell's
end-to-end metrics over ``--seconds``; ``--trace 1`` profiles a short
steady slice in place of the window and reports the per-layer metrics.
Both then read the peak memory, free the program's state and hold what
set-up and the window produced against the plain reference
(:mod:`port_bench.judge`).  The result's last key, ``checks``, holds each
number compared with its limit; they are also the last lines on standard
error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed place inside the checkout (the
# program's own kernels build into build/gnn_fpga_tpu_torch/)
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "port_bench" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "port_bench" / "triton",
          "CUDA_CACHE_PATH": ROOT / "build" / "port_bench" / "cuda_cache"}
FORBIDDEN = {"jax", "jaxlib", "flax", "gnn_fpga_tpu"}


def parse_args(argv=None):
    p = argparse.ArgumentParser("port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """JAX, its libraries and the JAX package among the loaded modules,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def session(cell, seed: int, device):
    from port_bench import infer, train

    driver = {"train": train, "infer": infer}[cell.traffic["driver"]]
    return driver.Session(cell.config, cell.traffic, seed, device)


def traced_slice(s, cell, device_name: str):
    """Profile the mix's slice; the per-layer metrics, the trace."""
    from port_bench import manifest, program, readers, tracing, yardstick

    kind = cell.traffic["driver"]
    program.reset_launch_counts()
    if kind == "train":
        n = cell.traffic["trace_calls"]
        trace = tracing.profile(lambda: [s.call() for _ in range(n)])
        units, flops = n * cell.traffic["steps_per_call"], s.flops_per_step()
    else:
        n = -(-cell.traffic["trace_events"] // s.per_batch)
        run = {}
        trace = tracing.profile(lambda: run.update(s.loop(n_batches=n)))
        s.sample = run["sample"]
        units = len(run["latencies"]) * s.per_batch
        flops = s.flops_per_event()
    sl = readers.Slice(trace=trace, kind=kind, units=units,
                       useful_flops=flops, launches=program.launch_counts(),
                       shapes=s.shapes, peaks=yardstick.peaks(device_name),
                       capture_s=s.capture_s,
                       kernels=manifest.kernel_patterns(cell.root))
    values = {}
    for m in cell.per_layer:
        v = manifest.metric_reader(m["name"], cell.root)(sl)
        if v is None:
            readers.say(f"{m['name']}: nothing to read, left out")
        else:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    return values, trace, units


def measure(cell, seed: int, seconds: float, trace: bool, device,
            device_name: str) -> dict:
    """Set-up, the window or the traced slice, the check: the result
    line's fields (``checks`` last)."""
    import torch

    from port_bench import judge

    cuda = torch.device(device).type == "cuda"
    s = session(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    e2e = {}
    if trace:
        metrics, tr, units = traced_slice(s, cell, device_name)
        out["attempted"] = units
        out["metrics"] = metrics
    else:
        e2e = s.window(seconds)
        out["attempted"] = e2e["attempted"]
        out["failed"] = e2e.get("failed", 0)
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if v is None:
                raise RuntimeError(f"the cell's driver gives no {m['name']}")
            out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": device_name,
                   "count": 1, "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    s.free_program()
    if cell.traffic["driver"] == "train":
        numbers = s.check()
    else:
        numbers, failed = s.check(cell.limits)
        out["failed"] += failed
    ok, checks = judge.verdict(numbers, cell.limits)
    out["correct"] = ok and out["failed"] == 0
    out["device"] = device_info
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    from port_bench import manifest

    cell = manifest.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    with contextlib.redirect_stdout(sys.stderr):
        from port_bench import program, readers

        t = readers.lap("imports", T0)
        program.load_library()
        readers.lap("the program's kernels built or loaded", t)
        out = measure(cell, args.seed, args.seconds, bool(args.trace),
                      device, name)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the process loaded {bad}", file=sys.stderr)
        return 3
    print(f"port_bench: correct {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
