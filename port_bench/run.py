"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout that holds the program
(container_engine_accelerators_tpu_torch/).  It loads, warms up,
measures for `--seconds` and prints, as the last line of its standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` `breakdown`, and last `checks`, each number
compared with its limit (also the last lines of standard error).

It refuses to run (exit 2, no result) without as many CUDA devices as
the cell asks for, and fails (exit 3, no result) if JAX, flax or the
JAX package was loaded into this process.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from port_bench import spec  # noqa: E402

# Top-level module names the process must not hold: compared whole, so
# the port (container_engine_accelerators_tpu_torch) is not among them.
FORBIDDEN = ("jax", "jaxlib", "flax", "container_engine_accelerators_tpu")

# Every cache a run may write, at fixed paths inside the checkout (the
# program's own kernel build directory is its package's _kernels_build/).
CACHE = os.path.join(spec.ROOT, ".port_bench_cache")


def forbidden_modules(modules=None):
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names.intersection(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(bench, cell, out, trace, device):
    """The contract's line (a dict, `checks` last)."""
    metrics = {}
    if trace:
        for m in bench.per_layer(cell):
            value = bench.reader(m).read(out.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench.end_to_end(cell):
            if m["name"] not in out.e2e:
                raise RuntimeError(f"the run gave no {m['name']}")
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": bool(out.correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if trace:
        trace = out.obs["trace"]
        line["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = trace.breakdown()
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in out.checks}
    return line


def run_cell(bench, name, seed, seconds, trace, device="cuda",
             t_start=None, control=False):
    """(driver outcome, result line) of one run of cell `name`; the chip
    look is main's, so a test can drive the rest on the CPU."""
    import torch

    cell = bench.cell(name)
    cfg, mix = bench.config(cell), bench.traffic(cell)
    out = spec.driver(cfg["kind"]).run(
        cfg, mix, seed, seconds, bool(trace), device=device,
        t_start=t_start, control=control)
    gpu = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
           "count": cell["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    return out, result_line(bench, cell, out, trace, dev)


def main(argv=None):
    args = parse(argv)
    # A run past its time limit leaves every thread's stack behind.
    faulthandler.dump_traceback_later(330, exit=False)
    bench = spec.Bench()
    cell = bench.cell(args.workload)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, line = run_cell(bench, args.workload, args.seed, args.seconds,
                         args.trace, t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    for name, value, limit in out.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
