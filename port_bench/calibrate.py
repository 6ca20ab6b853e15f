"""Readings that set the benchmark's numbers; the benchmark's own runs
never run this.

    python3 -m port_bench.calibrate control --workload <cell> \
        --seeds 1,2,3 --seconds 15
        each seed's run, with the lower-precision control's readings
        (reference.gpt2.fp8_mm put in the program's place, at the same
        prompts and tokens, or the same batches) and for training the
        half-batch fault's, one JSON line a seed, in one process;

    python3 -m port_bench.calibrate sweep --workload <open-loop cell> \
        --rates 4,5,6.25 --seconds 20
        one engine set up once, then one open-loop window a rate: the
        queue's depth through the window and the latencies by thirds,
        to find the highest rate at which the queue does not grow (the
        knee).

Each needs the card, as run.py does.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from port_bench import spec, stats


def control(bench, cell, seeds, seconds):
    from port_bench import run

    for seed in seeds:
        t = time.monotonic()
        out, line = run.run_cell(bench, cell, seed, seconds, 0,
                                 t_start=t, control=True)
        print(json.dumps({"seed": seed, "checks": line["checks"],
                          "metrics": line["metrics"],
                          "readings": out.readings,
                          "seconds": time.monotonic() - t}), flush=True)


def sweep(bench, cell, rates, seconds):
    import torch

    from port_bench import traffic
    from port_bench.drivers import serve

    w = bench.cell(cell)
    cfg, mix = bench.config(w), bench.traffic(w)
    s = serve.Serve(cfg, mix, 12345, "cuda")
    s.setup()
    try:
        for rate in rates:
            s.mix = dict(mix, rate_per_s=rate)
            s.stream = traffic.Mix(s.mix, cfg["vocab_size"], 12345)
            s.reqs = []
            depth, stop = [], threading.Event()

            def sample():
                while not stop.wait(0.25):
                    snap = s.eng.snapshot()
                    depth.append((time.monotonic(), snap["queue_depth"],
                                  snap["active_rows"]))

            th = threading.Thread(target=sample, daemon=True)
            th.start()
            s.window(seconds)
            stop.set()
            th.join()
            e2e, attempted, failed = s.metrics()
            third = seconds / 3
            ttft = [[(r.times[0] - r.due) * 1e3 for r in s.due
                     if r.times and k * third <= r.due - s.t0 < (k + 1) * third]
                    for k in range(3)]
            inside = [d for d in depth if s.t0 <= d[0] < s.t1]
            q = [d[1] for d in inside]
            n = max(1, len(q) // 4)
            print(json.dumps({
                "rate": rate, "attempted": attempted, "failed": failed,
                "e2e": e2e, "queue_first_quarter": sum(q[:n]) / n,
                "queue_last_quarter": sum(q[-n:]) / n,
                "queue_max": max(q, default=0),
                "active_mean": sum(d[2] for d in inside) / max(1, len(inside)),
                "ttft_p50_by_third_ms": [stats.percentile(x, 50) for x in ttft],
                "ttft_p95_by_third_ms": [stats.percentile(x, 95) for x in ttft],
            }), flush=True)
            serve._wait(lambda: s.eng.snapshot()["active_rows"] == 0
                        and s.eng.queue_depth == 0, 120)
    finally:
        s.close()
    torch.cuda.synchronize()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("control", "sweep"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1,2,3")
    p.add_argument("--rates", default="")
    p.add_argument("--seconds", type=float, default=15)
    args = p.parse_args(argv)
    bench = spec.Bench()
    seeds = [int(x) for x in args.seeds.split(",")]
    rates = [float(x) for x in args.rates.split(",") if x]
    if args.mode == "control":
        control(bench, args.workload, seeds, args.seconds)
    else:
        sweep(bench, args.workload, rates, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
