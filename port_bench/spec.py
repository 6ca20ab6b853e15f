"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (port_bench/configs/<config>.json) and a
traffic mix (port_bench/traffic/<traffic>.json); a configuration's
`kind` names its driver (port_bench/drivers/<kind>.py); a per-layer
metric is a reader of its own (port_bench/metrics/<name>.py, with a
`read(obs)` that returns a number or None).  So a cell or a metric is
added by adding files and entries, and no file here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """BENCHMARK.json (or another file of its layout, for tests), with
    its configuration, traffic and metric files under `base`."""

    def __init__(self, path=None, base=HERE):
        self.path = path or os.path.join(ROOT, "BENCHMARK.json")
        self.doc = load_json(self.path)
        self.base = base

    def cell(self, name):
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, cell):
        return load_json(os.path.join(self.base, "configs",
                                      cell["config"] + ".json"))

    def traffic(self, cell):
        return load_json(os.path.join(self.base, "traffic",
                                      cell["traffic"] + ".json"))

    @staticmethod
    def _applies(metric, cell):
        return cell["name"] in metric.get("workloads", [cell["name"]])

    def end_to_end(self, cell):
        return [m for m in self.doc["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell):
        return [m for m in self.doc["per_layer"] if self._applies(m, cell)]

    def reader(self, metric):
        """The metric's reader module, loaded from its file."""
        path = os.path.join(self.base, "metrics", metric["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "port_bench_metric_" + metric["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def driver(kind):
    return importlib.import_module(f"port_bench.drivers.{kind}")
