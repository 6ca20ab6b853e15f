"""The repo's static analyzer (tools/analysis) as a gate on the port:
every rule runs over every .py of container_engine_accelerators_tpu_torch/
and reports nothing.  A site the analyzer flags by design carries a
justified `# analysis: disable=<rule> -- <reason>` comment, as the
reference's counterpart does; a flagged ref-leak is fixed, not
suppressed."""

import os

from tools.analysis import main as analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "container_engine_accelerators_tpu_torch")


def _port_files():
    return sorted(
        os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
        if f.endswith(".py"))


def test_the_analyzer_finds_nothing_in_the_port(capsys):
    files = _port_files()
    assert len(files) > 50
    rc = analysis.main(files)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "analysis passed" in out
