"""pytest settings of the benchmark's own tests (port_bench/tests/):
`python -m pytest port_bench/tests`.  The `card` marker names the tests
that need an NVIDIA card; each decides inside itself whether one is
there and skips without it."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs a cell on an NVIDIA card; skips without one")
