"""The end-to-end numbers are taken over every sample of the whole
window: a percentile over all gaps or requests, a rate over all tokens
and all the time, never a median of pieces."""

import math
import types

from port_bench import stats
from port_bench.drivers import serve, train


def _req(times, due=0.0, error=None, max_new=None):
    r = serve.Req(types.SimpleNamespace(prompt=[1, 2], max_new=max_new or
                                        len(times), shared=0), due)
    r.times, r.toks = list(times), [0] * len(times)
    r.t_done, r.error = (times[-1] if times else due), error
    return r


def _cell(loop, reqs, t0, t1):
    c = serve.Serve.__new__(serve.Serve)
    c.mix, c.reqs, c.t0, c.t1, c.setup_s = {"loop": loop}, reqs, t0, t1, 5.0
    c.due = [r for r in reqs if t0 <= r.due < t1]
    return c


def test_itl_and_rate_over_the_whole_window():
    # 90 gaps of 1 ms early, 10 of 10 ms late: the p95 of all is 10 ms;
    # the median of the two halves' p95s would be 5.5 ms.
    early = [10.0 + 0.001 * k for k in range(91)]
    late = [early[-1] + 0.010 * k for k in range(1, 11)]
    c = _cell("closed", [_req(early + late)], 10.0, 11.0)
    e2e, attempted, failed = c.metrics()
    assert math.isclose(e2e["itl_p95_ms"], 10.0, rel_tol=1e-6)
    assert math.isclose(e2e["out_tok_s"], 101 / 1.0)
    assert (attempted, failed) == (1, 0)


def test_tokens_outside_the_window_do_not_count():
    c = _cell("closed", [_req([9.5, 9.9, 10.2, 10.4, 11.5])], 10.0, 11.0)
    e2e, _, _ = c.metrics()
    assert e2e["out_tok_s"] == 2.0
    assert math.isclose(e2e["itl_p95_ms"], 300.0, rel_tol=1e-6)


def test_ttft_counts_every_due_request_and_failures_as_missing():
    reqs = [_req([10.0 + k * 0.05 + 0.01, 10.99], due=10.0 + k * 0.05)
            for k in range(19)]
    c = _cell("open", reqs, 10.0, 11.0)
    assert math.isclose(c.metrics()[0]["ttft_p95_ms"], 10.0, rel_tol=1e-6)
    for due in (10.95, 10.97):  # 2 of 21 missing reach the 95th
        reqs.append(_req([], due=due, error=RuntimeError("refused"),
                         max_new=4))
    c = _cell("open", reqs, 10.0, 11.0)
    e2e, attempted, failed = c.metrics()
    assert (attempted, failed) == (21, 2)
    assert e2e["ttft_p95_ms"] == math.inf


def test_train_step_is_window_over_steps():
    c = train.Train.__new__(train.Train)
    c.t0, c.t1, c.steps, c.setup_s = 0.0, 10.5, 42, 3.0
    assert math.isclose(c.metrics()["train_step_ms"], 250.0)


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile([], 95) is None
    assert stats.percentile([1.0, math.inf], 95) == math.inf
