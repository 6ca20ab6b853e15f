"""The traffic generator: the same seed gives the same requests, and
every seed the same sizes in another order."""

import numpy as np

from port_bench import traffic

CLOSED = {"loop": "closed", "clients": 8,
          "prompt_len": {"dist": "uniform", "lo": 64, "hi": 256},
          "output_len": {"dist": "uniform", "lo": 512, "hi": 768},
          "first_output_len": {"dist": "uniform", "lo": 16, "hi": 768}}
OPEN = {"loop": "open", "rate_per_s": 8.0,
        "system_prompts": {"count": 16, "len": 512, "zipf": 1.0},
        "prompt_len": {"dist": "lognormal", "median": 96, "sigma": 0.6,
                       "lo": 32, "hi": 256},
        "output_len": {"dist": "lognormal", "median": 96, "sigma": 0.6,
                       "lo": 32, "hi": 256}}
BIG = 2 ** 31 + 12345


def _take(gen, n):
    return [next(gen) for _ in range(n)]


def test_same_seed_same_requests():
    a = _take(traffic.Mix(CLOSED, 50257, BIG).closed(), 24)
    b = _take(traffic.Mix(CLOSED, 50257, BIG).closed(), 24)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
    s1 = traffic.Mix(OPEN, 50257, BIG).open(3, 30)
    s2 = traffic.Mix(OPEN, 50257, BIG).open(3, 30)
    assert [(d, r.max_new) for d, r in s1] == [(d, r.max_new) for d, r in s2]


def test_seeds_share_sizes_not_order():
    a = _take(traffic.Mix(CLOSED, 50257, 1).closed(), 16)
    b = _take(traffic.Mix(CLOSED, 50257, 2).closed(), 16)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt)
                                                      for r in b)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    assert [r.max_new for r in a] != [r.max_new for r in b]


def test_open_loop_counts_and_prefixes():
    mix = traffic.Mix(OPEN, 50257, 7)
    sched = mix.open(3, 30)
    window = [(d, r) for d, r in sched if d >= 3]
    assert len(window) == 240 and len(sched) == 264
    assert max(d for d, _ in sched) < 33
    for _, r in sched:
        assert r.shared == 512 and 32 <= len(r.prompt) - 512 <= 256
        assert any(np.array_equal(r.prompt[:512], h) for h in mix.system)
        assert len(r.prompt) + r.max_new <= 1024


def test_zipf_counts_sum_and_order():
    c = traffic.zipf_counts(16, 1.0, 240)
    assert c.sum() == 240 and all(np.diff(c) <= 0) and c[0] > 4 * c[-1]


def test_quantiles_cover_range():
    q = traffic.quantiles({"dist": "uniform", "lo": 512, "hi": 768}, 257)
    assert q.min() == 512 and q.max() == 768
