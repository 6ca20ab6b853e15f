"""The numbers that decide `correct`, from the program's readings and
the reference's.  Each is a gap that a sound run keeps small; the
limits are the configuration file's `check` entries (PERF.md gives the
readings each was set from)."""

from __future__ import annotations

import statistics

# A leaf whose reference gradient is under this share of the median
# leaf's is moved by AdamW through round-off alone (a key bias under
# softmax): it is left out of the change comparison.
STILL_LEAF = 1e-3


def worst_leaf(got, want, leaves=None):
    """The largest |got - want| of a leaf, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = list(want) if leaves is None else list(leaves)
    med = statistics.median(want[k] for k in want)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in names)


def training_gaps(got, want):
    """{loss, grad, change} of the program's readings `got` against the
    reference's `want` (reference.gpt2.train_readings' layout)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                    want["loss"]))
    gmed = statistics.median(want["grad"].values())
    moving = [k for k, g in want["grad"].items() if g >= STILL_LEAF * gmed]
    return {
        "loss": loss,
        "grad": worst_leaf(got["grad"], want["grad"]),
        "change": worst_leaf(got["change"], want["change"], moving),
    }


def judged(values, limits):
    """[(name, value, limit)] in the limits' order, and whether every
    value is within its limit."""
    rows = [(k, float(values[k]), float(limits[k])) for k in limits]
    return rows, all(v <= lim for _, v, lim in rows)
