"""Rows a decode commit carries on average over the traced stretch: the
engine's `step_rows` over its `steps` (both count commits of one-token
steps and fused blocks alike).  The engine layer; moves out_tok_s."""


def read(obs):
    c = obs["counters"]
    return c["step_rows"] / c["steps"] if c.get("steps") else None
