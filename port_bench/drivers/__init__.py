"""One driver a configuration `kind`: serve.py (the continuous engine)
and train.py (the LM trainer).  Each has `run(cfg, mix, seed, seconds,
trace, device, t_start, control)` -> common.Outcome."""
