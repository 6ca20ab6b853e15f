"""Share of the traced stretch in which no operation ran on the device
(1 - the union of the device spans over the stretch's length on the
host's clock), in percent.  The device layer; moves train_step_ms."""


def read(obs):
    tr = obs["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
