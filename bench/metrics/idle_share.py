"""idle_share: the share of the traced window in which no device op ran
(1 - the union of the ops' intervals over the window), in %."""


def read(run, name):
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window.window_s)
