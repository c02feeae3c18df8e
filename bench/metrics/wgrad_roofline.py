"""wgrad_roofline: the least time of the window's wgrad work
(``harness.work.window_wgrad``) over the device time of the wgrad
kernels (``kernels/wgrad.txt``), in %."""
from harness import work


def read(run, name):
    t = run.kernel_seconds("wgrad")
    gemms = work.window_wgrad(run.shape, run.window.work,
                             run.active)
    if t <= 0 or not gemms:
        return None
    return 100.0 * work.least_seconds(gemms) / t
