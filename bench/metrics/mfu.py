"""mfu: the window's model FLOPs (from the configuration's shapes, by
precision class, ``harness.work``) at each class's peak, over the
window's seconds, in %."""
from harness import work


def read(run, name):
    flops = work.window_model_flops(run.shape, run.window.work)
    return 100.0 * work.seconds_at_peak(flops) / run.window.window_s
