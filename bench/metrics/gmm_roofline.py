"""gmm_roofline: the least time of the window's grouped-GEMM work
(``harness.work.window_gmm``: each GEMM's max of FLOPs over peak and
bytes over HBM bandwidth) over the device time of the grouped-GEMM
kernels (``kernels/gmm.txt``), in %."""
from harness import work


def read(run, name):
    t = run.kernel_seconds("gmm")
    if t <= 0:
        return None
    return 100.0 * work.least_seconds(
        work.window_gmm(run.shape, run.window.work, run.active)) / t
