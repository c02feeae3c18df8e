"""plain_op_share: the share of the window's device time in ops that are
neither the port's CUDA kernels (``kernels/port.txt``) nor cuBLAS
(``kernels/cublas.txt``), in %."""


def read(run, name):
    total = run.device_seconds()
    if total <= 0:
        return None
    return 100.0 * (total - run.kernel_seconds("port", "cublas")) / total
