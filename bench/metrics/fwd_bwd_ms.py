"""fwd_bwd_ms: device ms of the training step's gradient part
(``train_step.grad_fn``: forward, loss and backward), from CUDA events
around each call of the traced window, summed over the steps and
divided by their number."""


def read(run, name):
    ms = run.window.spans.cuda_ms("grad_fn")
    return sum(ms) / len(ms) if ms else None
