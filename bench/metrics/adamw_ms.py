"""adamw_ms: device ms of the training step's optimizer part
(``train_step.update``: AdamW over every leaf), from CUDA events around
each call of the traced window, summed over the steps and divided by
their number."""


def read(run, name):
    ms = run.window.spans.cuda_ms("update")
    return sum(ms) / len(ms) if ms else None
