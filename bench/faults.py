"""Faults planted in the port underneath a run, for the check of outputs
to catch: a training step that returns its state unchanged, half of the
batch left out (the mean taken over the rest), a served token altered
where it is produced.  Each is a context manager that patches the port
and restores it.  Used by ``calibrate.py --fault`` on the chip and by
the CPU tests; never by a run of the benchmark."""
import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def state_unchanged():
    import torch
    from repro_torch.optim import adamw

    def unchanged(params, grads, state, cfg, **kw):
        return params, state, {"lr": torch.zeros(()),
                               "grad_norm": torch.zeros(())}
    return _patched(adamw, "apply_updates", unchanged)


def half_batch():
    from repro_torch.models import transformer as tfm
    full = tfm.lm_loss

    def half(params, batch, cfg, **kw):
        n = batch["tokens"].shape[0] // 2
        return full(params, {k: v[:n] for k, v in batch.items()}, cfg, **kw)
    return _patched(tfm, "lm_loss", half)


def token_altered():
    from repro_torch.serve.engine import Engine
    sample = Engine._sample

    def altered(self, logits, generator):
        tok = sample(self, logits, generator).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    return _patched(Engine, "_sample", altered)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}
