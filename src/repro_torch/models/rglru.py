"""RG-LRU recurrent block (RecurrentGemma / Griffin), the JAX package's
``models/rglru.py`` in PyTorch.

The linear recurrence ``h_t = a_t h_{t-1} + x_t`` (``a_t = exp(log_a_t)``,
``log_a_t <= 0``) runs in f32.  The JAX package evaluates it with a
log-space ``associative_scan``; PyTorch has none, so here it runs in
chunks of :data:`CHUNK` steps: within a chunk the decay from step ``s``
to step ``t >= s`` is the sum of ``log_a`` over ``s < u <= t``, summed
directly (a masked cumulative sum, never a difference of two long
prefix sums) and masked before ``exp``, so no positive exponent is
formed; across chunks the last ``h`` is carried.  The sums add in another
order than the reference's tree, so ``h`` agrees within f32 rounding.
Decode (one step on a carried state) is the single update.  A prefill of
S > 1 steps on a carried state convolves over the carried inputs too
(the JAX package's conv then yields only the last position, a fault of
the reference noted in ROADMAP C; nothing there calls it that way).

As in the JAX package, the recurrence and input gates use dense [w, w]
projections (the released model's are block-diagonal per head).

Tensor parallelism (``group``, the model axis; the reference's rules
split ``w_x`` / ``w_y`` by columns and ``w_out`` by rows, and its
``constrain(out, "batch", "seq", "mlp")`` keeps the LRU width split):
each rank holds its columns of the width (its channels) of ``w_x`` and
``w_y`` and those rows of ``w_out``, whose f32 partials the group sums.
The conv, ``lam`` and the recurrence are per channel, so each rank runs
its own; the leaves the rules keep whole (``conv``, ``lam``, ``w_a``,
``w_i``) are sliced to its channels at use, through ``copy_to`` so each
rank's gradient (its columns) is summed into the whole leaf's.  The
gates contract over the whole width: ``u`` is gathered over the group
(the gather's backward sums the ranks' parts).  The decode state ``h``
and ``conv`` keep this rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as dctx
from repro_torch.models.layers import ninit, row_parallel, tp_in

_C = 8.0      # Griffin's fixed gate temperature
#: time steps of one chunk of the recurrence
CHUNK = 64


def init_rglru(cfg, dtype, *, generator, device):
    d, w, cw = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width
    kw = dict(generator=generator, device=device)
    return {
        "w_x": ninit((d, w), d ** -0.5, dtype, **kw),       # value branch
        "w_y": ninit((d, w), d ** -0.5, dtype, **kw),       # gate branch
        "conv": ninit((cw, w), cw ** -0.5, dtype, **kw),
        "w_a": ninit((w, w), w ** -0.5, dtype, **kw),       # recurrence gate
        "w_i": ninit((w, w), w ** -0.5, dtype, **kw),       # input gate
        "lam": torch.linspace(0.9, 5.0, w, dtype=torch.float32,
                              device=device),               # a in (0, 1)
        "w_out": ninit((w, d), w ** -0.5, dtype, **kw),
    }


def _gates(p, u, group=None):
    """u: [B, S, w] post-conv activations (this rank's channels under
    ``group``) -> (log_a, gated input), f32."""
    uf = u.float()
    u_all = uf
    if dctx.group_size(group) > 1:
        u_all = dctx.gather_seq(u, group, dim=-1).float()
    r = torch.sigmoid(u_all @ _mine(p["w_a"], group).float())
    i = torch.sigmoid(u_all @ _mine(p["w_i"], group).float())
    log_a = r * (-_C * F.softplus(_mine(p["lam"], group).float()))
    a2 = torch.exp(2.0 * log_a)
    x_in = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * uf)
    return log_a, x_in


def _mine(w, group):
    """This rank's channels (the last dim's chunk) of a leaf every rank
    holds whole; its gradient is summed over ``group``."""
    if dctx.group_size(group) == 1:
        return w
    return dctx.own_chunk(dctx.copy_to(w, group), -1, group)


def _conv1d(p, x, conv_state=None, group=None):
    """Causal depthwise conv of width cw over x [B, S, w], after the
    previous inputs ``conv_state`` [B, cw-1, w] (zeros when None).
    Returns the output and the last cw-1 inputs, in x's dtype."""
    kern = _mine(p["conv"], group).float()               # [cw, w]
    cw, s = kern.shape[0], x.shape[1]
    xf = x.float()
    prev = (xf.new_zeros((x.shape[0], cw - 1, x.shape[2]))
            if conv_state is None else conv_state.float())
    buf = torch.cat([prev, xf], dim=1)
    out = sum(buf[:, i:i + s] * kern[i] for i in range(cw))
    return out.to(x.dtype), buf[:, -(cw - 1):].to(x.dtype)


def linear_scan(log_a, x_in, h0=None, chunk: int = CHUNK):
    """``h_t = exp(log_a_t) h_{t-1} + x_in_t`` over axis 1 from ``h0``
    [B, w] (zeros when None).  log_a, x_in: [B, S, w] f32, log_a <= 0.
    Returns every h [B, S, w]."""
    b, s, w = x_in.shape
    h = (torch.zeros((b, w), dtype=torch.float32, device=x_in.device)
         if h0 is None else h0.float())
    outs = []
    for c0 in range(0, s, chunk):
        la, xc = log_a[:, c0:c0 + chunk], x_in[:, c0:c0 + chunk]
        t = la.shape[1]
        live = torch.ones((t, t), dtype=torch.bool,
                          device=la.device).tril()       # [t, s]: s <= t
        after = live.logical_not().T                     # [u, s]: u > s
        # rel[t, s] = sum of la_u over s < u <= t (0 where s >= t)
        steps = torch.where(after[None, :, :, None], la[:, :, None, :], 0.0)
        rel = torch.cumsum(steps, dim=1)                 # [B, t, s, w] <= 0
        wts = torch.where(live[None, :, :, None], torch.exp(rel), 0.0)
        hc = (wts * xc[:, None]).sum(dim=2) \
            + torch.exp(torch.cumsum(la, dim=1)) * h[:, None]
        outs.append(hc)
        h = hc[:, -1]
    return torch.cat(outs, dim=1)


def rglru_apply(p, x, *, state=None, group=None, seq: bool = False):
    """x: [B, S, d].  ``state`` None (from scratch) or {h [B, w] f32, conv
    [B, cw-1, w]}: one decode step when S == 1, else a chunked prefill
    continuing from it.  Returns (y [B, S, d], new_state).  ``group``:
    the model axis, over which the width is split (module docstring);
    ``seq``: ``x`` is the sequence gathered over it."""
    tp = dctx.group_size(group) > 1
    if tp:
        x = tp_in(x, group, seq)
    xb = x.to(p["w_x"].dtype) @ p["w_x"]                 # [B, S, w]
    yb = x.to(p["w_y"].dtype) @ p["w_y"]
    u, new_conv = _conv1d(p, xb, state["conv"] if state is not None
                          else None, group)
    log_a, x_in = _gates(p, u, group)
    if state is not None and x.shape[1] == 1:
        h = torch.exp(log_a[:, 0]) * state["h"].float() + x_in[:, 0]
        hs = h[:, None]
    else:
        hs = linear_scan(log_a, x_in,
                         state["h"] if state is not None else None)
        h = hs[:, -1]
    gate = F.gelu(yb.float(), approximate="tanh")
    out = (gate * hs).to(x.dtype)
    y = row_parallel(out, p["w_out"], group, seq) if tp \
        else out @ p["w_out"].to(x.dtype)
    return y, {"h": h.float(), "conv": new_conv}


def init_rglru_state(cfg, batch, *, device, ways: int = 1):
    """The zero state; ``ways``: the model axis's ranks the width is
    split over (each keeps its channels)."""
    w, cw = (cfg.lru_width or cfg.d_model) // ways, cfg.conv_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, w), dtype=torch.bfloat16,
                                device=device)}
