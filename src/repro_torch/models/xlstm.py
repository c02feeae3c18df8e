"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory): the JAX
package's ``models/xlstm.py`` in PyTorch.

The mLSTM runs in the chunkwise-parallel form: within a chunk a masked,
decay-weighted attention-like product, across chunks a loop carrying the
(C, n) state.  A sequence of S > 1 steps runs in chunks of
``min(chunk, S)`` and must satisfy ``S % min(chunk, S) == 0``, as in the
JAX package, which asserts it; nothing is padded.  Decode (S == 1) is the
O(1) state update.  The sLSTM is the sequential scan.

As in the JAX package: sigmoid input and forget gates (GLA-style) in
place of the paper's exponential gating and stabilizer; decays stay in
log space and <= 0, and every exponent is masked to <= 0 before ``exp``.
The gate projections ``w_if`` are f32.

Tensor parallelism (``group``, the model axis; the reference's rules
split ``wq`` / ``wk`` / ``wv`` by columns and ``wo`` by rows, and keep
``w_if``, ``w_og`` and ``w_z`` whole).  mLSTM: each rank runs its heads
(its columns of ``wq`` / ``wk`` / ``wv``, the same heads' columns of each
half of ``w_if`` and of ``w_og``, and those rows of ``wo``); sLSTM: the
recurrence is elementwise over ``d``, so each rank runs its channels
(``wo``'s rows, the same columns of ``w_z``, of each half of ``w_if``
and of ``w_og``).  The whole leaves are sliced at use through
``copy_to``, so their gradients are summed over the group; ``wo``'s f32
partials are summed over it.  The states (``C`` and ``n`` of the mLSTM,
``c`` and ``n`` of the sLSTM) keep this rank's heads or channels; the
reference's dry run keeps them whole on every rank (ROADMAP C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as dctx
from repro_torch.models.layers import ninit, row_parallel, tp_in

#: the mLSTM's chunk (RUN_HINTS["mlstm_chunk"] of xlstm-350m)
MLSTM_CHUNK = 256


def init_mlstm(cfg, dtype, *, generator, device):
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    kw = dict(generator=generator, device=device)
    return {
        "wq": ninit((d, h * hd), d ** -0.5, dtype, **kw),
        "wk": ninit((d, h * hd), d ** -0.5, dtype, **kw),
        "wv": ninit((d, h * hd), d ** -0.5, dtype, **kw),
        "w_if": ninit((d, 2 * h), d ** -0.5, torch.float32, **kw),
        "w_og": ninit((d, h * hd), d ** -0.5, dtype, **kw),
        "wo": ninit((h * hd, d), (h * hd) ** -0.5, dtype, **kw),
    }


def _mlstm_chunk(c_prev, n_prev, qf, kf, vf, lf, ig):
    """One chunk: q, k, v [B, H, T, D] f32 (q scaled), log-forget and
    input gates [B, H, T].  Returns (C, n) at the chunk's end and its
    outputs [B, H, T, D]."""
    t = qf.shape[2]
    bcum = torch.cumsum(lf, dim=-1)                      # [B, H, T], <= 0
    btot = bcum[..., -1:]
    # intra-chunk: decay-weighted causal linear attention; mask BEFORE exp
    # (an acausal difference is positive)
    causal = torch.ones((t, t), dtype=torch.bool, device=qf.device).tril()
    rel = torch.where(causal, bcum[..., :, None] - bcum[..., None, :], 0.0)
    w_jk = torch.where(causal, torch.exp(rel) * ig[..., None, :], 0.0)
    sjk = torch.einsum("bhjd,bhkd->bhjk", qf, kf)
    intra = torch.einsum("bhjk,bhkd->bhjd", sjk * w_jk, vf)
    # inter-chunk: read the carried state with the per-position decay
    dec = torch.exp(bcum)                                # <= 1
    inter = torch.einsum("bhjk,bhkv->bhjv", qf * dec[..., None], c_prev)
    n_intra = torch.einsum("bhjk,bhkd->bhjd", w_jk, kf)
    n_j = dec[..., None] * n_prev[:, :, None, :] + n_intra
    den = torch.abs(torch.einsum("bhjd,bhjd->bhj", qf, n_j))
    yc = (intra + inter) / torch.clamp(den, min=1.0)[..., None]
    # carry the state to the chunk's end
    wk_end = torch.exp(btot - bcum) * ig                 # [B, H, T], <= 1
    kv = torch.einsum("bhtk,bhtv->bhkv", kf * wk_end[..., None], vf)
    c_new = torch.exp(btot)[..., None] * c_prev + kv
    n_new = torch.exp(btot) * n_prev + torch.sum(kf * wk_end[..., None],
                                                 dim=2)
    return c_new, n_new, yc


def _halves(w, lo: int, n: int, group):
    """Columns ``[lo, lo + n)`` of each half of the whole leaf ``w``
    (``w_if``: forget, then input), its gradient summed over
    ``group``."""
    w = dctx.copy_to(w, group)
    half = w.shape[1] // 2
    return torch.cat([w[:, lo:lo + n], w[:, half + lo:half + lo + n]], 1)


def _cols(w, lo: int, n: int, group):
    """Columns ``[lo, lo + n)`` of the whole leaf ``w``, its gradient
    summed over ``group``."""
    return dctx.copy_to(w, group)[:, lo:lo + n]


def mlstm_apply(p, x, *, state=None, chunk: int = MLSTM_CHUNK, group=None,
                seq: bool = False):
    """x: [B, S, d] -> (y, state={C: [B, H, dk, dv], n: [B, H, dk]}).
    ``group``: the model axis, whose ranks run their heads (module
    docstring); ``seq``: ``x`` is the sequence gathered over it."""
    b, s, d = x.shape
    ways = dctx.group_size(group)
    hhd = p["wq"].shape[1]
    h = p["w_if"].shape[1] // 2 // ways
    hd = hhd // h
    scale = hd ** -0.5
    w_if, w_og = p["w_if"], p["w_og"]
    if ways > 1:
        x = tp_in(x, group, seq)
        h0 = dctx.group_rank(group) * h
        w_if = _halves(w_if, h0, h, group)
        w_og = _cols(w_og, h0 * hd, h * hd, group)

    def heads(w):                                        # [B, H, S, D]
        return (x @ w.to(x.dtype)).reshape(b, s, h, hd).transpose(1, 2)
    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    gates = x.float() @ w_if                             # [B, S, 2H]
    log_f = (-F.softplus(-gates[..., :h])).transpose(1, 2)   # log sigmoid
    i_g = torch.sigmoid(gates[..., h:]).transpose(1, 2)      # [B, H, S]
    if state is None:
        state = init_mlstm_state_like(b, h, hd, device=x.device)

    if s == 1:                                           # decode
        c_prev, n_prev = state["C"], state["n"]
        f = torch.exp(log_f[..., 0])[..., None]          # [B, H, 1]
        i0 = i_g[..., 0][..., None]
        k0, v0 = k[:, :, 0].float(), v[:, :, 0].float()
        kv = torch.einsum("bhk,bhv->bhkv", k0, v0)
        c_new = f[..., None] * c_prev + i0[..., None] * kv
        n_new = f * n_prev + i0 * k0
        qf = q[:, :, 0].float() * scale
        num = torch.einsum("bhk,bhkv->bhv", qf, c_new)
        den = torch.abs(torch.einsum("bhk,bhk->bh", qf, n_new))
        ys = (num / torch.clamp(den, min=1.0)[..., None])[:, :, None]
    else:
        t = min(chunk, s)
        if s % t:
            raise ValueError(
                f"mLSTM: a sequence of {s} steps does not divide into "
                f"chunks of {t}; S must satisfy S % min({chunk}, S) == 0")
        c_new, n_new = state["C"], state["n"]
        outs = []
        for c0 in range(0, s, t):
            sl = slice(c0, c0 + t)
            c_new, n_new, yc = _mlstm_chunk(
                c_new, n_new, q[:, :, sl].float() * scale,
                k[:, :, sl].float(), v[:, :, sl].float(), log_f[..., sl],
                i_g[..., sl])
            outs.append(yc)
        ys = torch.cat(outs, dim=2)
    merged = ys.transpose(1, 2).reshape(b, s, h * hd)
    og = torch.sigmoid(x.float() @ w_og.float())
    out = (og * merged.float()).to(x.dtype)
    y = row_parallel(out, p["wo"], group, seq) if ways > 1 \
        else out @ p["wo"].to(x.dtype)
    return y, {"C": c_new, "n": n_new}


def init_mlstm_state_like(b, h, hd, *, device):
    return {"C": torch.zeros((b, h, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((b, h, hd), dtype=torch.float32, device=device)}


def init_mlstm_state(cfg, batch, *, device, ways: int = 1):
    """The zero state of this rank's heads (``ways``: the model axis's
    ranks the heads are split over)."""
    return init_mlstm_state_like(batch, cfg.num_heads // ways,
                                 cfg.resolved_head_dim, device=device)


# ---------------------------------------------------------------------------
# sLSTM: scalar memory, a sequential scan (elementwise)
# ---------------------------------------------------------------------------

def init_slstm(cfg, dtype, *, generator, device):
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    return {
        "w_z": ninit((d, d), d ** -0.5, dtype, **kw),
        "w_if": ninit((d, 2 * d), d ** -0.5, torch.float32, **kw),
        "w_og": ninit((d, d), d ** -0.5, dtype, **kw),
        "wo": ninit((d, d), d ** -0.5, dtype, **kw),
    }


def slstm_apply(p, x, *, state=None, group=None, seq: bool = False):
    """x: [B, S, d] -> (y, state={c: [B, d], n: [B, d]}).  ``group``: the
    model axis, whose ranks run their channels (module docstring);
    ``seq``: ``x`` is the sequence gathered over it."""
    b, s, _ = x.shape
    d = p["wo"].shape[0]                   # this rank's channels
    w_z, w_if, w_og = p["w_z"], p["w_if"], p["w_og"]
    tp = dctx.group_size(group) > 1
    if tp:
        x = tp_in(x, group, seq)
        c0 = dctx.group_rank(group) * d
        w_z, w_og = _cols(w_z, c0, d, group), _cols(w_og, c0, d, group)
        w_if = _halves(w_if, c0, d, group)
    z = torch.tanh((x @ w_z.to(x.dtype)).float())
    gates = x.float() @ w_if
    f = torch.sigmoid(gates[..., :d])
    i = torch.sigmoid(gates[..., d:])
    if state is None:
        state = init_slstm_state_like(b, d, device=x.device)
    c, n = state["c"], state["n"]
    hs = []
    for t in range(s):
        c = f[:, t] * c + i[:, t] * z[:, t]
        n = f[:, t] * n + i[:, t]
        hs.append(c / torch.clamp(n, min=1.0))
    og = torch.sigmoid(x.float() @ w_og.float())
    out = (og * torch.stack(hs, dim=1)).to(x.dtype)
    y = row_parallel(out, p["wo"], group, seq) if tp \
        else out @ p["wo"].to(x.dtype)
    return y, {"c": c, "n": n}


def init_slstm_state_like(b, d, *, device):
    return {"c": torch.zeros((b, d), dtype=torch.float32, device=device),
            "n": torch.zeros((b, d), dtype=torch.float32, device=device)}


def init_slstm_state(cfg, batch, *, device, ways: int = 1):
    """The zero state of this rank's channels (``ways``: the model axis's
    ranks ``d`` is split over)."""
    return init_slstm_state_like(batch, cfg.d_model // ways, device=device)
