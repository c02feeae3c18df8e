"""Attention: GQA with RoPE, optional qk-norm and QKV bias; chunked
online-softmax attention or the flash-attention kernel for prefill and
training, and a single-step decode path against a KV cache.

``chunked_attention`` repeats the JAX package's online-softmax math in
plain tensor ops (not ``scaled_dot_product_attention``), so the two
agree.  With ``cfg.attn_backend == "flash"``, a layer without a window
and S % 128 == 0 runs :func:`~repro_torch.kernels.flash_attention_kernel.
flash_attention_trainable` instead, under the JAX package's condition;
any other prefill, and every decode step, keeps the plain paths.

Sliding windows (``layer_window``) follow the JAX package: a key at most
``window - 1`` positions behind the query is seen.  A prefill longer
than the window leaves a ring-buffer cache of exactly ``window`` slots,
position ``p`` at slot ``p % window``; a decode step on it writes its
K/V at ``len % window``, in place.  A windowed cache with more slots
than the window keeps position ``p`` at slot ``p`` and masks by window.

Tensor parallelism (``group``, the model axis's process group; the
reference's ``"heads": "model"`` and ``"kv_seq": "model"`` rules): each
rank holds the columns of ``wq`` (and of ``wk``/``wv`` where the kv heads
divide the axis; otherwise they stay whole and each rank uses the kv
heads its q heads read) and the rows of ``wo``; it attends over its own
heads and ``wo``'s f32 partials are summed over the group.  The decode
cache is split over its slots: each rank holds a contiguous slice
(``"slot0"`` is its first slot) of every kv head.  A prefill gathers k/v
over the heads and keeps its slice; a decode step gathers the new
token's q/k/v over the heads, the rank owning slot ``pos`` writes it,
every rank attends all heads over its slots, and the partial softmax
statistics are combined over the group (flash-decode).  A cache whose
slots (capacity, or ring window) the axis does not divide stays whole on
every rank, as the reference's ``spec_for`` leaves it.  Under sequence
parallelism (``seq``) the block takes the gathered sequence and
reduce-scatters ``wo``'s partials (``layers.sublayer``); the caches
stay on their slots (``kv_seq``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import context as dctx
from repro_torch.kernels.flash_attention_kernel import \
    flash_attention_trainable
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (init_rms_norm, ninit, rms_norm,
                                       row_parallel, rope, tp_in)


def init_attention(cfg, dtype, *, generator, device):
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    kw = dict(generator=generator, device=device)
    p = {
        "wq": ninit((d, hq * hd), d ** -0.5, dtype, **kw),
        "wk": ninit((d, hkv * hd), d ** -0.5, dtype, **kw),
        "wv": ninit((d, hkv * hd), d ** -0.5, dtype, **kw),
        "wo": ninit((hq * hd, d), (hq * hd) ** -0.5, dtype, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, device=device)
        p["k_norm"] = init_rms_norm(hd, device=device)
    return p


def _project_qkv(p, x, cfg, positions, *, use_rope=True, group=None,
                 kv_whole=False):
    """q, k, v [B, S, heads, hd] of this rank's heads (every head without
    ``group``; with it, the kv heads are this rank's slice, or all of them
    where ``kv_whole``: ``wk``/``wv`` are whole on every rank).  A param
    every rank holds whole takes ``copy_to``: each rank's gradient is the
    part its heads give."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim

    def whole(t):
        return dctx.copy_to(t, group) if group is not None else t
    kvp = whole if kv_whole else (lambda t: t)
    q = x @ p["wq"].to(x.dtype)
    k = x @ kvp(p["wk"]).to(x.dtype)
    v = x @ kvp(p["wv"]).to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + kvp(p["bk"]).to(x.dtype)
        v = v + kvp(p["bv"]).to(x.dtype)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm({"scale": whole(p["q_norm"]["scale"])}, q, cfg.norm_eps)
        k = rms_norm({"scale": whole(p["k_norm"]["scale"])}, k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _local_kv(k, v, cfg, group):
    """The kv heads this rank's q heads read, one for each q head, from
    k/v of every kv head (the whole ``wk``/``wv`` case, where the kv heads
    do not divide the axis and the local q heads may straddle them)."""
    g = cfg.num_heads // cfg.num_kv_heads
    hq_loc = cfg.num_heads // dctx.group_size(group)
    q0 = dist.get_rank(group) * hq_loc
    idx = torch.arange(q0, q0 + hq_loc, device=k.device) // g
    return k[:, :, idx], v[:, :, idx]


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      chunk: int, q_offset: int = 0, k_offset: int = 0,
                      k_valid: Optional[int] = None):
    """Online-softmax attention over q and k chunks.

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D].  q rows sit at positions
    ``q_offset + i``, k rows at ``k_offset + j``.  Chunk pairs with no
    live (q, k) pair under the causal and window masks are skipped.
    """
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    scale = hd ** -0.5
    cq, ck = min(chunk, sq), min(chunk, sk)
    if k_valid is None:
        k_valid = sk
    nq, nk = -(-sq // cq), -(-sk // ck)
    dev = q.device
    outs = []
    for i in range(nq):
        qi = q[:, i * cq:(i + 1) * cq]
        rows = qi.shape[1]
        if rows < cq:       # pad the last chunk like the reference
            qi = torch.cat([qi, qi.new_zeros((b, cq - rows, hq, hd))], dim=1)
        qg = qi.reshape(b, cq, hkv, g, hd).permute(0, 2, 3, 1, 4).float()
        qpi = q_offset + i * cq + torch.arange(cq, device=dev)
        m = torch.full((b, hkv, g, cq), NEG_INF, dtype=torch.float32, device=dev)
        l_ = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, hd), dtype=torch.float32, device=dev)
        for j in range(nk):
            if causal and (q_offset + i * cq + cq - 1) < (k_offset + j * ck):
                continue
            if window is not None and (q_offset + i * cq) - (
                    k_offset + j * ck + ck - 1) >= window:
                continue
            kj, vj = k[:, j * ck:(j + 1) * ck], v[:, j * ck:(j + 1) * ck]
            if kj.shape[1] < ck:
                pad = kj.new_zeros((b, ck - kj.shape[1], hkv, hd))
                kj, vj = torch.cat([kj, pad], 1), torch.cat([vj, pad], 1)
            kpi = k_offset + j * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qg,
                             kj.permute(0, 2, 1, 3).float()) * scale
            mask = (kpi[None, :] < k_valid).expand(cq, ck)
            if causal:
                mask = mask & (qpi[:, None] >= kpi[None, :])
            if window is not None:
                mask = mask & ((qpi[:, None] - kpi[None, :]) < window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_ = l_ * alpha + pr.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", pr, vj.permute(0, 2, 1, 3).float())
            m = m_new
        out = acc / torch.clamp(l_, min=1e-20)[..., None]    # [B,Hkv,G,cq,D]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, cq, hq, hd)[:, :rows])
    return torch.cat(outs, dim=1).to(q.dtype)


def _attend_cache(q, k_cache, v_cache, mask):
    """Softmax attention of one query row per sequence over the cache
    slots where ``mask`` [S] holds."""
    b, _, hq, hd = q.shape
    _, s, hkv, _ = k_cache.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * hd ** -0.5
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    pr = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", pr, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def _attend_cache_split(q, k_cache, v_cache, mask, group):
    """:func:`_attend_cache` over the slots split across ``group``: each
    rank's (max, sum, output) over its slots where ``mask`` (its slots')
    holds, gathered in one collective, rescaled to the group's max and
    summed in rank order (flash-decode)."""
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * hd ** -0.5
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    pr = torch.where(mask, torch.exp(scores - m), 0.0)
    out = torch.einsum("bhgs,bshd->bhgd", pr, v_cache.float())
    parts = dctx.all_gather(torch.cat([m, pr.sum(-1, keepdim=True), out],
                                      -1)[None], 0, group)
    alpha = torch.exp(parts[..., :1] - parts[..., :1].amax(dim=0))
    both = (parts[..., 1:] * alpha).sum(dim=0)
    out = both[..., 1:] / both[..., :1]
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def _cache_from_prefill(k, v, window, capacity=None, dtype=torch.bfloat16):
    """Decode cache from prefill K/V, padded to ``capacity`` slots so the
    decode steps can append in place.  A window layer whose prompt is
    longer than the window keeps the last ``window`` positions in a ring
    buffer, position ``p`` at slot ``p % window``."""
    b, s, hkv, hd = k.shape
    if window is not None and s > window:
        slots = torch.arange(s - window, s, device=k.device) % window
        kc = torch.zeros((b, window, hkv, hd), dtype=dtype, device=k.device)
        vc = torch.zeros_like(kc)
        kc[:, slots] = k[:, -window:].to(dtype)
        vc[:, slots] = v[:, -window:].to(dtype)
        return {"k": kc, "v": vc, "len": s}
    cap = max(capacity or s, s)
    kc = torch.zeros((b, cap, hkv, hd), dtype=dtype, device=k.device)
    vc = torch.zeros_like(kc)
    kc[:, :s] = k
    vc[:, :s] = v
    return {"k": kc, "v": vc, "len": s}


def _split_slots(cache, group):
    """This rank's contiguous slice of ``cache``'s slots, where the group
    divides them (``"slot0"``: its first); else the cache, whole."""
    n, slots = dctx.group_size(group), cache["k"].shape[1]
    if n == 1 or slots % n:
        return cache
    per = slots // n
    lo = dist.get_rank(group) * per
    return {"k": cache["k"][:, lo:lo + per].clone(),
            "v": cache["v"][:, lo:lo + per].clone(), "len": cache["len"],
            "slot0": lo}


def _gather_heads(group, *ts):
    """Each of ``ts`` [B, S, local heads, hd] gathered over the heads of
    ``group`` in rank order, in one collective."""
    b, s, _, hd = ts[0].shape
    widths = [t.shape[2] for t in ts]
    n = dctx.group_size(group)
    both = dctx.all_gather(torch.cat(ts, dim=2), 2, group)
    parts = both.reshape(b, s, n, sum(widths), hd).split(widths, dim=3)
    return [p.reshape(b, s, n * w, hd) for p, w in zip(parts, widths)]


def attention_block(p, x, cfg, positions, *, cache=None, layer_window=None,
                    causal=True, mode="train", cache_capacity=None,
                    pos_offset: int = 0, group=None, kv_split=True,
                    seq: bool = False):
    """Full attention sub-block.  With ``cache`` (dict k, v, len) performs
    one decode step, writing the new K/V into the cache IN PLACE, and
    returns (out, cache); in prefill mode builds the cache from the
    full-sequence K/V.  ``pos_offset`` is ``positions[0]`` as a host
    integer, so no step reads the device back.  ``group``: the model
    axis, whose ranks hold slices of the q heads, and of the kv heads
    where ``kv_split`` (else ``wk``/``wv`` are whole; module docstring);
    ``seq``: ``x`` is the sequence gathered over it."""
    b, s, d = x.shape
    tp = dctx.group_size(group) > 1
    if not tp:
        group = None
    else:
        x = tp_in(x, group, seq)
    kv_whole = tp and not kv_split
    if cache is None:
        q, k, v = _project_qkv(p, x, cfg, positions, group=group,
                               kv_whole=kv_whole)
        ka, va = _local_kv(k, v, cfg, group) if kv_whole else (k, v)
        if (cfg.attn_backend == "flash" and layer_window is None
                and s % 128 == 0):
            # the kernel takes [B, H, S, D], contiguous
            out = flash_attention_trainable(
                *(t.transpose(1, 2).contiguous() for t in (q, ka, va)),
                causal).transpose(1, 2)
        else:
            out = chunked_attention(q, ka, va, causal=causal,
                                    window=layer_window,
                                    chunk=cfg.attn_chunk,
                                    q_offset=pos_offset, k_offset=pos_offset)
        new_cache = None
        if mode == "prefill":
            if tp and not kv_whole:
                k, v = _gather_heads(group, k, v)
            new_cache = _split_slots(
                _cache_from_prefill(k, v, layer_window, cache_capacity),
                group)
    else:
        pos = cache["len"]
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v = _project_qkv(p, x, cfg, positions, group=group,
                               kv_whole=kv_whole)
        hq_loc = q.shape[2]
        if tp:
            q, k, v = ((*_gather_heads(group, q), k, v) if kv_whole
                       else _gather_heads(group, q, k, v))
        lo = cache.get("slot0", 0)
        per = cache["k"].shape[1]
        slots = per if "slot0" not in cache else per * dctx.group_size(group)
        ring = layer_window is not None and slots == layer_window
        slot = pos % layer_window if ring else pos
        if lo <= slot < lo + per:
            cache["k"][:, slot - lo:slot - lo + 1] = k.to(cache["k"].dtype)
            cache["v"][:, slot - lo:slot - lo + 1] = v.to(cache["v"].dtype)
        j = torch.arange(slots, device=x.device)
        if ring:
            # the position each slot holds: the slots up to ``slot`` were
            # written in this lap of the ring, the later ones in the last
            slot_pos = torch.where(j <= slot, pos - slot + j,
                                   pos - slot - layer_window + j)
            mask = (slot_pos >= 0) & (slot_pos <= pos)
        else:
            mask = j <= pos
            if layer_window is not None:
                mask = mask & (pos - j < layer_window)
        if "slot0" in cache:
            out = _attend_cache_split(q, cache["k"], cache["v"],
                                      mask[lo:lo + per], group)
        else:
            out = _attend_cache(q, cache["k"], cache["v"], mask)
        if tp:      # this rank's heads, for its rows of wo
            r = dist.get_rank(group)
            out = out[:, :, r * hq_loc:(r + 1) * hq_loc]
        new_cache = {**cache, "len": pos + 1}
    out = out.reshape(b, s, -1)
    if tp:
        return row_parallel(out, p["wo"], group, seq), new_cache
    return out @ p["wo"].to(x.dtype), new_cache


def init_kv_cache(cfg, batch, seq_len, layer_window=None, *, device,
                  dtype=torch.bfloat16, group=None):
    """An empty decode cache of ``seq_len`` slots (``layer_window`` where
    that is fewer).  With ``group``, this rank's slice of the slots where
    the group divides them; otherwise every slot (e.g. a 130-slot cache,
    or a ring of 2048 slots, on a 3-way axis)."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    s = min(seq_len, layer_window) if layer_window else seq_len
    cache = {"k": torch.zeros((batch, s, hkv, hd), dtype=dtype, device=device),
             "v": torch.zeros((batch, s, hkv, hd), dtype=dtype, device=device),
             "len": 0}
    return _split_slots(cache, group)
