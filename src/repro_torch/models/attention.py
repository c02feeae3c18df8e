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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention_kernel import \
    flash_attention_trainable
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import init_rms_norm, ninit, rms_norm, rope


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


def _project_qkv(p, x, cfg, positions, *, use_rope=True):
    b, s, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def decode_attention(q, k_cache, v_cache, q_pos: int, *,
                     window: Optional[int]):
    """q: [B, 1, Hq, D] vs cache [B, S, Hkv, D], slot ``j`` holding
    position ``j``; positions <= q_pos (and, with a window, > q_pos -
    window) valid."""
    _, s, _, _ = k_cache.shape
    k_pos = torch.arange(s, device=q.device)
    mask = k_pos <= q_pos
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    return _attend_cache(q, k_cache, v_cache, mask)


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


def attention_block(p, x, cfg, positions, *, cache=None, layer_window=None,
                    causal=True, mode="train", cache_capacity=None,
                    pos_offset: int = 0):
    """Full attention sub-block.  With ``cache`` (dict k, v, len) performs
    one decode step, writing the new K/V into the cache IN PLACE, and
    returns (out, cache); in prefill mode builds the cache from the
    full-sequence K/V.  ``pos_offset`` is ``positions[0]`` as a host
    integer, so no step reads the device back."""
    b, s, d = x.shape
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    if cache is None:
        q, k, v = _project_qkv(p, x, cfg, positions)
        if (cfg.attn_backend == "flash" and layer_window is None
                and s % 128 == 0):
            # the kernel takes [B, H, S, D], contiguous
            out = flash_attention_trainable(
                *(t.transpose(1, 2).contiguous() for t in (q, k, v)),
                causal).transpose(1, 2)
        else:
            out = chunked_attention(q, k, v, causal=causal,
                                    window=layer_window,
                                    chunk=cfg.attn_chunk,
                                    q_offset=pos_offset, k_offset=pos_offset)
        new_cache = (_cache_from_prefill(k, v, layer_window, cache_capacity)
                     if mode == "prefill" else None)
    else:
        pos = cache["len"]
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v = _project_qkv(p, x, cfg, positions)
        ring = layer_window is not None and \
            cache["k"].shape[1] == layer_window
        slot = pos % layer_window if ring else pos
        cache["k"][:, slot:slot + 1] = k.to(cache["k"].dtype)
        cache["v"][:, slot:slot + 1] = v.to(cache["v"].dtype)
        if ring:
            # the position each slot holds: the slots up to ``slot`` were
            # written in this lap of the ring, the later ones in the last
            j = torch.arange(layer_window, device=x.device)
            slot_pos = torch.where(j <= slot, pos - slot + j,
                                   pos - slot - layer_window + j)
            out = _attend_cache(q, cache["k"], cache["v"],
                                (slot_pos >= 0) & (slot_pos <= pos))
        else:
            out = decode_attention(q, cache["k"], cache["v"], pos,
                                   window=layer_window)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": pos + 1}
    out = out.reshape(b, s, hq * hd)
    return out @ p["wo"].to(x.dtype), new_cache


def init_kv_cache(cfg, batch, seq_len, layer_window=None, *, device,
                  dtype=torch.bfloat16):
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    s = min(seq_len, layer_window) if layer_window else seq_len
    return {"k": torch.zeros((batch, s, hkv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, s, hkv, hd), dtype=dtype, device=device),
            "len": 0}
