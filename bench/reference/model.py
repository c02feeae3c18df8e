"""Plain float32 reference of the decoders the benchmark runs: deepseek-
moe-16b and qwen2-moe-a2.7b as the port defines them, with their loss,
gradients and the AdamW update.

It imports nothing of the port and takes only the weights and inputs the
benchmark made (:mod:`bench.harness.model` draws them; each leaf is
upcast to float32 here).  Routing, caches and quantization are worked
out again.  TF32 is off (:func:`exact`).

The recipe: every MoE GEMM (routed and shared experts) multiplies its
input quantized in 1x128 tiles by its weight quantized in 128x128
blocks, each block with its own scale ``amax / qmax`` on a grid
(``"e4m3"``: float8 e4m3; ``"int4"``: the integers -7..7, the control's
lower precision; ``None``: no quantization), and sums in float32.  Its
gradient is the recipe's: ``dx = q(dy) @ q(w)^T`` and ``dw = x^T dy``
(the unquantized x).  Everything else (attention, the dense first
layer, the router, the head, the norms) is float32.

Departures from the published models, all the port's: the load-balance
loss is the batch-level ``E * sum(mean prob * count share) / top_k``
with weight 0.01 (DeepSeekMoE's is sequence-level, weight 0.001;
Qwen1.5-MoE's weight is 0.001); Qwen1.5-MoE's shared expert has no
sigmoid gate here; rotary embeddings rotate the two halves of each head.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

QMAX = {"e4m3": 448.0, "int4": 7.0}
BLOCK = 128


def exact() -> None:
    """No TF32 in any float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _on_grid(x: torch.Tensor, grid: str) -> torch.Tensor:
    if grid == "e4m3":
        return x.to(torch.float8_e4m3fn).float()
    if grid == "int4":
        return torch.round(x).clamp_(-7.0, 7.0)
    raise ValueError(f"unknown grid {grid!r}")


def quant_rows(x: torch.Tensor, grid) -> torch.Tensor:
    """``x`` [M, K] quantized in 1x128 tiles and dequantized (f32)."""
    if grid is None:
        return x
    m, k = x.shape
    t = x.reshape(m, k // BLOCK, BLOCK)
    s = t.abs().amax(-1, keepdim=True) / QMAX[grid]
    s = torch.where(s > 0, s, torch.ones_like(s))
    return (_on_grid(t / s, grid) * s).reshape(m, k)


def quant_blocks(w: torch.Tensor, grid) -> torch.Tensor:
    """``w`` [..., K, N] quantized in 128x128 blocks and dequantized."""
    if grid is None:
        return w
    *lead, k, n = w.shape
    b = w.reshape(*lead, k // BLOCK, BLOCK, n // BLOCK, BLOCK)
    s = b.abs().amax(dim=(-3, -1), keepdim=True) / QMAX[grid]
    s = torch.where(s > 0, s, torch.ones_like(s))
    return (_on_grid(b / s, grid) * s).reshape(w.shape)


class _QLinear(torch.autograd.Function):
    """``q(x) @ wq`` with the recipe's gradient; ``wq`` is ``w``
    quantized (passed in, so one quantization serves every expert)."""

    @staticmethod
    def forward(ctx, x, w, wq, grid):
        ctx.save_for_backward(x, wq)
        ctx.grid = grid
        return quant_rows(x, grid) @ wq

    @staticmethod
    def backward(ctx, dy):
        x, wq = ctx.saved_tensors
        dx = quant_rows(dy, ctx.grid) @ wq.T
        return dx, x.T @ dy, None, None


def qlinear(x, w, wq, grid):
    if grid is None:
        return x @ w
    return _QLinear.apply(x, w, wq, grid)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x [B, S, H, D] rotated by position: the two halves of each head."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, device=x.device,
                                    dtype=torch.float32) / half)
    ang = positions.float()[:, None] * freqs            # [S, half]
    sin, cos = ang.sin()[None, :, None], ang.cos()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v, chunk: int = 1024):
    """Softmax attention of each position over those up to it, in blocks
    of query rows.  q [B, S, H, D]; k, v [B, S, Hkv, D]."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    outs = []
    for s0 in range(0, s, chunk):
        s1 = min(s, s0 + chunk)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, s0:s1], k[:, :s1])
        sc = sc * dh ** -0.5
        mask = torch.arange(s0, s1, device=q.device)[:, None] >= \
            torch.arange(s1, device=q.device)[None]
        sc = sc.masked_fill(~mask, float("-inf"))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1),
                                 v[:, :s1]))
    return torch.cat(outs, 1)


def attention(p, x, sh):
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if sh.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, sh.heads, sh.head_dim)
    k = k.reshape(b, s, sh.kv_heads, sh.head_dim)
    v = v.reshape(b, s, sh.kv_heads, sh.head_dim)
    pos = torch.arange(s, device=x.device)
    q, k = rope(q, pos, sh.rope_theta), rope(k, pos, sh.rope_theta)
    return causal_attention(q, k, v).reshape(b, s, -1) @ p["wo"]


def swiglu(g, u):
    return g * torch.sigmoid(g) * u


def moe(p, x, sh, grid, wq=None):
    """The MoE FFN of tokens x [T, d]: (y [T, d], load-balance loss,
    the experts each token was routed to [T, top_k]).  ``wq``: the
    quantized expert weights, where made once beforehand."""
    t, _ = x.shape
    e, k = sh.experts, sh.top_k
    if wq is None:
        wq = quantized_experts(p, grid)
    probs = torch.softmax(x @ p["router"], -1)
    weights, ids = torch.topk(probs, k, -1)
    if sh.norm_topk:
        weights = weights / weights.sum(-1, keepdim=True)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    token = torch.arange(t, device=x.device).repeat_interleave(k)[order]
    counts = torch.bincount(flat, minlength=e)
    xs = x[token]
    ys, lo = [], 0
    for ex, n in enumerate(counts.tolist()):
        if n:
            r = xs[lo:lo + n]
            g = qlinear(r, p["w_gate"][ex], wq["w_gate"][ex], grid)
            u = qlinear(r, p["w_up"][ex], wq["w_up"][ex], grid)
            ys.append(qlinear(swiglu(g, u), p["w_down"][ex],
                              wq["w_down"][ex], grid))
        lo += n
    y = torch.cat(ys) * weights.reshape(-1)[order][:, None]
    out = torch.zeros_like(x).index_add(0, token, y)
    if sh.d_ff_shared:
        g = qlinear(x, p["shared_gate"], wq["shared_gate"], grid)
        u = qlinear(x, p["shared_up"], wq["shared_up"], grid)
        out = out + qlinear(swiglu(g, u), p["shared_down"],
                            wq["shared_down"], grid)
    lb = e * torch.sum(probs.mean(0) * counts.float() / t) / k
    return out, lb, ids


EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down", "shared_gate", "shared_up",
                  "shared_down")


def quantized_experts(p, grid) -> dict:
    return {n: quant_blocks(p[n].detach(), grid)
            for n in EXPERT_WEIGHTS if n in p}


def dense_mlp(m, h, grid):
    """The dense SwiGLU MLP: the recipe's GEMMs where both widths of a
    weight are multiples of 128 (as the port runs them), else plain."""
    def lin(x, w):
        if grid is not None and w.shape[0] % BLOCK == 0 \
                and w.shape[1] % BLOCK == 0:
            b, s, k = x.shape
            return qlinear(x.reshape(b * s, k), w, quant_blocks(
                w.detach(), grid), grid).reshape(b, s, -1)
        return x @ w
    return lin(swiglu(lin(h, m["w_gate"]), lin(h, m["w_up"])), m["w_down"])


def block(p, x, sh, grid, i, wq=None, routes=None):
    """Layer ``i``: (x, load-balance loss).  ``routes``: where given, a
    dict that receives the layer's routing, ``routes[i]`` the experts of
    each token [B, S, top_k]."""
    x = x + attention(p["attn"], rms_norm(x, p["ln1"]["scale"], sh.eps), sh)
    h = rms_norm(x, p["ln2"]["scale"], sh.eps)
    if i < sh.dense_layers:
        return x + dense_mlp(p["mlp"], h, grid), x.new_zeros(())
    b, s, d = h.shape
    y, lb, ids = moe(p["moe"], h.reshape(b * s, d), sh, grid, wq)
    if routes is not None:
        routes[i] = ids.detach().reshape(b, s, -1)
    return x + y.reshape(b, s, d), lb


def f32_params(tree):
    """An f32 copy of the param tree (each leaf upcast)."""
    if isinstance(tree, dict):
        return {k: f32_params(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [f32_params(v) for v in tree]
    return tree.detach().float()


def hidden(params, tokens, sh, grid, *, remat=False, routes=None):
    """The final-normed hidden states [B, S, d] and the summed
    load-balance loss.  ``remat``: each layer is recomputed in the
    backward (memory, not math).  ``routes``: as :func:`block`'s."""
    x = params["embed"]["embedding"][tokens]
    aux = x.new_zeros(())
    for i, lp in enumerate(params["layers"]):
        if remat:
            x, lb = checkpoint(block, lp, x, sh, grid, i, None, routes,
                               use_reentrant=False)
        else:
            x, lb = block(lp, x, sh, grid, i, None, routes)
        aux = aux + lb
    return rms_norm(x, params["final_norm"]["scale"], sh.eps), aux


def _ce_chunk(hc, head, labels):
    return F.cross_entropy(hc @ head, labels, reduction="sum")


def lm_loss(params, tokens, sh, grid, *, chunk_rows: int = 2048,
            routes=None):
    """Next-token cross-entropy (mean) plus ``aux_weight`` x the summed
    load-balance loss, the head and its loss taken in blocks of rows.
    ``routes``: as :func:`block`'s."""
    h, aux = hidden(params, tokens, sh, grid, remat=True, routes=routes)
    b, s, d = h.shape
    hs = h[:, :-1].reshape(-1, d)
    labels = tokens[:, 1:].reshape(-1)
    total = h.new_zeros(())
    for r0 in range(0, hs.shape[0], chunk_rows):
        total = total + checkpoint(_ce_chunk, hs[r0:r0 + chunk_rows],
                                   params["embed"]["lm_head"],
                                   labels[r0:r0 + chunk_rows],
                                   use_reentrant=False)
    return total / hs.shape[0] + sh.aux_weight * aux


def logits_at(top, layer, tokens, positions, sh, grid, routes=None):
    """Logits [B, len(positions), V] of a teacher-forced forward, each of
    ``tokens`` a batch [B, S] with its ``positions``.  ``top`` holds the
    embedding, the head and the final norm; ``layer(i)`` gives layer
    ``i``'s weights, made when it is reached and dropped after it, so
    that one layer at a time is held; ``routes``, one dict a batch, as
    :func:`block`'s."""
    with torch.no_grad():
        xs = [top["embed"]["embedding"][x] for x in tokens]
        for i in range(sh.layers):
            lp = layer(i)
            wq = quantized_experts(lp["moe"], grid) if "moe" in lp else None
            xs = [block(lp, x, sh, grid, i, wq,
                        None if routes is None else routes[j])[0]
                  for j, x in enumerate(xs)]
            del lp, wq
        return [rms_norm(x[:, pos], top["final_norm"]["scale"], sh.eps)
                @ top["embed"]["lm_head"] for x, pos in zip(xs, positions)]


def adamw_step(params, grads, state, step: int, opt: dict):
    """One AdamW step, in place, as the port defines it: global-norm
    clipping, bias-corrected moments, decoupled weight decay, a linear
    warmup to ``lr`` then cosine decay."""
    with torch.no_grad():
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        warm = min(step / max(opt["warmup_steps"], 1), 1.0)
        prog = min(max((step - opt["warmup_steps"])
                       / max(opt["total_steps"] - opt["warmup_steps"], 1),
                       0.0), 1.0)
        cos = 0.5 * (1 + math.cos(math.pi * prog))
        lr = opt["lr"] * warm * (opt["min_lr_ratio"]
                                 + (1 - opt["min_lr_ratio"]) * cos)
        b1, b2 = opt["b1"], opt["b2"]
        b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            gc = g * clip
            m.mul_(b1).add_(gc, alpha=1 - b1)
            v.mul_(b2).addcmul_(gc, gc, value=1 - b2)
            upd = (m / b1c) / ((v / b2c).sqrt() + opt["eps"])
            p.sub_(lr * (upd + opt["weight_decay"] * p))
