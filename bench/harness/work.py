"""The work a window needs, from the configuration's shapes alone, and
the H100's peaks.

Model FLOPs (``model_flops_*``) count each active matmul of the
published model once a forward (routed top-k and shared experts,
attention projections, the dense layer, the router, the head) plus
causal attention, by precision class: ``"fp8"`` for the expert GEMMs,
``"bf16"`` for the rest; training counts the forward and the backward
(3x), not remat's recomputation.  The grouped-GEMM work
(``gmm_work``, ``wgrad_work``) lists each mathematical GEMM of the MoE
layers with its FLOPs and the bytes of its operands read once and its
output written once, at the recipe's precision: e4m3 payloads with f32
scales (1x128 for activations, 128x128 for weights), the output in the
dtype the recipe writes; an expert's weights count only where it has
rows.  Which experts have rows is the reference's routing of the
window's own inputs (``active``: the check of outputs records it on its
sampled batches, by the rows routed at once); a size it did not see
takes the expectation under uniform routing (:func:`active_experts`),
which at every such size of the cells is all of the experts.  Under
remat (the configuration's ``remat``) the backward runs each forward
GEMM again, and the training work counts it: the window needs it.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense rates (they assume the 700 W power
#: limit): FLOP/s by precision class, HBM bytes/s
PEAK_FLOPS = {"fp8": 1979e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def _per_token_flops(s, head: bool) -> dict:
    d, hd = s.d, s.head_dim
    attn = 2 * d * hd * (s.heads + 2 * s.kv_heads) + 2 * s.heads * hd * d
    bf16 = s.layers * attn + s.dense_layers * 2 * 3 * d * s.d_ff_dense \
        + s.moe_layers * 2 * d * s.experts
    fp8 = s.moe_layers * 2 * 3 * d * (s.top_k * s.d_ff_expert
                                      + s.d_ff_shared)
    if head:
        bf16 += 2 * d * s.vocab
    return {"fp8": fp8, "bf16": bf16}


def attention_flops(s, pairs: int) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs, every layer: 4 x
    heads x head_dim a pair."""
    return 4.0 * s.heads * s.head_dim * pairs * s.layers


def model_flops_prefill(s, batch: int, length: int) -> dict:
    """A prefill of ``batch`` prompts of ``length``: every position's
    layers, causal attention, the head at the last position."""
    out = {k: v * batch * length for k, v in
           _per_token_flops(s, head=False).items()}
    out["bf16"] += batch * (2 * s.d * s.vocab
                            + attention_flops(s, length * (length + 1) // 2))
    return out


def model_flops_decode_step(s, batch: int, cache_len: int) -> dict:
    """One token a sequence attending ``cache_len`` earlier positions and
    itself."""
    out = {k: v * batch for k, v in _per_token_flops(s, head=True).items()}
    out["bf16"] += batch * attention_flops(s, cache_len + 1)
    return out


def model_flops_train_step(s, batch: int, seq: int) -> dict:
    """Forward and backward (3x the forward) of ``batch`` x ``seq``
    tokens with the head at every position."""
    fwd = {k: v * batch * seq for k, v in
           _per_token_flops(s, head=True).items()}
    fwd["bf16"] += batch * attention_flops(s, seq * (seq + 1) // 2)
    return {k: 3 * v for k, v in fwd.items()}


def seconds_at_peak(flops: dict) -> float:
    return sum(v / PEAK_FLOPS[k] for k, v in flops.items())


def active_experts(s, rows_in: int) -> float:
    """Experts with rows among ``rows_in`` tokens each routed to top_k of
    them: the expectation under uniform routing."""
    p_empty = (1.0 - s.top_k / s.experts) ** rows_in
    return s.experts * (1.0 - p_empty)


def _gemm_fp8(rows, k, n, groups, out_bytes):
    """An fp8 GEMM: e4m3 A with 1x128 f32 scales, e4m3 B with 128x128
    f32 scales, ``out_bytes`` a result element."""
    a = rows * k * (1 + 4 / 128)
    b = groups * k * n * (1 + 4 / (128 * 128))
    return {"flops": 2.0 * rows * k * n, "bytes": a + b + rows * n * out_bytes,
            "peak": "fp8"}


def moe_gemms(s, tokens: int, groups: float) -> list:
    """The six forward GEMMs of one MoE layer over ``tokens``: routed
    gate, up (bf16 out), down (bf16 out); shared gate, up (bf16 out),
    down (f32 out)."""
    r, d, f, fs = tokens * s.top_k, s.d, s.d_ff_expert, s.d_ff_shared
    out = [("routed_gate", r, d, f, groups, 2), ("routed_up", r, d, f,
                                                 groups, 2),
           ("routed_down", r, f, d, groups, 2)]
    if fs:
        out += [("shared_gate", tokens, d, fs, 1, 2),
                ("shared_up", tokens, d, fs, 1, 2),
                ("shared_down", tokens, fs, d, 1, 4)]
    return out


def _groups(s, tokens: int, active) -> list:
    """Experts with rows in each MoE layer for one routing of ``tokens``:
    ``active[tokens]`` (one count a layer) where given, else the
    expectation under uniform routing."""
    if active and tokens in active:
        return list(active[tokens])
    return [active_experts(s, tokens)] * s.moe_layers


def gmm_work(s, tokens: int, *, backward: bool, remat: bool = False,
             active=None) -> list:
    """Grouped-GEMM work of one forward (and, with ``backward``, its
    dgrads: dy e4m3 @ w^T e4m3, f32 out; with ``remat`` too, the forward
    run again) of every MoE layer over the ``tokens`` of one routing
    decision."""
    out = []
    for groups in _groups(s, tokens, active):
        for _, rows, k, n, g, ob in moe_gemms(s, tokens, groups):
            fwd = _gemm_fp8(rows, k, n, g, ob)
            out += [fwd, fwd] if backward and remat else [fwd]
            if backward:
                out.append(_gemm_fp8(rows, n, k, g, 4))
    return out


def wgrad_work(s, tokens: int, active=None) -> list:
    """The wgrads of one backward of every MoE layer: dw = x^T dy, bf16
    operands and bf16 dw, at the bf16 peak."""
    out = []
    for groups in _groups(s, tokens, active):
        for _, rows, k, n, g, _ in moe_gemms(s, tokens, groups):
            out.append({"flops": 2.0 * rows * k * n,
                        "bytes": 2 * rows * k + 2 * rows * n + 2 * g * k * n,
                        "peak": "bf16"})
    return out


def least_seconds(gemms: list) -> float:
    """Sum over GEMMs of max(FLOPs / peak, bytes / HBM bandwidth)."""
    return sum(max(g["flops"] / PEAK_FLOPS[g["peak"]],
                   g["bytes"] / PEAK_BYTES) for g in gemms)


def window_model_flops(s, wk: dict) -> dict:
    """Model FLOPs of a window's work (``drivers.Window.work``): its
    training steps, or each batch's prefill and decode steps."""
    if wk["kind"] == "train":
        one = model_flops_train_step(s, wk["batch"], wk["seq"])
        return {k: v * wk["steps"] for k, v in one.items()}
    total = {"fp8": 0.0, "bf16": 0.0}
    b, new = wk["batch"], wk["max_new_tokens"]
    for length in wk["lengths"]:
        parts = [model_flops_prefill(s, b, length)] + [
            model_flops_decode_step(s, b, length + j) for j in range(new - 1)]
        for p in parts:
            for k, v in p.items():
                total[k] += v
    return total


def _microbatch(wk: dict) -> int:
    """Tokens of one routing decision of a training step."""
    return wk["batch"] // wk["grad_accum"] * wk["seq"]


def window_gmm(s, wk: dict, active=None) -> list:
    """The grouped-GEMM work of a window (forward; in training, dgrad
    and remat's second forward too, a microbatch at a time)."""
    if wk["kind"] == "train":
        return gmm_work(s, _microbatch(wk), backward=True,
                        remat=wk["remat"], active=active) \
            * (wk["grad_accum"] * wk["steps"])
    b, new = wk["batch"], wk["max_new_tokens"]
    out = []
    for length in wk["lengths"]:
        out += gmm_work(s, b * length, backward=False, active=active)
        out += gmm_work(s, b, backward=False, active=active) * (new - 1)
    return out


def window_wgrad(s, wk: dict, active=None) -> list:
    """The wgrad work of a training window (none when serving)."""
    if wk["kind"] != "train":
        return []
    return wgrad_work(s, _microbatch(wk), active) \
        * (wk["grad_accum"] * wk["steps"])
