"""The check of outputs: what the window's program produced, held against
the plain reference (:mod:`reference.model`) on the weights and inputs
the benchmark made, after the program's state is freed.

Training: the loss of each of the first steps, each leaf's gradient norm
as the optimizer got it (its first moment after one step over
``1 - b1``) and each leaf's change after the first steps (the f32 master
weights step 4 starts from), the worst leaf by the gap of the norms over
the larger of that leaf's reference norm and the median leaf's.  Leaves
whose reference gradient is under a thousandth of the median leaf's
move by round-off alone and are left out of the change.  A cell's
limits file names the numbers that are held; the others are printed.

Serving: for a sample of the finished batches drawn from the seed, the
longest among them, a teacher-forced reference forward over each
batch's prompts and served tokens, one layer's weights at a time; the
number is the widest gap by which a served token's reference logit lies
below the reference's best at its position.

Both record the experts with rows in each MoE layer under the
reference's routing of those inputs, which the kernel rooflines count
(:mod:`harness.work`).

``control`` readings put the reference at the ``int4`` grid in the
program's place (the calibration of the limits, never in a run).
"""
from __future__ import annotations

import statistics

import torch

from harness.model import change_norms, leaf_paths, make_params
from harness.traffic import Tokens
from reference import model as ref


def reference_train(s, traffic, seed, device, grid) -> dict:
    """The reference's first ``check_steps`` steps on the window's
    batches, each the mean of its ``grad_accum`` microbatches' losses and
    gradients (the port's accumulation: the load-balance statistics are a
    microbatch's): losses, per-leaf gradient norms (clipped, as the
    optimizer takes them; and raw) of step 1 and per-leaf change norms
    after the last, by path; and the experts with rows in each MoE layer
    under its routing of the first microbatch."""
    ref.exact()
    t = traffic
    params = make_params(s, seed, device, f32=True)
    paths = leaf_paths(params)
    leaves = [p for _, p in paths]
    state = {"m": [torch.zeros_like(p) for p in leaves],
             "v": [torch.zeros_like(p) for p in leaves]}
    tokens = Tokens(s.vocab, seed, device)
    losses, gnorm, graw, routes = [], None, None, {}
    n = t["grad_accum"]
    for step in range(1, t["check_steps"] + 1):
        x = tokens.draw(t["batch"], t["seq"])
        loss = 0.0
        for p in leaves:
            p.requires_grad_(True)
        for j, mb in enumerate(x.reshape(n, t["batch"] // n, t["seq"])):
            mloss = ref.lm_loss(params, mb, s, grid,
                                routes=routes if step + j == 1 else None)
            (mloss / n).backward()    # sums into each leaf's .grad
            loss += float(mloss.detach()) / n
        grads = []
        for p in leaves:
            p.requires_grad_(False)
            grads.append(p.grad)
            p.grad = None
        losses.append(loss)
        ref.adamw_step(leaves, grads, state, step, t["opt"])
        if step == 1:
            graw = [float(torch.linalg.vector_norm(g)) for g in grads]
            gnorm = [float(torch.linalg.vector_norm(m)) / (1 - t["opt"]["b1"])
                     for m in state["m"]]
        del grads
    rows = t["batch"] // n * t["seq"]
    return {"paths": [p for p, _ in paths], "loss": losses,
            "grad_norm": gnorm, "grad_raw": graw,
            "change_norm": change_norms(params, s, seed, device),
            "active_experts": {rows: [_experts(routes[i])
                                      for i in sorted(routes)]}}


def _experts(ids: torch.Tensor) -> int:
    """The number of experts that rows ``ids`` [..., top_k] route to."""
    return int(torch.unique(ids).numel())


def _worst(prog: list, refn: list, keep=None) -> tuple:
    """(worst gap over the leaves, its index): |prog - ref| over the
    larger of ref and the median ref."""
    idx = [i for i in range(len(refn)) if keep is None or keep[i]]
    med = statistics.median(refn[i] for i in idx)
    gaps = [(abs(prog[i] - refn[i]) / max(refn[i], med, 1e-30), i)
            for i in idx]
    return max(gaps)


def train_readings(out: dict, r: dict) -> dict:
    """The compared numbers of a training cell."""
    if out["paths"] != r["paths"]:
        raise ValueError("the program's leaves differ from the reference's")
    loss = max(abs(a - b) / abs(b) for a, b in zip(out["loss"], r["loss"]))
    g, gi = _worst(out["grad_norm"], r["grad_norm"])
    med = statistics.median(r["grad_raw"])
    keep = [x >= 1e-3 * med for x in r["grad_raw"]]
    c, ci = _worst(out["change_norm"], r["change_norm"], keep)
    return {"loss_gap": loss, "grad_gap": g, "update_gap": c,
            "active_experts": r["active_experts"],
            "worst_grad_leaf": r["paths"][gi],
            "worst_update_leaf": r["paths"][ci],
            "update_leaves_left_out": [p for p, k in zip(r["paths"], keep)
                                       if not k]}


def _layer_params(s, seed, device, i=None) -> dict:
    """f32 weights drawn again from the seed: layer ``i``'s, or (``None``)
    the embedding, the head and the final norm."""
    pre = "layers/" if i is None else f"layers/{i}/"
    tree = make_params(s, seed, device, f32=True,
                       keep=lambda p: p.startswith(pre) == (i is not None))
    return tree if i is None else tree["layers"][i]


def _ref_logits(parts, s, seed, device, grid, routes=None) -> list:
    """The reference's logits at the served positions of each batch of
    ``parts``, one layer's weights at a time."""
    top = _layer_params(s, seed, device)
    return ref.logits_at(
        top, lambda i: _layer_params(s, seed, device, i),
        [seq for seq, _, _ in parts], [pos for _, _, pos in parts], s, grid,
        routes)


def serve_readings(out: dict, s, seed, device, grid, control=None) -> dict:
    """The widest gap of a served token below the reference's best, over
    the sampled batches, each teacher-forced whole; with ``control`` (a
    grid), also the widest gap of the token that grid's reference puts
    first at each position.  ``active_experts``: the experts with rows
    in each MoE layer under the reference's routing of those batches,
    by the rows routed at once (a prompt's prefill, each decode step),
    the mean over the batches and steps of one size."""
    ref.exact()
    new = out["max_new_tokens"]
    bad = sum(toks.shape[-1] != new or int(toks.min()) < 0
              or int(toks.max()) >= out["vocab"]
              for toks in out["all_tokens"])
    if bad:
        return {"malformed": float(bad), "logit_gap": 1e9}
    parts = []
    for prompts, toks in out["batches"]:
        length = prompts.shape[1]
        parts.append((torch.cat([prompts, toks[:, :-1]], 1), toks,
                      torch.arange(length - 1, length - 1 + new,
                                   device=prompts.device)))
    routes = [{} for _ in parts]
    logits = _ref_logits(parts, s, seed, device, grid, routes)
    gap = 0.0
    for lg, (_, served, _) in zip(logits, parts):
        got = lg.gather(-1, served[..., None])[..., 0]
        gap = max(gap, float((lg.max(-1).values - got).max()))
    res = {"malformed": 0.0, "logit_gap": gap,
           "active_experts": _serve_experts(parts, routes, new)}
    if control is not None:
        ctl = _ref_logits(parts, s, seed, device, control)
        cgap = 0.0
        for lg, lc in zip(logits, ctl):
            got = lg.gather(-1, lc.argmax(-1)[..., None])[..., 0]
            cgap = max(cgap, float((lg.max(-1).values - got).max()))
        res["control_logit_gap"] = cgap
    return res


def _serve_experts(parts, routes, new) -> dict:
    """Experts with rows a MoE layer, by rows routed at once: each
    batch's prompt positions together, each decode step's one position
    of every sequence; the mean over the observations of one size."""
    seen: dict = {}
    for (seq, _, _), r in zip(parts, routes):
        b, length = seq.shape[0], seq.shape[1] - new + 1
        for i in sorted(r):
            ids = r[i]
            obs = [(b * length, _experts(ids[:, :length]))]
            obs += [(b, _experts(ids[:, length + j]))
                    for j in range(new - 1)]
            for rows, count in obs:
                seen.setdefault(rows, {}).setdefault(i, []).append(count)
    return {rows: [sum(c) / len(c) for _, c in sorted(by_layer.items())]
            for rows, by_layer in seen.items()}


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the limited numbers."""
    rows = [(k, float(readings[k]), float(v)) for k, v in limits.items()]
    return all(val <= lim for _, val, lim in rows), rows
