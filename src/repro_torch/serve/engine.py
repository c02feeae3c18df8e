"""Batched serving engine: prefill + greedy/temperature decode loop with a
static KV-cache capacity (per-sequence stop with a done mask; finished
rows keep decoding into padding).

Plan-aware decode, as in the JAX package: a decode step's MoE grouped
GEMM sees tiny, constant M (batch x top_k routed rows in all), where the
prefill's 128-row tiles waste most of each fetched A tile.  An MoE
engine therefore selects a decode config ONCE at construction from the
decode pool (``plan.decode_config``, cost-model ranked, cached beside the
measured autotune entries; on Hopper block_m 8 has no CUDA variant, so
the selection is 16 rows) and rebuilds the decode model over it;
``decode_batch_size`` is the M-bucket hint of that selection (the engine
stays right for any batch).  The selection keeps the model's config
(``gemm_backend`` folded in) and takes only its tile geometry, so the
backend and the recipe switches (``fuse_producer``, ``wgrad_precision``)
carry over; under ``"padded_baseline"`` decode pads each group to 16
rows.  A model with no MoE decodes on the model's config, as prefill
does.  ``kernel_config`` pins the prefill phase's tile shapes and
``decode_kernel_config`` the decode phase's, skipping the selection;
the phases share one param tree.

The batch passes to the model's prefill whole, so a VLM's
``patch_embeds`` and whisper's ``frames`` reach it; a VLM's cache holds
its patch positions too (``num_patches`` more slots).

The engine runs on CUDA unless ``device="cpu"`` is passed; without a card
it raises.  Everything runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import plan as plan_mod
from repro_torch.kernels.plan import KernelConfig
from repro_torch.models import model_zoo
from repro_torch.models.model_zoo import Model


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor          # [B, max_new]
    num_generated: torch.Tensor   # [B]


class Engine:
    def __init__(self, model: Model, params, *, max_new_tokens: int = 32,
                 eos_id: int = -1, temperature: float = 0.0,
                 kernel_config: Optional[KernelConfig] = None,
                 decode_kernel_config: Optional[KernelConfig] = None,
                 decode_batch_size: int = 8, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model runs on {model.device}, the engine "
                             f"on {self.device}")
        leaf = params["final_norm"]["scale"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine runs "
                             f"on {self.device}")
        if kernel_config is not None:
            model = model_zoo.with_kernel_config(model, kernel_config)
        self.model = model
        self.prefill_config = model.cfg.resolved_kernel_config
        # the decode config: selected exactly once an engine (None: decode
        # runs the model's own config)
        self.decode_config = (
            decode_kernel_config if decode_kernel_config is not None
            else self._select_decode_config(model.cfg, decode_batch_size,
                                            self.device))
        self._decode_model = (
            model_zoo.with_kernel_config(model, self.decode_config)
            if self.decode_config is not None else model)
        self.params = params
        self.max_new = max_new_tokens
        self.eos_id = eos_id
        self.temperature = temperature

    @staticmethod
    def _select_decode_config(cfg, batch_hint: int,
                              device) -> Optional[KernelConfig]:
        """The decode pool's selection for an MoE model's routed GEMM at
        ``batch_hint`` rows a step, with the model's config around its
        tile geometry; None for a model with no MoE, or where the decode
        pool has no legal entry for its dims."""
        if cfg.moe is None:
            return None
        m = max(batch_hint, 1) * cfg.moe.top_k
        k, n, g = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.num_experts
        try:
            sel = plan_mod.decode_config(m, k, n, g, backend=cfg.gemm_backend,
                                         device=device)
        except ValueError:
            return None
        base = cfg.resolved_kernel_config
        if base is not None:
            sel = base.with_(block_m=sel.block_m, block_n=sel.block_n,
                             block_k=sel.block_k)
        return sel

    def _sample(self, logits, generator):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def prefill(self, batch, cache_capacity: int):
        """Last-position logits [B, V] and the caches of the prompt."""
        logits, cache = self.model.prefill(self.params, batch,
                                           cache_capacity=cache_capacity)
        return logits[:, -1], cache

    def decode_step(self, tokens, cache):
        """One token per row [B] against the caches -> (logits [B, V],
        caches); the caches are updated in place."""
        logits, cache = self._decode_model.decode_step(
            self.params, tokens[:, None], cache)
        return logits[:, 0], cache

    @torch.inference_mode()
    def generate(self, batch, *, generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        cfg = self.model.cfg
        extra = cfg.num_patches if cfg.family == "vlm" else 0
        cap = batch["tokens"].shape[1] + extra + self.max_new
        last_logits, cache = self.prefill(batch, cap)
        tok = self._sample(last_logits, generator)
        done = torch.zeros_like(tok, dtype=torch.bool)
        out = [tok]
        for _ in range(self.max_new - 1):
            logits, cache = self.decode_step(tok, cache)
            nxt = self._sample(logits, generator)
            nxt = torch.where(done, torch.zeros_like(nxt), nxt)
            done = done | (nxt == self.eos_id)
            out.append(nxt)
            tok = nxt
        tokens = torch.stack(out, dim=1)
        num = torch.full((tokens.shape[0],), tokens.shape[1],
                         dtype=torch.int32, device=tokens.device)
        return GenerationResult(tokens=tokens, num_generated=num)


# ---------------------------------------------------------------------------
# Kernel contracts (repro_torch.analysis layer 1)
# ---------------------------------------------------------------------------
# Decode plan discipline, checked by a REAL smoke generate (mode="run"):
# one decode-config pool selection per Engine, block_m <= 16, and one plan
# build per expert group (routed + shared) per MoE layer per forward, the
# decode forwards' on the decode config's tile height.  The JAX package
# traces its decode loop once over stacked layers and counts one build per
# phase per group (4); the port runs every layer of every forward eagerly,
# so it counts 2 x MoE layers x (1 + decode forwards): 2 x 2 x 6 = 24 for
# the smoke generate of 6 tokens.

from repro_torch.analysis.contracts import CONTRACTS as _CONTRACTS  # noqa: E402
from repro_torch.analysis.contracts import register_contract as \
    _register_contract  # noqa: E402


@contextlib.contextmanager
def _scratch_tileplan_cache():
    """Route the decode selection's cache writes to a throwaway file,
    never the user's cache."""
    import os
    import tempfile
    prev = os.environ.get(plan_mod.CACHE_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[plan_mod.CACHE_ENV] = os.path.join(
            tmp, "tileplan_cache.json")
        try:
            yield
        finally:
            if prev is None:
                os.environ.pop(plan_mod.CACHE_ENV, None)
            else:
                os.environ[plan_mod.CACHE_ENV] = prev


def _smoke_engine_inputs(device):
    """The smoke qwen2-moe-a2.7b in fp8 (2 MoE layers), seeded params and
    a batch of 2 prompts of 16 tokens."""
    from repro_torch.configs import smoke_config
    cfg = dataclasses.replace(smoke_config("qwen2-moe-a2.7b"),
                              precision="fp8")
    model = model_zoo.make_model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen)
    batch = model_zoo.synthetic_batch(gen, cfg, 16, 2)
    return model, params, batch


def _build_engine_contract(device):
    model, params, batch = _smoke_engine_inputs(device)

    def fn():
        with _scratch_tileplan_cache():
            engine = Engine(model, params, max_new_tokens=6,
                            decode_batch_size=2, device=device)
        return engine, engine.generate(batch)
    return fn, ()


def _check_engine_contract(result, events, *, batch, new, moe_layers):
    engine, res = result
    msgs = []
    dc = engine.decode_config
    if dc is None:
        msgs.append("engine resolved no decode config for an MoE model")
    elif dc.block_m > 16:
        msgs.append(f"decode config block_m={dc.block_m} > 16: not a "
                    f"decode-pool entry")
    if tuple(res.tokens.shape) != (batch, new):
        msgs.append(f"generate returned tokens of shape "
                    f"{tuple(res.tokens.shape)}, expected {(batch, new)}")
    builds = [e for e in events if e.kind == "plan_build"]
    # the prefill's builds (routed and shared, each MoE layer) use the
    # prefill tile height, every later one the decode config's
    prefill = 2 * moe_layers
    bad = [e.data["block_m"] for e in builds[prefill:]
           if dc is not None and e.data["block_m"] != dc.block_m]
    if bad:
        msgs.append(f"{len(bad)} decode-phase plan build(s) used block_m "
                    f"{sorted(set(bad))}, not the decode config's "
                    f"{dc.block_m}")
    return msgs


def _decode_plan_fields(*, moe_layers: int, batch: int, new: int) -> dict:
    return dict(decode_selects=1, plan_builds=2 * moe_layers * new,
                extra=functools.partial(_check_engine_contract, batch=batch,
                                        new=new, moe_layers=moe_layers))


_register_contract(
    "engine.generate.decode_plan",
    description="one decode-config selection per Engine; every forward "
                "of a generate (prefill + 5 decode steps) builds plan "
                "metadata once per expert group per MoE layer; decode "
                "tiles block_m<=16",
    build=_build_engine_contract, mode="run",
    **_decode_plan_fields(moe_layers=2, batch=2, new=6))


def decode_plan_contract(*, moe_layers: int, batch: int, new: int):
    """The engine contract scaled to a model of ``moe_layers`` MoE layers
    generating ``new`` tokens for ``batch`` prompts (for example the
    full-width qwen2-moe-a2.7b: 24 layers, 2 x 24 x 16 plan builds), to
    check with ``check_contract(fn, contract)`` where ``fn()`` builds the
    Engine and returns ``(engine, engine.generate(batch))``."""
    return dataclasses.replace(
        _CONTRACTS["engine.generate.decode_plan"], build=None,
        **_decode_plan_fields(moe_layers=moe_layers, batch=batch, new=new))


# ---------------------------------------------------------------------------
# Compile contracts (repro_torch.analysis layer 5: REPRO-T02)
# ---------------------------------------------------------------------------
# A second same-shape generate prepares nothing: the selection ran once at
# construction, and no kernel library is built or loaded again.

from repro_torch.analysis.retrace import PREPARES as _PREPARES  # noqa: E402
from repro_torch.analysis.retrace import \
    register_compile_contract as _register_compile_contract  # noqa: E402


def _build_engine_retrace(device):
    model, params, batch = _smoke_engine_inputs(device)
    with _scratch_tileplan_cache():
        engine = Engine(model, params, max_new_tokens=6,
                        decode_batch_size=2, device=device)

    def generate(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return engine.generate(batch, generator=gen)
    return generate, [(42,), (43,)]


_register_compile_contract(
    "engine.generate.retrace",
    description="a second same-shape generate prepares nothing",
    build=_build_engine_retrace,
    expected=dict.fromkeys(_PREPARES, 0), warmup=1, rule="REPRO-T02")
