"""Smoke-sized configurations and mixes for the CPU tests: the port's
reduced presets (``smoke:<arch>``) under the cells' recipes, and short
mixes of each kind."""

RECIPE = {"precision": "fp8", "dtype": "bfloat16", "attn_backend": "chunked",
          "remat": True, "moe_dispatch": "ragged", "wgrad_precision": "bf16"}

DS_SMOKE = {
    "source": "the port's reduced deepseek-moe-16b preset",
    "port_preset": "smoke:deepseek-moe-16b", "vocab_size": 512,
    "hidden_size": 256, "intermediate_size": 512,
    "moe_intermediate_size": 128, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4,
    "n_shared_experts": 1, "n_routed_experts": 8, "num_experts_per_tok": 2,
    "first_k_dense_replace": 1, "norm_topk_prob": False,
    "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "attention_bias": False, "reduced": [],
    "assumed": {}, "recipe": RECIPE}

QWEN_SMOKE = {
    "source": "the port's reduced qwen2-moe-a2.7b preset",
    "port_preset": "smoke:qwen2-moe-a2.7b", "vocab_size": 512,
    "hidden_size": 256, "intermediate_size": 512,
    "moe_intermediate_size": 128, "shared_expert_intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 4, "num_experts": 8, "num_experts_per_tok": 2,
    "norm_topk_prob": False, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "tie_word_embeddings": False,
    "reduced": [], "assumed": {"qkv_bias": "true"}, "recipe": RECIPE}

OPT = {"lr": 0.0003, "b1": 0.9, "b2": 0.95, "eps": 1e-08,
       "weight_decay": 0.1, "warmup_steps": 5, "total_steps": 10000,
       "min_lr_ratio": 0.1, "clip_norm": 1.0}

TRAIN = {"kind": "train", "batch": 4, "seq": 64, "grad_accum": 2,
         "check_steps": 3, "opt": OPT}
DECODE = {"kind": "generate", "batch": 4, "prompt": {"fixed": 64},
          "max_new_tokens": 8, "eos_id": -1, "check_batches": 1}
PREFILL = {"kind": "generate", "batch": 2,
           "prompt": {"lognormal": {"median": 64, "sigma": 1.0, "count": 8,
                                    "min": 16, "max": 160}, "strata": 4},
           "max_new_tokens": 1, "eos_id": -1, "check_batches": 3}

#: limits for the smoke sizes, from their sound readings and controls
#: (CPU: sound grad_gap <= 0.02, control >= 0.099; sound logit gaps
#: <= 0.17, control >= 0.69)
LIMITS_TRAIN = {"loss_gap": 0.02, "grad_gap": 0.05, "update_gap": 0.02}
LIMITS_SERVE = {"malformed": 0.0, "logit_gap": 0.5}
