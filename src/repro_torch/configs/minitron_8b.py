"""minitron-8b: width-pruned Nemotron dense LM [arXiv:2407.14679].

The preset keeps the JAX package's bf16 default; under
``precision="fp8"`` its MLP's down projection contracts over K = 16384.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000, head_dim=128, rope_theta=5e5,
)
RUN_HINTS = {"train_microbatch": 16, "prefill_microbatch": 8}


def smoke_config():
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, attn_chunk=64)
