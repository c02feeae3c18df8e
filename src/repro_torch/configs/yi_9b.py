"""yi-9b: llama-architecture dense LM with GQA 32/4 [arXiv:2403.04652].

The preset keeps the JAX package's bf16 default; under
``precision="fp8"`` its MLP (d 4096, d_ff 11008 = 86 x 128) runs on the
fp8 kernels, and with ``attn_backend="flash"`` its prefill attention, 8
q heads on each kv head, takes the flash kernel.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128, rope_theta=5e6,
)
RUN_HINTS = {"train_microbatch": 16, "prefill_microbatch": 8}


def smoke_config():
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, attn_chunk=64)
