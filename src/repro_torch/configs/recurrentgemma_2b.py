"""recurrentgemma-2b: RG-LRU and local-attention hybrid, 1 attention
block to 2 recurrent ones [arXiv:2402.19427].

26 layers = 8 cycles of ``(rglru, rglru, attn)`` and a tail of
``(rglru, rglru)``.  The attention blocks are MQA (1 kv head, head dim
256) over a 2048-token sliding window, so they never take the flash
kernel; a prompt longer than the window leaves a ring-buffer cache.  The
preset keeps the JAX package's bf16 default; under ``precision="fp8"``
every block's MLP (d 2560, d_ff 7680) runs on the fp8 kernels.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "attn"),
    window=2048, lru_width=2560, conv_width=4,
)
RUN_HINTS = {"train_microbatch": 32, "prefill_microbatch": 16}


def smoke_config():
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=2, num_kv_heads=1,
        head_dim=64, d_ff=256, vocab_size=512, window=32, lru_width=128,
        attn_chunk=64)
