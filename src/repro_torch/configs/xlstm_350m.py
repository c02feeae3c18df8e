"""xlstm-350m: sLSTM + mLSTM recurrent LM [arXiv:2405.04517].

24 layers = 4 cycles of 5 mLSTM blocks and 1 sLSTM block.  No separate
MLP (``d_ff=0``): the projections live inside the xLSTM blocks, as plain
products in both packages, so this family launches no kernel in any
recipe.  A prompt of S > 1 tokens runs the mLSTM chunkwise in chunks of
``min(256, S)`` and needs ``S % min(256, S) == 0``, as in the JAX package.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
)
RUN_HINTS = {"train_microbatch": 32, "prefill_microbatch": 16,
             "mlstm_chunk": 256}


def smoke_config():
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=2, num_kv_heads=2,
        head_dim=64, vocab_size=512,
        block_pattern=("mlstm", "slstm"))
