"""repro_torch.models — the dense GQA decoders of the JAX package's
model zoo (granite-3-8b, minitron-8b, qwen3-14b), on one card.

Exports what ``repro.models`` exports except ``loss_fn`` (training the
LM is not ported), plus the tree converters.  On the card, every
attention layer's decode step runs kernel K6
(``kernels/csrc/flash_decode.cu``); the projections, MLP and LM head
are plain matrix products.
"""
from .config import INPUT_SHAPES, InputShape, ModelConfig
from .convert import params_from_jax, params_to_jax
from .transformer import (decode_step, forward, init_cache, init_model,
                          param_count)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "decode_step",
           "forward", "init_cache", "init_model", "param_count",
           "params_from_jax", "params_to_jax"]
