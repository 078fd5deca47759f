"""repro_torch.kernels — the kernels, written by hand in CUDA C++ for
Hopper, and the wire and decode paths built on them.

* K1–K3 (``mixed_res.py``, source ``csrc/mixed_res.cu``): the packed
  plane's two-pass encode (K1 reduce, K2 emit) and fused decode +
  weighted reduce (K3);
* K4–K5 (``quant_pack.py``, source ``csrc/quant_pack.cu``): the sign
  plane's bit pack (K4) and fused unpack + scaled reduce (K5);
* K6 (``flash_decode.py``, source ``csrc/flash_decode.cu``): the serve
  path's single-token GQA decode attention over the KV cache.

Beside them: their plain PyTorch versions (``ref.py``), which run for
CPU tensors; the ops that compose them into wire and decode paths
(``ops.py``); the :class:`WirePath` spec that picks the plane and
lowering; the launch counters :data:`LAUNCHES`."""
from .launch import LAUNCHES, reset_launch_counts
from .mixed_res import (H_DBAR, H_DWQ, H_INF, H_LAM, H_STEP, code_width,
                        code_words_per_row)
from .ops import (MixedResWire, flash_decode_op, mixed_res_encode,
                  mixed_res_wire_aggregate, mixed_res_wire_reduce,
                  packed_sign_weighted_sum, sign_dequant_reduce_op,
                  sign_pad_len, signpack_op, wire_view)
from .wire import PACKED_DIM_LIMIT, WirePath, check_packed_dim

__all__ = [
    "H_DBAR", "H_DWQ", "H_INF", "H_LAM", "H_STEP", "LAUNCHES",
    "MixedResWire", "PACKED_DIM_LIMIT", "WirePath", "check_packed_dim",
    "code_width", "code_words_per_row", "flash_decode_op",
    "mixed_res_encode", "mixed_res_wire_aggregate", "mixed_res_wire_reduce",
    "packed_sign_weighted_sum", "reset_launch_counts",
    "sign_dequant_reduce_op", "sign_pad_len", "signpack_op", "wire_view",
]
