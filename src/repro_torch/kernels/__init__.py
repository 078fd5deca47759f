"""repro_torch.kernels — the hand-written CUDA wire kernels K1–K3
(``mixed_res.py``, sources in ``csrc/``), their plain PyTorch versions
(``ref.py``), the packed wire path built on them (``ops.py``) and the
:class:`WirePath` spec."""
from .mixed_res import (H_DBAR, H_DWQ, H_INF, H_LAM, H_STEP,
                        LAUNCHES, code_width, code_words_per_row,
                        reset_launch_counts)
from .ops import (MixedResWire, mixed_res_encode, mixed_res_wire_aggregate,
                  mixed_res_wire_reduce, sign_pad_len, wire_view)
from .wire import PACKED_DIM_LIMIT, WirePath, check_packed_dim

__all__ = [
    "H_DBAR", "H_DWQ", "H_INF", "H_LAM", "H_STEP", "LAUNCHES",
    "MixedResWire", "PACKED_DIM_LIMIT", "WirePath", "check_packed_dim",
    "code_width", "code_words_per_row", "mixed_res_encode",
    "mixed_res_wire_aggregate", "mixed_res_wire_reduce",
    "reset_launch_counts", "sign_pad_len", "wire_view",
]
