"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Same sub-package layout and names as ``repro``; the JAX package stays
the reference and every module here is held to it by a parity test in
``tests/test_torch_*.py``.  This package imports torch, numpy and
scipy only — never jax and never ``repro``.

Entry points run on ``cuda`` by default and raise when no card is
present unless the caller passes ``device="cpu"`` (see
:func:`repro_torch.device.resolve_device`).  On a CUDA tensor the
wire ops launch the hand-written kernels in ``kernels/csrc/``
(``mixed_res.cu`` for the packed plane, ``quant_pack.cu`` for the
sign plane); on a CPU tensor they run the plain PyTorch versions in
``kernels/ref.py``.
"""
