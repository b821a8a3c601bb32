"""PyTorch/CUDA port of vpin_tpu: encrypted CNN inference over curve E2 with
the witness trace recorded, on an NVIDIA H100.

Same layout and names as vpin_tpu (field/, curve/, nn/, runner/).  The hot
path runs three hand-written CUDA kernels (csrc/): the Montgomery product
(K1), the complete E2 addition (K2) and the whole E2 double-and-add ladder
(K3), each beside a plain PyTorch version of the same function.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``, where every
kernel wrapper takes its plain version.

This package imports torch and never JAX or vpin_tpu; convert.py carries
state from vpin_tpu's arrays for the tests.
"""
