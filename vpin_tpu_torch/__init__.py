"""PyTorch/CUDA port of vpin_tpu: encrypted CNN inference over curve E2 with
the witness trace recorded, and transparent CP-SNARK proofs of that trace
over ristretto255, on an NVIDIA H100.

Same layout and names as vpin_tpu (field/, curve/, nn/, transcript/,
commit/, poly/, nizk/, sumcheck/, snark/, gadgets/, runner/).  The hot path
runs four hand-written CUDA kernels (csrc/): the Montgomery product (K1),
the complete E2 addition (K2), the whole E2 double-and-add ladder (K3) and
the ristretto255 addition (K4), each beside a plain PyTorch version of the
same function.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain version.  The
SPARK eval proof (the full SNARK) is not ported yet.

This package imports torch and never JAX or vpin_tpu; convert.py carries
state from vpin_tpu's arrays for the tests.
"""
