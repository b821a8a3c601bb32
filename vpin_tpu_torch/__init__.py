"""PyTorch/CUDA port of vpin_tpu: encrypted CNN inference over curve E2 with
the witness trace recorded, and CP-SNARK proofs of that trace over
ristretto255 (the full SNARK with the SPARK eval proof, or transparent), on
an NVIDIA H100.

Same layout and names as vpin_tpu (field/, curve/, nn/, transcript/,
commit/, poly/, nizk/, sumcheck/, snark/, spark/, gadgets/, runner/).  Five
hand-written CUDA kernels (csrc/) do the field and group work: the
Montgomery product (K1), the complete E2 addition (K2), the whole E2
double-and-add ladder (K3), the ristretto255 addition (K4) and the whole
ristretto255 double-and-add ladder (K5), each beside a plain PyTorch version
of the same function.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain version.

This package imports torch and never JAX or vpin_tpu; convert.py carries
state from vpin_tpu's arrays for the tests.
"""
