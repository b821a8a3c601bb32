"""The plain reference: what decides whether a run is correct.  It imports
none of JAX, vpin_tpu or vpin_tpu_torch."""
