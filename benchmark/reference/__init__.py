"""The benchmark's plain reference: BN254 arithmetic, the transcript and
SIPP's outputs in plain Python and NumPy, worked out from the integers the
benchmark made.  It imports neither jax nor sipp_tpu nor sipp_tpu_torch, and
takes nothing that the program made."""
