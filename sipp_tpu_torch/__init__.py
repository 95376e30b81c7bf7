"""sipp-tpu-torch: the PyTorch + CUDA port of sipp_tpu (SIPP over BN254).

Plain PyTorch functions on int64 16-bit-limb Montgomery tensors (the JAX
package's device format), with hand-written CUDA kernels for the Miller
product, the final exponentiation, the fold ladders, the transcript tail and
the per-lane exp ladders (ops/).  Imports
torch, numpy, ctypes and the standard library only: never jax or sipp_tpu.
"""
