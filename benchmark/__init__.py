"""The benchmark of sipp_tpu_torch: python3 -m benchmark.run (see run.py).
It imports neither jax nor sipp_tpu; the program under test is loaded only
by the entries (entries/)."""
