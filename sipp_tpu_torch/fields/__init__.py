"""Field layer of the port: BN254 Fq/Fr (fq.py), the Fq2/Fq6/Fq12 tower
(tower.py), Goldilocks (the transcript's hash field) and Poseidon over it
(poseidon.py)."""

from .. import params
from .fq import Field

FQ = Field(params.P)
FR = Field(params.R)
# Goldilocks p = 2^64 - 2^32 + 1: L = 5, R = 2^80, the JAX package's FGL
# format, so device transcript states compare limb for limb
FGL = Field(params.GOLDILOCKS_P)

assert FQ.L == 16 and FR.L == 16 and FGL.L == 5
