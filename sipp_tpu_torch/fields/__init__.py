"""Field layer of the port: BN254 Fq/Fr (fq.py), the Fq2/Fq6/Fq12 tower
(tower.py), and the host half of Poseidon over Goldilocks (poseidon.py)."""

from .. import params
from .fq import Field

FQ = Field(params.P)
FR = Field(params.R)

assert FQ.L == 16 and FR.L == 16
