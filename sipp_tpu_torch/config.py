"""Run configuration, after sipp_tpu/config.py (SURVEY.md §5: replaces the
reference's hard-coded constants with a small dataclass + CLI).  The
reference pins n=256 / n=128 in code (verifier_circuit.rs:199,
bls_aggregation.rs:93); here everything is a parameter.  The JAX class's
limb_bits and scalar_bits are left out: nothing reads them."""

import dataclasses


@dataclasses.dataclass
class SippConfig:
    n: int = 128                 # pairing vector length (power of two)
    num_devices: int = 1         # mesh size for the sharded prover
    seed: int = 0                # instance seed (testing/benching)

    def __post_init__(self):
        assert self.n >= 1 and self.n & (self.n - 1) == 0, "n must be 2^k"
        assert self.num_devices >= 1
