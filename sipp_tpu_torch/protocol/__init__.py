"""SIPP protocol layer of the port: the host-spine and on-chip provers, the
verifier (fold-ladder or MSM finals), the host and device transcripts,
statements, entry validation."""

from .prover import sipp_prove, sipp_prove_onchip  # noqa: F401
from .statements import SIPPStatement  # noqa: F401
from .transcript import Transcript  # noqa: F401
from .validate import VerificationError  # noqa: F401
from .verifier import sipp_verify  # noqa: F401
