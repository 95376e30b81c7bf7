"""SIPP protocol layer of the port: host-spine prover, fold-ladder
verifier, transcript, statements, entry validation."""

from .prover import sipp_prove  # noqa: F401
from .statements import SIPPStatement  # noqa: F401
from .transcript import Transcript  # noqa: F401
from .validate import VerificationError  # noqa: F401
from .verifier import sipp_verify  # noqa: F401
