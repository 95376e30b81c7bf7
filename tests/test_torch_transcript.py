"""The device transcript of the port (fields/poseidon.py device half,
protocol/transcript_device.py) and the plain versions of K4/K5
(ops/transcript.py) against golden vectors frozen from the JAX package's
poseidon.permute_device, transcript_device.append_fq12 / get_challenge and
FR Fermat inversion (the XLA twins of pallas_transcript's kernels, held
bit-identical to them by tests/test_pallas_transcript.py), against the
native host chain, and against the host transcript's to_u32_digits quirk on
digests with zero digits.  Exact equality: every value is canonical.
Regenerate the golden file with

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py

The CUDA kernels are compared with these plain versions on the card by
chip_smoke.py."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert, curves, native, params
from sipp_tpu_torch.fields import FGL, FR, poseidon, tower
from sipp_tpu_torch.ops import _build, transcript
from sipp_tpu_torch.protocol import transcript as host
from sipp_tpu_torch.protocol import transcript_device as td

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: convert.from_reference(g[k], device="cpu") for k in g.files
                if k.startswith(("perm_", "td_"))}


def test_permute_matches_reference(golden):
    out = poseidon.permute_device(golden["perm_in"])
    assert torch.equal(out, golden["perm_out"])
    assert FGL.decode(out) == poseidon.permute(FGL.decode(golden["perm_in"]))


def test_append_fq12_matches_reference(golden):
    assert torch.equal(td.append_fq12(golden["td_state"], golden["td_f1"]), golden["td_append"])


def test_round_tail_plain_matches_reference(golden):
    """K4's plain version == the JAX twins of transcript_round_tail; K5's ==
    append_fq12."""
    st, x, xinv = transcript.transcript_round_tail(golden["td_state"], golden["td_f1"],
                                                   golden["td_f2"])
    assert torch.equal(st, golden["td_tail_state"])
    assert torch.equal(x, golden["td_tail_x"])
    assert torch.equal(xinv, golden["td_tail_xinv"])
    assert torch.equal(td.get_challenge(st)[0], golden["td_tail_bits"])
    assert torch.equal(transcript.transcript_append_fq12(golden["td_state"], golden["td_f1"]),
                       golden["td_append"])
    xv, xiv = (sum(int(v) << (16 * i) for i, v in enumerate(t)) for t in (x, xinv))
    assert xv * xiv % params.R == 1


# digests that hit the quirk's rare cases: a zero high word, a zero element
QUIRK_DIGESTS = [
    [1, 2, 3, 4],
    [0x1234_5678_9ABC_DEF0, 0xFFFF_FFFF_FFFF_FFFF - 2**32, 1, 2**63],
    [0x0000_0000_DEAD_BEEF, 5, 0, 0xFFFF_FFFF],
    [0, 0, 0, 0],
    [0, 0x1_0000_0000, 0x7FFF_FFFF, 0],
    [2**32, 0, 0, 7],
]


@pytest.mark.parametrize("digest", QUIRK_DIGESTS)
def test_digest_quirk_matches_host(digest):
    canon = torch.tensor([[(d >> (16 * t)) & 0xFFFF for t in range(4)] + [0] for d in digest])
    limbs = td._digest_to_challenge_limbs(canon)
    digits = [d for e in digest for d in host.u32_digits_var(e)]
    want = sum(d << (32 * i) for i, d in enumerate(digits))
    assert sum(int(v) << (16 * i) for i, v in enumerate(limbs)) == want
    assert want % params.R == host.challenge_from_digest(digest)
    assert torch.equal(transcript.digest_to_challenge_limbs(canon[None])[0], limbs)


def test_fr_inverse_limbs_on_cpu_is_fermat():
    """The test entry of K4's inverse on CPU tensors: the plain Fermat
    chain, 0 -> 0; other shapes are refused."""
    xs = [0, 1, 2, params.R - 1, 0x1234_5678_9ABC_DEF0 << 100]
    limbs = torch.tensor([[(x >> (16 * i)) & 0xFFFF for i in range(16)] for x in xs])
    got = transcript.fr_inverse_limbs(limbs)
    assert [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in got] == \
        [pow(x, params.R - 2, params.R) for x in xs]
    with pytest.raises(ValueError):
        transcript.fr_inverse_limbs(limbs[0])


def test_device_chain_matches_native():
    """append_g1 / append_g2 / append_fq12 and get_challenge on the device
    == the repo's C++ chain on the host."""
    A, B = (curves.g1_encode([params.G1_GEN]), curves.g2_encode([params.G2_GEN]))
    rng = np.random.default_rng(11)
    vals = [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(12)]
    f_host = tuple(tuple((vals[6 * i + 2 * j], vals[6 * i + 2 * j + 1]) for j in range(3))
                   for i in range(2))
    st = td.new_state()
    st = td.append_g1(st, A[0])
    st = td.append_g2(st, B[0])
    st = td.append_fq12(st, tower.fq12_encode(f_host))
    (gx, gy), ((x0, x1), (y0, y1)) = params.G1_GEN, params.G2_GEN
    msgs = [host.fq_to_elements(gx) + host.fq_to_elements(gy),
            sum((host.fq_to_elements(v) for v in (x0, x1, y0, y1)), []),
            host.fq12_to_elements(f_host)]
    want = native.transcript_absorb([0, 0, 0, 0], msgs)
    assert FGL.decode(st) == want
    bits, x = td.get_challenge(st)
    x_host = host.challenge_from_digest(native.hash_no_pad(want))
    assert sum(int(v) << (16 * i) for i, v in enumerate(x)) == x_host
    assert int("".join(str(int(b)) for b in bits), 2) == x_host
    assert FR.decode(td.fr_inverse(x), mont=False) == pow(x_host, -1, params.R)


def test_kernel_constants_come_from_the_tables():
    """The transcript kernels' generated header holds the module's Poseidon
    tables and correct Goldilocks / Fr constants."""
    text = _build.transcript_header()
    rc = [c for row in poseidon.ROUND_CONSTANTS for c in row]
    assert ", ".join(f"0x{c:016x}ull" for c in rc) in text
    g = params.GOLDILOCKS_P
    rinv = int(text.split("#define GL_RINV ")[1].split("ull")[0], 16)
    assert rinv * 2**80 % g == 1
    n0 = int(text.split("#define FR_N0 ")[1].split("u")[0], 16)
    assert n0 * params.R % 2**32 == 2**32 - 1


def test_wrappers_on_cpu_launch_nothing(golden):
    wrappers = (transcript.transcript_append_fq12, transcript.transcript_round_tail)
    before = [w.launches for w in wrappers]
    transcript.transcript_append_fq12(golden["td_state"], golden["td_f1"])
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError):
        transcript.transcript_append_fq12(golden["td_state"][:3], golden["td_f1"])


def test_rc_file_hook_reaches_device_tables(tmp_path):
    """SIPP_POSEIDON_RC_FILE swaps the device Poseidon's tables and the
    kernels' generated header (whose hash names the library)."""
    alt = [(0x9E3779B97F4A7C15 * (i + 3)) % 2**64 for i in range(360)]
    rc = tmp_path / "rc.txt"
    rc.write_text(" ".join(hex(v) for v in alt))
    child = (
        "import torch\n"
        "from sipp_tpu_torch.fields import FGL, poseidon\n"
        "from sipp_tpu_torch.ops import _build\n"
        f"alt = [v % poseidon.P for v in {alt!r}]\n"
        "rc, _ = poseidon._tables(torch.device('cpu'))\n"
        "assert FGL.decode(rc.reshape(-1, 5)) == alt\n"
        "s = list(range(12))\n"
        "assert FGL.decode(poseidon.permute_device(FGL.encode(s))) == poseidon.permute(s)\n"
        "assert f'0x{alt[0]:016x}ull' in _build.transcript_header()\n"
        "print('ok')\n")
    env = dict(os.environ, SIPP_POSEIDON_RC_FILE=str(rc))
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    out = subprocess.run([sys.executable, "-c", child], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

