"""Carry-across between the JAX package and the port, the port's instance
generator, and the rule that the port never loads JAX."""

import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sipp_tpu.utils.testing import random_instance as jax_instance
from sipp_tpu_torch import convert
from sipp_tpu_torch.utils.testing import random_instance


def test_round_trip():
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 1 << 16, size=(3, 2, 3, 2, 16)).astype(np.uint32)
    t = convert.from_reference(arr, device="cpu")
    assert t.dtype == torch.int64 and tuple(t.shape) == arr.shape
    back = convert.to_reference(t)
    assert back.dtype == np.uint32 and np.array_equal(back, arr)


@pytest.mark.parametrize("shape", [(2, 3, 2, 16, 5), (3, 2, 16, 5), (2, 16, 1)])
def test_transposed_round_trip(shape):
    """The JAX kernels' lanes-last layout (the step kernel's f, T, P) to the
    port's lanes-first (B, ...) tensors and back."""
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 1 << 16, size=shape).astype(np.uint32)
    t = convert.from_transposed(arr, device="cpu")
    assert t.dtype == torch.int64 and tuple(t.shape) == (shape[-1],) + shape[:-1]
    assert np.array_equal(t[-1].numpy(), arr[..., -1])
    back = convert.to_transposed(t)
    assert back.dtype == np.uint32 and np.array_equal(back, arr)


def test_rejects_non_limbs():
    with pytest.raises(ValueError):
        convert.from_reference(np.full((2, 16), 1 << 16, np.uint32), device="cpu")
    with pytest.raises(ValueError):
        convert.from_reference(np.zeros((2, 16), np.int64), device="cpu")
    with pytest.raises(ValueError):
        convert.to_reference(torch.full((16,), -1, dtype=torch.int64))


@pytest.mark.parametrize("n,seed", [(2, 5), (4, 7)])
def test_random_instance_matches_reference(n, seed):
    a, b = random_instance(n, seed, device="cpu")
    ja, jb = jax_instance(n, seed)
    assert np.array_equal(convert.to_reference(a), np.asarray(ja))
    assert np.array_equal(convert.to_reference(b), np.asarray(jb))


def test_entry_points_default_to_the_card(monkeypatch):
    """random_instance and from_reference run on the card unless the caller
    names another device, and raise where there is none: never a silent
    fallback to the CPU."""
    for fn in (random_instance, convert.from_reference):
        assert inspect.signature(fn).parameters["device"].default == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_instance(2, seed=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_reference(np.zeros((2, 16), np.uint32))


def test_port_does_not_load_jax():
    """Importing every module of sipp_tpu_torch leaves jax and sipp_tpu out
    of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sipp_tpu_torch\n"
        "for m in pkgutil.walk_packages(sipp_tpu_torch.__path__, 'sipp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'sipp_tpu' or m.startswith('sipp_tpu.')]\n"
        "print(len(list(pkgutil.walk_packages(sipp_tpu_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
