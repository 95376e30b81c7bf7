"""Faults planted under the timed path, for the check that `correct` comes out
false (benchmark/control.py on the card, benchmark/tests on the CPU).

- state_unchanged: a step returns its state unchanged: K3 returns lo (the
  prove cell's folds), K2 returns its input (the aggregate cells' Z);
- half_batch: half of the batch left out: K1's Miller product over the
  first half of its lanes only (the rest's product stands for the whole);
- answer_altered: an answer altered where it is produced: K2's output with
  its lowest limb changed.

The exchange between chips has no fault here: every cell runs on one card.
"""

import contextlib
import functools


def _final_exp_altered(orig):
    @functools.wraps(orig)       # keeps its launch counter
    def final_exp(f):
        out = orig(f).clone()
        out[..., 0, 0, 0, 0] ^= 1
        return out
    return final_exp


def _miller_half(orig):
    @functools.wraps(orig)       # keeps its launch counter
    def miller_product(p, q, pair=False):
        if pair:
            return orig(p, q, pair=True)
        half = max(1, p.shape[0] // 2)
        return orig(p[:half], q[:half])
    return miller_product


def _fold_unchanged(orig):
    @functools.wraps(orig)       # keeps its launch counter
    def fold_g1(lo, hi, bits):
        return lo
    return fold_g1


def _final_exp_unchanged(orig):
    @functools.wraps(orig)       # keeps its launch counter
    def final_exp(f):
        return f
    return final_exp


# fault -> entry -> (module, function, its replacement)
FAULTS = {
    "state_unchanged": {"prove": ("sipp_tpu_torch.ops.fold", "fold_g1", _fold_unchanged),
                        "aggregate": ("sipp_tpu_torch.ops.fexp", "final_exp",
                                      _final_exp_unchanged)},
    "half_batch": {"prove": ("sipp_tpu_torch.ops.miller", "miller_product", _miller_half),
                   "aggregate": ("sipp_tpu_torch.ops.miller", "miller_product", _miller_half)},
    "answer_altered": {"prove": ("sipp_tpu_torch.ops.fexp", "final_exp", _final_exp_altered),
                       "aggregate": ("sipp_tpu_torch.ops.fexp", "final_exp",
                                     _final_exp_altered)},
}


@contextlib.contextmanager
def planted(fault, entry):
    """The program with `fault` planted for traffic entry `entry`."""
    import importlib

    module, name, make = FAULTS[fault][entry]
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)
