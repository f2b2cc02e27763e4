"""The check against what it must catch, on the CPU at small sizes.

The control (ecbench/control.py: the reference over another field, in the
program's place) must come out not correct on every seed, while the program
comes out correct.  Faults planted in the program's seam underneath a
whole run must each make ``correct`` false: an answer altered where it is
produced, a step that returns its state unchanged, half of the batch left
out.  (A cell on one chip has no exchange between chips to leave out.)"""

import numpy as np
import pytest

from ecbench import control, harness
from ecbench.tests.helpers import CELLS, run_small

SEEDS = [2**31 + 3, 2**32 + 17, 977]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    sound = run_small(cell, seed=seed)
    assert sound["correct"]
    assert sound["checks"]["bad_bytes"]["value"] == 0
    r = run_small(cell, seed=seed, make_codec=control.make_control)
    assert r["correct"] is False
    assert r["checks"]["bad_bytes"]["value"] > r["checks"]["bad_bytes"]["limit"]


def _altered(out):
    out = np.array(out)
    out.flat[out.size // 3] ^= 0x40
    return out


def _unchanged(out):
    return np.zeros_like(out)


def _half_left_out(out):
    out = np.array(out)
    out[..., out.shape[-1] // 2:] = 0
    return out


FAULTS = {"answer altered": _altered, "state unchanged": _unchanged,
          "half the batch left out": _half_left_out}


def _faulty(fault):
    """A make_codec that builds the program's codec with `fault` applied to
    what its compute seams return."""
    from ceph_tpu_torch.ec.registry import registry

    def make(config, device):
        codec = registry.factory(config["plugin"], "", config["profile"],
                                 device=device)
        for name in ("_apply", "_apply_rows"):
            inner = getattr(codec, name, None)
            if inner is not None:
                setattr(codec, name, lambda *a, _i=inner, **k: fault(
                    _i(*a, **k)))
        return codec

    return make


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault):
    r = run_small(cell, make_codec=_faulty(FAULTS[fault]))
    assert r["correct"] is False
    assert r["checks"]["bad_bytes"]["value"] > 0


def test_a_failed_op_is_not_correct():
    def make(config, device):
        codec = _faulty(lambda out: out)(config, device)
        calls = {"n": 0}
        real = codec.encode

        def encode(want, data):
            calls["n"] += 1
            # set-up makes one warm op and WARM_OPS more: the window's
            # first op raises
            if calls["n"] == harness.WARM_OPS + 2:
                raise RuntimeError("injected")
            return real(want, data)

        codec.encode = encode
        return codec

    r = run_small(next(c for c in CELLS if c.endswith(".encode")),
                  make_codec=make)
    assert r["correct"] is False and r["failed"] == 1
    assert r["checks"]["failed_ops"] == {"value": 1, "limit": 0}
