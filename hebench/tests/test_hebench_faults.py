"""A run whose timed path is broken underneath comes out not correct, for
each fault a cell can have: a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced, and limbs
after the first two left wrong. (The cells run on one chip: there is no
exchange between chips to leave out.)"""

import time

import numpy as np
import pytest
import torch

from hebench import harness
from hebench.tests import tiny
from hehub_tpu_torch.models import ckks

SEED = 2**31 + 41


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _with(ct, fn):
    return ckks.CkksCt(ct.c0.with_data(fn(ct.c0.data)), ct.c1.with_data(fn(ct.c1.data)),
                       ct.scaling_factor)


def _upper(x):
    """Limbs 2 .. l-1 off by one; limbs 0 and 1 (which decode) intact."""
    y = x.clone()
    y[..., 2:, :] += 1
    return y


def _ks_faults(mult, rotate):
    half = lambda ct: _with(ct, lambda x: x[: x.shape[0] // 2])  # noqa: E731
    rolled = lambda ct: _with(ct, lambda x: torch.roll(x, 1, 0))  # noqa: E731
    upper = lambda ct: _with(ct, _upper)  # noqa: E731
    return {
        "unchanged": dict(mult=lambda ctx, a, b, rlk: a, rotate=lambda ctx, ct, rk, s: ct),
        "half_batch": dict(mult=lambda *a: half(mult(*a)), rotate=lambda *a: half(rotate(*a))),
        "altered": dict(mult=lambda *a: rolled(mult(*a)), rotate=lambda *a: rolled(rotate(*a))),
        "upper_limbs": dict(rotate=lambda *a: upper(rotate(*a))),
    }


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "upper_limbs"])
def test_ks_cell(root, monkeypatch, fault):
    for name, fn in _ks_faults(ckks.mult, ckks.rotate)[fault].items():
        monkeypatch.setattr(ckks, name, fn)
    res = harness.run("std128.ks_b64", SEED, 0.5, False, time.perf_counter(), root=root,
                      device="cpu")
    assert not res["correct"]
    if fault == "upper_limbs":  # only the limb-by-limb check can see it
        checks = res["checks"]
        assert checks["residue_mismatch"]["value"] > 0
        assert checks["rotate_err"]["value"] <= checks["rotate_err"]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "upper_limbs"])
def test_codec_cell(root, monkeypatch, fault):
    enc, dec = ckks.encrypt, ckks.decode
    if fault == "unchanged":
        first = {}
        monkeypatch.setattr(ckks, "encrypt",
                            lambda *a, **k: first.setdefault("ct", enc(*a, **k)))
    elif fault == "half_batch":
        monkeypatch.setattr(ckks, "decode", lambda *a, **k: dec(*a, **k)[: 2])
    elif fault == "altered":
        monkeypatch.setattr(ckks, "decode", lambda *a, **k: np.conjugate(dec(*a, **k)) + 1e-3)
    else:
        monkeypatch.setattr(ckks, "encrypt", lambda *a, **k: _with(enc(*a, **k), _upper))
    res = harness.run("deep65536.codec_b8", SEED, 0.5, False, time.perf_counter(), root=root,
                      device="cpu")
    assert not res["correct"]
