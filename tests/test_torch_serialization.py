"""hehub_tpu_torch.utils.serialization and utils.noise against hehub_tpu's
twins at n = 256: for every covered type (RnsPoly, CkksCt, CkksPt, BgvCt,
RgswCt at alpha 1 and 2, RlweSk, TfheKeys, LweCt) a file that hehub_tpu
writes loads in the port bitwise, and the file the port writes of it loads
in hehub_tpu bitwise, the same arrays under the same names and dtypes;
parameters' JSON both ways; and the three noise probes equal hehub_tpu's
on the same ciphertexts (the port's own, handed over as numpy) and secret
key. On the card, a ciphertext and an alpha=2 key saved and loaded back
onto it bitwise, and the noise probes of card ciphertexts equal to those of
their CPU copies (the error probe, which decodes, within the two codecs'
agreement).

hehub_tpu runs its NTTs jitted (torch_support.jit_reference_ops)."""

import dataclasses
import io
import math

import numpy as np
import pytest
import torch

from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.models import bgv as tbgv
from hehub_tpu_torch.models import ckks as tckks
from hehub_tpu_torch.models import tfhe as ttfhe
from hehub_tpu_torch.rlwe import keys as tkeys
from hehub_tpu_torch.rlwe import rlwe as trlwe
from hehub_tpu_torch.utils import noise as tnoise
from hehub_tpu_torch.utils import serialization as tser
from tests.test_torch_bgv import _setup as bgv_setup
from tests.torch_support import (as_numpy, cuda_device, jit_reference_ops,  # noqa: F401
                                 to_device)

N = 256
LEVELS = 3
CPU = "cpu"
TFHE = ttfhe.TfheParams(rlwe_dimension=N, lwe_dimension=16, decomp_levels=2, ks_levels=2)
KINDS = ("RnsPoly", "CkksCt", "CkksPt", "BgvCt", "RgswCt-alpha1", "RgswCt-alpha2", "RlweSk",
         "TfheKeys", "LweCt")


@pytest.fixture(scope="module")
def jit_ref():
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_ops(mp)
        yield


def _params(kind):
    """(the port's params, hehub_tpu's) for an object of `kind`."""
    from hehub_tpu.core import context as jctx

    if kind in ("TfheKeys", "LweCt"):
        p = TFHE.rlwe_params
        return p, jctx.RlweParams(p.dimension, p.moduli)
    if kind == "BgvCt":
        kw = dict(num_levels=LEVELS, use_security_budget=False)
        return tctx.create_bgv_params(N, **kw), jctx.create_bgv_params(N, **kw)
    kw = dict(num_levels=LEVELS, use_security_budget=False, num_special=2)
    return tctx.create_ckks_params(N, 28, **kw), jctx.create_ckks_params(N, 28, **kw)


def _jax_object(kind, params, rng):
    """A hehub_tpu object of `kind` over random residues of `params`."""
    from hehub_tpu.core import rns as jrns
    from hehub_tpu.models import bgv as jbgv
    from hehub_tpu.models import ckks as jckks
    from hehub_tpu.models import tfhe as jtfhe
    from hehub_tpu.rlwe import rgsw as jrgsw
    from hehub_tpu.rlwe import rlwe as jrlwe

    mods = np.asarray(params.moduli + params.special_mods, np.int64)

    def res(shape, ids):  # lazy residues [*shape, len(ids), N]
        two_q = 2 * mods[list(ids), None]
        return (rng.integers(0, 1 << 62, (*shape, len(ids), N)) % two_q).astype(np.uint32)

    def u32(shape, q):
        return rng.integers(0, q, shape).astype(np.uint32)

    ids = tuple(range(LEVELS))
    ids_ext = tuple(range(len(mods)))
    poly = lambda form: jrns.RnsPoly(res((2,), ids), form, ids)  # noqa: E731

    def sk():
        coeffs = rng.integers(-1, 2, N).astype(np.int8)
        return jrlwe.RlweSk(coeffs, res((), ids_ext), res((), ids_ext))

    if kind == "RnsPoly":
        return poly(jrns.COEFF)
    if kind == "CkksCt":
        return jckks.CkksCt(poly(jrns.NTT), poly(jrns.NTT), 2.0**28 + 0.5)
    if kind == "CkksPt":
        return jckks.CkksPt(poly(jrns.COEFF), 2.0**27)
    if kind == "BgvCt":
        return jbgv.BgvCt(poly(jrns.NTT), poly(jrns.NTT), params.plain_modulus)
    if kind.startswith("RgswCt"):
        alpha = int(kind[-1])
        return jrgsw.RgswCt(res((-(-LEVELS // alpha), 2), ids_ext), ids_ext, alpha)
    if kind == "RlweSk":
        return sk()
    q = TFHE.q
    m, ell, kl = TFHE.lwe_dimension, TFHE.decomp_levels, TFHE.ks_levels
    if kind == "LweCt":
        return jtfhe.LweCt(u32((4, m), q), u32((4,), q))
    ksk_a, ksk_b = u32((N, kl, m), q), u32((N, kl), q)

    def sh(w):  # the reference keygen's Shoup companions
        return ((w.astype(np.uint64) << np.uint64(32)) // np.uint64(q)).astype(np.uint32)

    return jtfhe.TfheKeys(u32((m,), 2), sk(), u32((m, 2, ell, 2, N), 2 * q), ksk_a, sh(ksk_a),
                          ksk_b, sh(ksk_b))


def _saved(save, obj, params):
    buf = io.BytesIO()
    save(buf, obj, params)
    buf.seek(0)
    return buf


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = np.asarray(got[name])
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_files_cross_both_ways_bitwise(kind):
    """hehub_tpu's file -> the port (on the CPU) -> the port's file ->
    hehub_tpu: the same arrays, dtypes, metadata and parameters at every
    step."""
    from hehub_tpu.utils import serialization as jser

    params, jparams = _params(kind)
    jobj = _jax_object(kind, jparams, np.random.default_rng(KINDS.index(kind)))
    obj, got_params = tser.load(_saved(jser.save, jobj, jparams), device=CPU)
    assert got_params == params
    _assert_same_arrays(tser._arrays(obj, params), jser._arrays(jobj))
    assert tser._meta(obj) == jser._meta(jobj)
    if isinstance(obj, trlwe.RlweSk):
        assert obj.coeffs.dtype == torch.int8
    back, back_params = jser.load(_saved(tser.save, obj, params))
    assert back_params == jparams
    _assert_same_arrays(jser._arrays(back), jser._arrays(jobj))
    assert jser._meta(back) == jser._meta(jobj)


@pytest.mark.parametrize("kind", ["CkksCt", "BgvCt", "TfheKeys"])
def test_params_json_both_ways(kind):
    from hehub_tpu.utils import serialization as jser

    params, jparams = _params(kind)
    assert jser.params_from_json(tser.params_to_json(params)) == jparams
    assert tser.params_from_json(jser.params_to_json(jparams)) == params
    assert dataclasses.asdict(tser.params_from_json(tser.params_to_json(params))) == \
        dataclasses.asdict(params)


def _jax_sk(sk):
    from hehub_tpu.rlwe import rlwe as jrlwe

    return jrlwe.RlweSk(sk.coeffs.numpy(), as_numpy(sk.ntt), as_numpy(sk.ntt_sh))


def _jax_poly(p):
    from hehub_tpu.core import rns as jrns

    return jrns.RnsPoly(as_numpy(p.data), p.form, p.limb_ids)


def test_ckks_noise_matches_reference(jit_ref):
    """modulus_headroom_bits of a fresh ciphertext and of its square after
    mult + relin + rescale, equal to hehub_tpu's on the same ciphertexts;
    ckks_error_bits of the square, whose error equals hehub_tpu's within
    the decodes' own agreement."""
    from hehub_tpu.core.context import make_context
    from hehub_tpu.models import ckks as jckks
    from hehub_tpu.utils import noise as jnoise

    params, jparams = _params("CkksCt")
    ctx, jctx = tctx.make_context(params), make_context(jparams)
    gen = torch.Generator().manual_seed(8)
    sk = trlwe.keygen(ctx, gen)
    rlk = tkeys.relin_key(ctx, sk, gen)
    v = np.random.default_rng(9).uniform(-1, 1, N // 2)
    ct = tckks.encrypt(ctx, tckks.encode(v, params, device=CPU), sk, gen)
    sq = tckks.rescale(ctx, tckks.mult(ctx, ct, ct, rlk))
    jsk = _jax_sk(sk)
    heads = []
    for c in (ct, sq):
        got = tnoise.modulus_headroom_bits(ctx, (c.c0, c.c1), sk)
        assert got == jnoise.modulus_headroom_bits(jctx, (_jax_poly(c.c0), _jax_poly(c.c1)), jsk)
        heads.append(got)
    assert heads[0] > heads[1] > 0
    jsq = jckks.CkksCt(_jax_poly(sq.c0), _jax_poly(sq.c1), sq.scaling_factor)
    got = tnoise.ckks_error_bits(ctx, sq, sk, v * v, params)
    want = jnoise.ckks_error_bits(jctx, jsq, jsk, v * v, jparams)
    # the two host codecs' decodes agree to 1e-9 (tests/test_torch_ckks.py),
    # so the errors they measure do too
    np.testing.assert_allclose(2.0**got, 2.0**want, rtol=0, atol=1e-9)
    assert got < -8


def test_bgv_noise_matches_reference(jit_ref):
    """bgv_invariant_noise_bits of a fresh ciphertext and of its double:
    the port's values equal hehub_tpu's (tests/test_torch_bgv.py's 17-bit
    setup, n = 256, 3 + 1 limbs)."""
    from hehub_tpu.models import bgv as jbgv
    from hehub_tpu.utils import noise as jnoise

    params, ctx, sk, jctx, jsk = bgv_setup("17-bit")
    t = params.plain_modulus
    a = np.random.default_rng(10).integers(0, t, N, dtype=np.uint64)
    ct = tbgv.encrypt(ctx, tbgv.simd_encode(ctx, a, device=CPU), sk,
                      torch.Generator().manual_seed(11))
    bits = []
    for c in (ct, tbgv.add(ctx, ct, ct)):
        got = tnoise.bgv_invariant_noise_bits(ctx, c, sk)
        jc = jbgv.BgvCt(_jax_poly(c.c0), _jax_poly(c.c1), c.plain_modulus)
        assert got == jnoise.bgv_invariant_noise_bits(jctx, jc, jsk)
        bits.append(got)
    assert bits[1] >= bits[0]


def test_headroom_above_float_range(monkeypatch):
    """Above 2^1024 (here 36 limbs of 30 bits) hehub_tpu's modulus_headroom_bits
    raises OverflowError (log2 of Q / 2 as a float) on the same decrypted
    values; the port's gives log2(Q) - 1 - log2(peak), the value of the
    reference's formula below that range."""
    from hehub_tpu.utils import noise as jnoise

    params = tctx.create_ckks_params(N, 28, num_levels=36, use_security_budget=False)
    ctx = tctx.make_context(params)
    gen = torch.Generator().manual_seed(12)
    sk = trlwe.keygen(ctx, gen)
    ct = tckks.encrypt(ctx, tckks.encode(np.linspace(-1, 1, N // 2), params, device=CPU), sk, gen)
    Q = math.prod(params.moduli)
    assert Q.bit_length() > 1025
    vals, _ = tnoise._decrypt_centered(ctx, (ct.c0, ct.c1), sk)
    got = tnoise.modulus_headroom_bits(ctx, (ct.c0, ct.c1), sk)
    assert got == math.log2(Q) - 1 - math.log2(max(abs(v) for v in vals))
    assert 1000 < got < Q.bit_length()
    monkeypatch.setattr(jnoise, "_decrypt_centered", lambda *a: (vals, Q))
    with pytest.raises(OverflowError):
        jnoise.modulus_headroom_bits(None, None, None)


@pytest.mark.cuda
def test_card_objects_load_back_onto_the_card(cuda_device, tmp_path):  # noqa: F811
    """A ciphertext made on the card (mult + relinearize + rescale at
    alpha=2) and the alpha=2 relinearization key, saved and loaded onto the
    card: bitwise the saved ones there, the ciphertext decoding to the same
    slots; and the noise probes of the card's ciphertexts equal to those of
    their copies on the CPU, the headroom shrinking with the mult and the
    product's error under 2^-8."""
    params = tctx.create_ckks_params(N, 28, LEVELS, use_security_budget=False, num_special=2)
    ctx = tctx.make_context(params)
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    sk = trlwe.keygen(ctx, gen)
    rlk = tkeys.relin_key(ctx, sk, gen, alpha=2)
    v = np.random.default_rng(13).uniform(-1, 1, N // 2)
    ct = tckks.encrypt(ctx, tckks.encode(v, params, device=cuda_device), sk, gen)
    sq = tckks.rescale(ctx, tckks.mult(ctx, ct, ct, rlk))
    dec = lambda c: tckks.decode(tckks.decrypt(ctx, c, sk), params)  # noqa: E731
    for name, obj in (("ciphertext", sq), ("relin_key", rlk)):
        path = tmp_path / f"{name}.npz"
        tser.save(str(path), obj, params)
        back, back_params = tser.load(str(path), device=cuda_device)
        assert back_params == params
        if name == "ciphertext":
            assert back.c0.limb_ids == sq.c0.limb_ids and back.scaling_factor == sq.scaling_factor
            assert back.c0.data.device == sq.c0.data.device
            assert torch.equal(back.c0.data, sq.c0.data) and torch.equal(back.c1.data, sq.c1.data)
            np.testing.assert_array_equal(dec(back), dec(sq))
        else:
            assert back.limb_ids == rlk.limb_ids and back.alpha == rlk.alpha == 2
            assert back.data.device == rlk.data.device and torch.equal(back.data, rlk.data)

    sk_c = to_device(sk, "cpu")
    heads = []
    for c in (ct, sq):
        got = tnoise.modulus_headroom_bits(ctx, (c.c0, c.c1), sk)
        c_c = to_device(c, "cpu")
        assert got == tnoise.modulus_headroom_bits(ctx, (c_c.c0, c_c.c1), sk_c)
        heads.append(got)
    assert heads[0] > heads[1] > 0
    err = tnoise.ckks_error_bits(ctx, sq, sk, v * v, params)
    # the device codec's decode and the host codec's agree to 1e-9
    # (tests/test_torch_codec.py), so the errors they measure do too
    np.testing.assert_allclose(
        2.0**err, 2.0**tnoise.ckks_error_bits(ctx, to_device(sq, "cpu"), sk_c, v * v, params),
        rtol=0, atol=1e-9)
    assert err <= -8
