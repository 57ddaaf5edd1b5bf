"""hehub_tpu_torch.ops.modarith against hehub_tpu.ops.modarith: every
operation bitwise on random lazy residues and on the edge values 0, q-1,
2q-1 (and 2^32-1 for Shoup's any-uint32 domain); mul_hi against Python
ints; the tensor product and CKKS's and BGV's mult_low_level against
hehub_tpu's chain; every csrc kernel inside an anonymous namespace; on the
card, the tensor product's kernel bitwise its plain version."""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.ops import modarith as tma
from tests.torch_support import Reference, cuda_device  # noqa: F401

jnp = Reference("jax.numpy")
jcx = Reference("hehub_tpu.core.context")
jma = Reference("hehub_tpu.ops.modarith")

RNG = np.random.default_rng(7)
# the port's tables, bitwise the reference's (tests/test_torch_context.py)
CTX = tctx.make_context(tctx.create_ckks_params(1024, 28, 2, use_security_budget=False))
LIMB = 0
Q = int(CTX.q[LIMB, 0])
CONST = {nm: int(getattr(CTX, nm)[LIMB, 0])
         for nm in ("q", "two_q", "neg_qinv", "r_mod_q", "r_shoup", "r2_mod_q")}


def _lazy(size):
    """Lazy residues in [0, 2q) with the edge values up front."""
    edge = np.asarray([0, 1, Q - 1, Q, 2 * Q - 1], np.uint32)
    return np.concatenate([edge, RNG.integers(0, 2 * Q, size).astype(np.uint32)])


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy().astype(np.uint32))


def test_mul_hi_and_wide_against_python_ints():
    a = np.concatenate([[0, 1, 0xFFFFFFFF, 0xFFFFFFFF, 1 << 31],
                        RNG.integers(0, 1 << 32, 4000)]).astype(np.uint64)
    b = np.concatenate([[0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 1, 1 << 31],
                        RNG.integers(0, 1 << 32, 4000)]).astype(np.uint64)
    hi, lo = tma.mul_wide(_t(a), _t(b))
    exact = [int(x) * int(y) for x, y in zip(a, b)]
    assert hi.tolist() == [p >> 32 for p in exact]
    assert lo.tolist() == [p & 0xFFFFFFFF for p in exact]
    _same(jma.mul_hi(a.astype(np.uint32), b.astype(np.uint32)), hi)


@pytest.mark.parametrize("op", ["add_lazy", "sub_lazy", "mont_mul_lazy", "mul_mod_lazy"])
def test_binary_ops_bitwise(op):
    a, b = _lazy(4000), _lazy(4000)[::-1].copy()
    args = {
        "add_lazy": (CONST["two_q"],),
        "sub_lazy": (CONST["two_q"],),
        "mont_mul_lazy": (CONST["q"], CONST["neg_qinv"]),
        "mul_mod_lazy": (CONST["q"], CONST["neg_qinv"], CONST["r_mod_q"], CONST["r_shoup"]),
    }[op]
    want = getattr(jma, op)(jnp.asarray(a), jnp.asarray(b), *(np.uint32(c) for c in args))
    _same(want, getattr(tma, op)(_t(a), _t(b), *args))


@pytest.mark.parametrize("op", ["neg_lazy", "reduce_strict", "to_mont", "from_mont"])
def test_unary_ops_bitwise(op):
    a = _lazy(4000)
    args = {
        "neg_lazy": (CONST["two_q"],),
        "reduce_strict": (CONST["q"],),
        "to_mont": (CONST["q"], CONST["neg_qinv"], CONST["r2_mod_q"]),
        "from_mont": (CONST["q"], CONST["neg_qinv"]),
    }[op]
    want = getattr(jma, op)(jnp.asarray(a), *(np.uint32(c) for c in args))
    _same(want, getattr(tma, op)(_t(a), *args))


def test_shoup_mul_any_uint32():
    x = np.concatenate([[0, Q - 1, 2 * Q - 1, 4 * Q - 1, 0xFFFFFFFF, 1 << 31],
                        RNG.integers(0, 1 << 32, 4000)]).astype(np.uint32)
    w = int(RNG.integers(0, Q))
    w_sh = (w << 32) // Q
    got = tma.shoup_mul_lazy(_t(x), w, w_sh, Q)
    _same(jma.shoup_mul_lazy(jnp.asarray(x), np.uint32(w), np.uint32(w_sh), np.uint32(Q)), got)
    assert bool((got < 2 * Q).all())
    np.testing.assert_array_equal(got.numpy() % Q, x.astype(np.int64) * w % Q)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_reduce_add_lazy_bitwise(k):
    x = np.stack([_lazy(500) for _ in range(k)], axis=1)  # [505, k]
    want = jma.reduce_add_lazy(jnp.asarray(x), 1, np.uint32(CONST["two_q"]))
    _same(want, tma.reduce_add_lazy(_t(x), 1, CONST["two_q"]))


@pytest.mark.parametrize(
    "op", ["add", "sub", "neg", "mul", "mul_scalar", "reduce_strict", "take_limbs", "drop_last_limb"]
)
def test_rns_ops_bitwise(op):
    """hehub_tpu_torch.core.rns against hehub_tpu.core.rns, over limbs (2, 0, 1)."""
    from hehub_tpu.core import rns as jrns
    from hehub_tpu_torch.core import rns as trns

    ids = (2, 0, 1)
    tc = CTX
    jc = jcx.make_context(jcx.create_ckks_params(1024, 28, 2, use_security_budget=False))
    two_q = 2 * CTX.q[list(ids)].astype(np.int64)
    a = (RNG.integers(0, 1 << 62, (2, 3, 1024)) % two_q).astype(np.uint32)
    b = (RNG.integers(0, 1 << 62, (2, 3, 1024)) % two_q).astype(np.uint32)
    ja, jb = jrns.RnsPoly(jnp.asarray(a), jrns.NTT, ids), jrns.RnsPoly(jnp.asarray(b), jrns.NTT, ids)
    ta, tb = trns.RnsPoly(_t(a), trns.NTT, ids), trns.RnsPoly(_t(b), trns.NTT, ids)
    scalars = [5, 1 << 40, Q - 1]
    want, got = {
        "add": lambda: (jrns.add(jc, ja, jb), trns.add(tc, ta, tb)),
        "sub": lambda: (jrns.sub(jc, ja, jb), trns.sub(tc, ta, tb)),
        "neg": lambda: (jrns.neg(jc, ja), trns.neg(tc, ta)),
        "mul": lambda: (jrns.mul(jc, ja, jb), trns.mul(tc, ta, tb)),
        "mul_scalar": lambda: (jrns.mul_scalar(jc, ja, scalars), trns.mul_scalar(tc, ta, scalars)),
        "reduce_strict": lambda: (jrns.reduce_strict(jc, ja), trns.reduce_strict(tc, ta)),
        "take_limbs": lambda: (jrns.take_limbs(ja, (2, 0)), trns.take_limbs(ta, (2, 0))),
        "drop_last_limb": lambda: (jrns.drop_last_limb(ja), trns.drop_last_limb(ta)),
    }[op]()
    assert got.limb_ids == want.limb_ids and got.form == want.form
    _same(want.data, got.data)


# ---------------------------------------------------------------------------
# The tensor product (csrc/modarith.cu on the card)
# ---------------------------------------------------------------------------

CSRC = pathlib.Path(tctx.__file__).resolve().parents[1] / "csrc"
TENSOR_CONSTS = ("q", "two_q", "neg_qinv", "r_mod_q", "r_shoup")


@functools.lru_cache(maxsize=None)
def _ckks_pair(n, levels):
    """The port's and hehub_tpu's contexts of one CKKS chain (one special limb)."""
    kw = dict(use_security_budget=False)
    return (tctx.make_context(tctx.create_ckks_params(n, 28, levels, **kw)),
            jcx.make_context(jcx.create_ckks_params(n, 28, levels, **kw)))


def _operands(ctx, batch, limbs, n, seed, device="cpu"):
    """Four lazy residue tensors [*batch, limbs, n] under the first limbs of ctx."""
    gen = torch.Generator(device=device).manual_seed(seed)
    two_q = ctx.device_rows("two_q", tuple(range(limbs)), device)
    return [torch.randint(0, 1 << 62, (*batch, limbs, n), generator=gen, device=device) % two_q
            for _ in range(4)]


# (n, chain levels, batch, limbs kept): the whole chain, or a level-aligned
# view of its first limbs (ckks.mod_drop), whose batch stride is the full
# chain's
TENSOR_CASES = [(256, 3, (), None), (256, 3, (2,), None), (1024, 2, (3,), None),
                (512, 4, (2, 3), None), (256, 4, (2,), 2)]


@pytest.mark.parametrize("n,levels,batch,keep", TENSOR_CASES)
def test_tensor_product_plain_matches_jax_chain(n, levels, batch, keep):
    """ops.modarith.tensor_product on CPU tensors bitwise hehub_tpu's
    mult_low_level chain on the same residues."""
    from hehub_tpu.core import rns as jrns
    from hehub_tpu.models import ckks as jckks

    ctx, jctx = _ckks_pair(n, levels)
    full = levels + 1
    ids = tuple(range(keep or full))
    x = [t[..., :len(ids), :] for t in _operands(ctx, batch, full, n, n + levels)]
    got = tma.tensor_product(*x, *(ctx.device_rows(nm, ids, "cpu") for nm in TENSOR_CONSTS))
    jct = [jckks.CkksCt(jrns.RnsPoly(jnp.asarray(x[i].numpy().astype(np.uint32)), jrns.NTT, ids),
                        jrns.RnsPoly(jnp.asarray(x[i + 1].numpy().astype(np.uint32)), jrns.NTT,
                                     ids), 1.0) for i in (0, 2)]
    want = jckks.mult_low_level(jctx, *jct)
    for g, w in zip(got, (want.c0, want.c1, want.c2)):
        assert g.shape == (*batch, len(ids), n)
        _same(w.data, g)


@pytest.mark.parametrize("scheme,n,levels,batch", [("ckks", 256, 3, (2,)), ("ckks", 512, 2, ()),
                                                   ("bgv", 256, 3, (2,)), ("bgv", 512, 2, ())])
def test_mult_low_level_matches_jax(scheme, n, levels, batch):
    """ckks / bgv.mult_low_level of the port (through tensor_product) bitwise
    hehub_tpu's on the same ciphertexts."""
    from hehub_tpu.core import rns as jrns

    if scheme == "ckks":
        from hehub_tpu.models import ckks as jmod
        from hehub_tpu_torch.models import ckks as tmod

        ctx, jctx = _ckks_pair(n, levels)
        wrap, jwrap = ((lambda c0, c1: mod.CkksCt(c0, c1, 2.0**28)) for mod in (tmod, jmod))
    else:
        from hehub_tpu.core.context import create_bgv_params
        from hehub_tpu.core.context import make_context as j_make_context
        from hehub_tpu.models import bgv as jmod
        from hehub_tpu_torch.models import bgv as tmod

        kw = dict(num_levels=levels, use_security_budget=False)
        params = tctx.create_bgv_params(n, **kw)
        ctx, jctx = tctx.make_context(params), j_make_context(create_bgv_params(n, **kw))
        t = params.plain_modulus
        wrap, jwrap = ((lambda c0, c1: mod.BgvCt(c0, c1, t)) for mod in (tmod, jmod))
    ids = tuple(range(levels))
    from hehub_tpu_torch.core import rns as trns

    x = _operands(ctx, batch, levels, n, 3 * n + levels)
    cts = [wrap(trns.RnsPoly(x[i], trns.NTT, ids), trns.RnsPoly(x[i + 1], trns.NTT, ids))
           for i in (0, 2)]
    jcts = [jwrap(*(jrns.RnsPoly(jnp.asarray(x[i + h].numpy().astype(np.uint32)), jrns.NTT, ids)
                    for h in (0, 1))) for i in (0, 2)]
    got, want = tmod.mult_low_level(ctx, *cts), jmod.mult_low_level(jctx, *jcts)
    for g, w in zip((got.c0, got.c1, got.c2), (want.c0, want.c1, want.c2)):
        assert g.limb_ids == w.limb_ids == ids
        _same(w.data, g.data)


def _kernel_name(text: str, at: int) -> str:
    """The name of the __global__ function whose declaration goes on at `at`
    (after `void` and any __launch_bounds__(...))."""
    at = re.compile(r"\s*void\s+").match(text, at).end()
    if text.startswith("__launch_bounds__", at):
        at, depth = text.index("(", at), 0
        while True:
            depth += {"(": 1, ")": -1}.get(text[at], 0)
            at += 1
            if not depth:
                break
    return re.compile(r"\s*([\w#]+)").match(text, at).group(1)


def _globals_outside_anonymous_namespace(source: str):
    """The names of the __global__ functions of a CUDA source that do not lie
    inside an anonymous namespace, and the names of all of them."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\])*\"", " ", source, flags=re.S)
    stack, outside, names = [], [], []
    for m in re.finditer(r"namespace\s*(\w*)\s*\{|\{|\}|__global__", text):
        tok = m.group(0)
        if tok.startswith("namespace"):
            stack.append("named" if m.group(1) else "anonymous")
        elif tok == "{":
            stack.append("other")
        elif tok == "}":
            stack.pop()
        else:
            names.append(_kernel_name(text, m.end()))
            if "anonymous" not in stack:
                outside.append(names[-1])
    assert not stack, "unbalanced braces"
    return outside, names


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_kernels_lie_in_anonymous_namespace(source):
    """Every __global__ function of a csrc source lies in an anonymous
    namespace, so that a trace names it `(anonymous namespace)::<name>` and
    the benchmark's trace classes it as the program's kernel, not PyTorch's."""
    from hebench import trace

    outside, names = _globals_outside_anonymous_namespace((CSRC / source).read_text())
    assert names and not outside, (source, outside)
    for name in names:
        traced = f"void {trace.OURS}{name}<4>(TensorArgs)"
        assert trace.activity_class(traced) != "pytorch kernels", name
    assert _globals_outside_anonymous_namespace(
        "namespace {\n__global__ void __launch_bounds__(f(1)) k() {}\n}\n"
        "namespace hh { __global__ void leak(int) {} }") == (["leak"], ["k", "leak"])


@pytest.mark.cuda
@pytest.mark.parametrize("n,levels,special,batch,keep", [
    (16384, 12, 2, (64,), None), (65536, 54, 4, (8,), None), (65536, 43, 4, (1,), 41),
    (256, 4, 2, (64,), None), (262144, 3, 2, (2,), None), (16384, 12, 2, (4, 16), 7)])
def test_tensor_product_kernel_matches_plain_on_card(cuda_device, n, levels, special,  # noqa: F811
                                                    batch, keep):
    """The kernel (one launch) bitwise tensor_product_plain on the same card
    tensors: std128's and deep65536's top levels, a batch-1 EvalMod level of
    the boot set, n=256, n=262144 and level-aligned views (the first limbs
    of a higher level, batch stride the full chain's, as mod_drop makes)."""
    from hehub_tpu_torch import kernels

    ctx = tctx.make_context(tctx.create_ckks_params(n, 28, levels, use_security_budget=False,
                                                    num_special=special))
    ids = tuple(range(keep or levels))
    x = [t[..., :len(ids), :] for t in _operands(ctx, batch, levels, n, n + levels, cuda_device)]
    consts = [ctx.device_rows(nm, ids, cuda_device) for nm in TENSOR_CONSTS]
    before = kernels.LAUNCHES["tensor_product"]
    got = tma.tensor_product(*x, *consts)
    assert kernels.LAUNCHES["tensor_product"] == before + 1
    want = tma.tensor_product_plain(*x, *consts)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape == (*batch, len(ids), n)
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_tensor_product_kernel_refuses_bad_inputs(cuda_device):  # noqa: F811
    """The wrapper refuses int32 operands, an operand on the CPU, operands of
    two shapes, constants of the wrong shape and a row that is not 16-byte
    aligned; a CPU a0 takes the plain version."""
    from hehub_tpu_torch import kernels

    ctx = tctx.make_context(tctx.create_ckks_params(256, 28, 3, use_security_budget=False))
    ids = (0, 1, 2)
    x = _operands(ctx, (2,), 3, 256, 5, cuda_device)
    consts = [ctx.device_rows(nm, ids, cuda_device) for nm in TENSOR_CONSTS]
    with pytest.raises(TypeError):
        kernels.tensor_product(x[0].to(torch.int32), *x[1:], *consts)
    with pytest.raises(ValueError):
        kernels.tensor_product(x[0], x[1].cpu(), *x[2:], *consts)
    with pytest.raises(ValueError):
        kernels.tensor_product(x[0], x[1][..., :2, :], *x[2:], *consts)
    with pytest.raises(ValueError):
        kernels.tensor_product(*x, *consts[:4], consts[4][:2])
    odd = torch.empty(2 * 3 * 256 + 1, dtype=torch.int64, device=cuda_device)[1:].view(2, 3, 256)
    odd.copy_(x[0])
    with pytest.raises(ValueError):
        kernels.tensor_product(odd, *x[1:], *consts)
    cpu = tma.tensor_product(*(t.cpu() for t in x), *(c.cpu() for c in consts))
    for g, w in zip(cpu, tma.tensor_product(*x, *consts)):
        assert torch.equal(g, w.cpu())
