"""Port parity: cruse_tpu_torch's train-mode TFCM block (``tfcm_block_train``
with its three-phase backward, ``tail_bwd`` and ``mid_bwd`` with their plain
versions) and train-mode ``BatchNormC`` against cruse_tpu, on the CPU.

The JAX Pallas kernels run in interpret mode, as tests/test_tfcm_train.py
runs them. Tolerances: elementwise outputs 1e-5 (block outputs) and 1e-4
(kernel outputs, the JAX tests' bound); per-channel sums relative 1e-3 of the
largest entry; block gradients by tests/test_tfcm_train.py's own rule
(relative 2e-3, or absolute 1e-3 of the largest gradient; a bias that feeds a
BatchNorm has a true gradient of zero and is bounded absolutely).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.models.mtfaa import BatchNormC as JaxBatchNormC
from cruse_tpu.models.mtfaa import TFCMBlock as JaxTFCMBlock
from cruse_tpu.ops.tfcm_bwd_kernels import mid_bwd as jax_mid_bwd
from cruse_tpu.ops.tfcm_bwd_kernels import tail_bwd as jax_tail_bwd

from cruse_tpu_torch.models.mtfaa import BatchNormC, TFCMBlock
from cruse_tpu_torch.ops.dw_kernel import dw_taps_reference
from cruse_tpu_torch.ops.tfcm_bwd_kernels import (
    BLOCK_RESERVED_SMEM, MIN_BLOCKS_PER_SM, SM_SMEM_BYTES, SMEM_BYTES, mid_bwd, mid_bwd_reference,
    mid_finish_reference, mid_partials_reference, mid_plan, mid_smem_bytes, tail_bwd, tail_bwd_reference)
from cruse_tpu_torch.ops.tfcm_train import PARAM_NAMES, tfcm_block_reference, tfcm_block_train
from cruse_tpu_torch.utils.weights import mtfaa_flax_from_named, mtfaa_state_dict_from_flax
from tests.test_torch_tfcm import perturbed

SHAPES = [((2, 8, 12, 50), 1), ((2, 6, 4, 40), 4), ((1, 4, 16, 131), 2)]  # tests/test_tfcm_train.py:96
EPS = 1e-5
# config 5b's TFCM stages at B=16 x 10 s, and the ragged shapes chip_smoke.py runs on the card
STAGES = [(16, 64, 24, 626), (16, 32, 32, 626), (16, 16, 48, 626), (16, 128, 4, 626)]
RAGGED = [((2, 5, 4, 19), 8), ((1, 3, 4, 40), 64), ((2, 7, 12, 131), 2)]


def close(got, want, atol=0.0, rel_of_max=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = atol + rel_of_max * max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= bound, (err, bound)


def stats(rng, c):
    """(mean, var, gamma, beta, slope) of a BatchNorm + PReLU, off their defaults."""
    return ((rng.standard_normal(c) * 0.3).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
            (0.2 * rng.standard_normal(c)).astype(np.float32), np.float32(rng.uniform(0.05, 0.3)))


def T(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("shape,d", SHAPES)
def test_tail_bwd_matches_jax(rng, shape, d):
    c = shape[2]
    dh2a, h2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    m, v, ga, be, a = stats(rng, c)
    ref = jax_tail_bwd(*map(jnp.asarray, (dh2a, h2, m, v, ga, be, a)), EPS, interpret=True)
    tail_bwd.launches = 0
    for fn in (tail_bwd, tail_bwd_reference):
        got = fn(*T(dh2a, h2, m, v, ga, be, a), EPS)
        close(got[0], ref[0], atol=1e-4)
        for g, r in zip(got[1:], ref[1:]):
            close(g, r, rel_of_max=1e-3)
    assert tail_bwd.launches == 0  # the CPU runs the plain version


@pytest.mark.parametrize("shape,d", SHAPES + [((1, 3, 4, 19), 8)])
def test_mid_bwd_matches_jax(rng, shape, d):
    """The port takes the BN2-applied gradient as it is; the JAX kernel takes
    it padded by a band and 2d frames on each side."""
    c = shape[2]
    dh2, h1 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    wd = rng.standard_normal((3, 3, c)).astype(np.float32)
    m, v, ga, be, a = stats(rng, c)
    gp = np.pad(dh2, ((0, 0), (1, 1), (0, 0), (2 * d, 2 * d)))
    ref = jax_mid_bwd(*map(jnp.asarray, (gp, h1, wd, m, v, ga, be, a)), d, EPS, interpret=True)
    mid_bwd.launches = 0
    for fn in (mid_bwd, mid_bwd_reference):
        got = fn(*T(dh2, h1, wd, m, v, ga, be, a), d, EPS)
        assert len(got) == len(ref) == 6
        close(got[0], ref[0], atol=1e-4)
        for g, r in zip(got[1:], ref[1:]):
            close(g, r, rel_of_max=1e-3)
    assert mid_bwd.launches == 0


def test_mid_bwd_has_no_dilation_limit(rng):
    """d = 64 on 19 frames (the JAX kernel stops at d = 32): against autograd
    through the stencil of the recomputed PReLU1 output."""
    shape, d, c = (1, 3, 4, 19), 64, 4
    dh2, h1 = T(*(rng.standard_normal(shape).astype(np.float32) for _ in range(2)))
    wd, = T(rng.standard_normal((3, 3, c)).astype(np.float32))
    m, v, ga, be, a = T(*stats(rng, c))
    got = mid_bwd(dh2, h1, wd, m, v, ga, be, a, d, EPS)
    leaves = [t.clone().requires_grad_() for t in (h1, wd, ga, be, a)]
    h1_, wd_, ga_, be_, a_ = leaves
    hn = (h1_ - m[:, None]) * torch.rsqrt(v + EPS)[:, None] * ga_[:, None] + be_[:, None]
    xe = torch.nn.functional.pad(torch.where(hn < 0, a_ * hn, hn), (2 * d, 0))
    bd = torch.zeros(c, requires_grad=True)
    ((dw_taps_reference(xe, wd_, d) + bd[:, None]) * dh2).sum().backward()
    # mid_bwd's first output is the gradient at BN1's output, before its affine
    close(got[0] * ga[:, None] * torch.rsqrt(v + EPS)[:, None], h1_.grad, atol=1e-5)
    close(got[1], wd_.grad, atol=1e-4)
    close(got[2], ga_.grad, atol=1e-4)
    close(got[3], be_.grad, atol=1e-4)
    close(got[4], a_.grad, atol=1e-4)
    close(got[5], bd.grad, atol=1e-4)



@pytest.mark.parametrize("shape,d", [(s, d) for s in STAGES for d in (1, 2, 4, 8, 64)] + RAGGED
                         + [((1, 4, 4, 2000), 700)])
def test_mid_plan_gives_a_legal_tile(shape, d):
    """Every tile of mid_plan's grid stages the dh2 its points read (a band
    each side, and 2d frames after its own or up to the last frame) within its
    shared memory, and the block fits the card; config 5b's stages get the
    blocks an SM the plan aims at."""
    b, k, c, t = shape
    plan = mid_plan(b, k, c, t, d)
    assert 1 <= plan.kb <= min(k, 8) and 1 <= plan.tt <= t
    assert plan.tiles == b * -(-k // plan.kb) * -(-t // plan.tt)
    assert plan.smem == mid_smem_bytes(plan.kb, plan.tt, t, d) <= SMEM_BYTES
    stride = min(plan.tt + 2 * d, t)  # a staged dh2 row, as the kernel lays it out
    assert plan.smem == 4 * ((plan.kb + 2) * stride + plan.kb * plan.tt)
    for t0 in range(0, t, plan.tt):
        staged = min(plan.tt + 2 * d, t - t0)
        own = min(plan.tt, t - t0)
        assert staged <= stride
        assert staged == min(own + 2 * d, t - t0)  # the latest tap of the last own frame, or T
    if shape in STAGES and d <= 8:
        assert SM_SMEM_BYTES // (plan.smem + BLOCK_RESERVED_SMEM) >= MIN_BLOCKS_PER_SM


TILINGS = [  # (B, K, C, T), d, forced (kb, tt)
    ((2, 8, 12, 50), 1, (None, None)),
    ((2, 13, 4, 131), 2, (4, None)),  # K not a multiple of kb
    ((2, 9, 8, 131), 2, (None, 32)),  # T not a multiple of tt
    ((1, 6, 4, 100), 64, (None, 32)),  # d >= tt
    ((1, 16, 5, 626), 8, (None, None)),  # B = 1
    ((2, 5, 4, 19), 8, (3, 7)),
    ((1, 4, 4, 2000), 700, (None, None)),  # d = 700: the plan takes a smaller band group
]


@pytest.mark.parametrize("shape,d,forced", TILINGS)
def test_mid_tiles_finish_to_the_reference_sums(rng, shape, d, forced):
    """The plain versions of the kernel's two steps (per-tile f32 sums with the
    taps taken around each point of h1a, then the float64 finish) give
    mid_bwd_reference's five sums at any tile."""
    c = shape[2]
    dh2, h1 = T(*(rng.standard_normal(shape).astype(np.float32) for _ in range(2)))
    wd, = T(rng.standard_normal((3, 3, c)).astype(np.float32))
    m, v, ga, be, a = T(*stats(rng, c))
    plan = mid_plan(*shape, d, *forced)
    part = mid_partials_reference(dh2, h1, wd, m, v, ga, be, a, d, EPS, plan)
    assert tuple(part.shape) == (c, 13, plan.tiles) and part.dtype == torch.float32
    want = mid_bwd_reference(dh2, h1, wd, m, v, ga, be, a, d, EPS)
    got = mid_finish_reference(part)
    for g, w in zip(got, want[1:]):
        assert g.dtype == torch.float32
        close(g, w, rel_of_max=1e-4)

def test_kernel_wrappers_check_their_inputs(rng):
    c = 4
    g, h = T(*(rng.standard_normal((1, 3, c, 9)).astype(np.float32) for _ in range(2)))
    m, v, ga, be, a = T(*stats(rng, c))
    wd, = T(rng.standard_normal((3, 3, c)).astype(np.float32))
    with pytest.raises(ValueError, match="gradient must be float32"):
        tail_bwd(g[..., :-1], h, m, v, ga, be, a, EPS)
    with pytest.raises(ValueError, match="v2 must be float32"):
        tail_bwd(g, h, m, v[:-1], ga, be, a, EPS)
    with pytest.raises(ValueError, match="slope"):
        tail_bwd(g, h, m, v, ga, be, ga, EPS)
    with pytest.raises(ValueError, match="wd must be float32"):
        mid_bwd(g, h, wd[:2], m, v, ga, be, a, 1, EPS)
    with pytest.raises(ValueError, match="positive int"):
        mid_bwd(g, h, wd, m, v, ga, be, a, 0, EPS)


def block_pair(rng, c, d, jax_impl, x):
    """A cruse_tpu TFCMBlock with perturbed statistics, affines and slopes,
    and the port's block (training mode) carrying them."""
    jax_block = JaxTFCMBlock(c, d, jax_impl)
    variables = perturbed(JaxTFCMBlock(c, d, "xla").init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                         train=True), rng)
    block = TFCMBlock(c, d)
    block.load_state_dict(mtfaa_state_dict_from_flax(variables), strict=True)
    return jax_block, variables, block.train()


def jax_block_run(jax_block, variables, x, g):
    """(y, updated batch_stats, parameter gradients, dx) of sum(y * g)."""
    def loss(p, xx):
        (y, _), upd = jax_block.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                      xx, None, True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    return y, upd["batch_stats"], gp, gx


def flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(flat(value, path) if isinstance(value, dict) else {path: np.asarray(value)})
    return out


def assert_gradients_close(got: dict, want: dict):
    """tests/test_tfcm_train.py:117-131's rule, per leaf."""
    assert got.keys() == want.keys()
    gscale = max(np.abs(v).max() for v in want.values())
    for key in want:
        err = np.abs(got[key] - want[key]).max()
        rel = err / (np.abs(want[key]).max() + 1e-6)
        if "dw_bias" in key or "pconv1_bias" in key:  # true gradient zero: rounding noise
            assert err < 1e-3 * gscale + 5e-3, (key, err)
        else:
            assert rel < 2e-3 or err < 1e-3 * gscale + 1e-4, (key, err, rel)


@pytest.mark.parametrize("jax_impl", ["fused_pallas_interpret", "xla"])
@pytest.mark.parametrize("route", ["fused_fold", "pallas"])
@pytest.mark.parametrize("shape,d", SHAPES)
def test_block_training_matches_jax(rng, shape, d, route, jax_impl):
    """Output, running statistics and every gradient of a training TFCMBlock,
    by both of the port's routes, against the reference's kernel-backed and
    plain routes."""
    c = shape[2]
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jax_block, variables, block = block_pair(rng, c, d, jax_impl, x)
    block.dw_impl = route
    ref_y, ref_stats, ref_gp, ref_gx = jax_block_run(jax_block, variables, x, jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    y = block(xt, train=True)
    (y * torch.from_numpy(g)).sum().backward()
    close(y.detach(), ref_y, atol=1e-5)
    got = mtfaa_flax_from_named(block.state_dict())
    for key, value in flat(ref_stats).items():
        close(flat(got["batch_stats"])[key], value, atol=1e-5)
    grads = mtfaa_flax_from_named({n: p.grad for n, p in block.named_parameters()})["params"]
    assert_gradients_close(flat(grads), flat(jax.tree_util.tree_map(np.asarray, ref_gp)))
    close(xt.grad, ref_gx, atol=2e-4)


@pytest.mark.parametrize("shape,d", SHAPES)
def test_block_train_matches_autograd_through_the_plain_block(rng, shape, d):
    """tfcm_block_train's six outputs and thirteen gradients against torch
    autograd through tfcm_block_reference."""
    c = shape[2]
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    m1, v1, g1, be1, a1 = stats(rng, c)
    _, _, g2, be2, a2 = stats(rng, c)
    w = lambda *s: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)  # noqa: E731
    values = dict(w1=w(c, c), b1=w(c), g1=g1, be1=be1, a1=a1, wd=w(3, 3, c), bd=w(c), g2=g2,
                  be2=be2, a2=a2, w2=w(c, c), b2=w(c))
    results = []
    for fn in (tfcm_block_train, tfcm_block_reference):
        xt = torch.from_numpy(x).requires_grad_()
        params = [torch.from_numpy(np.asarray(values[n])).requires_grad_() for n in PARAM_NAMES]
        out = fn(xt, tuple(params), d, EPS)
        assert len(out) == 6 and tuple(out[1].shape) == shape[:3] + (2 * d,)
        assert not any(o.requires_grad for o in out[1:])
        (out[0] * g).sum().backward()
        results.append(([o.detach().numpy() for o in out],
                        {"x": xt.grad.numpy(), **{n: p.grad.numpy() for n, p in zip(PARAM_NAMES, params)}}))
    for got, want in zip(*[r[0] for r in results]):
        close(got, want, atol=1e-5)
    got, want = results[0][1], results[1][1]
    gscale = max(np.abs(v).max() for v in want.values())
    for key in want:  # b1 and bd feed a BatchNorm: their gradient is rounding noise on both sides
        close(got[key], want[key], atol=1e-4 * gscale + 1e-5)


@pytest.mark.parametrize("shape", [(2, 5, 6, 23), (3, 4, 8, 50)])
def test_batch_norm_training_matches_jax(rng, shape):
    """Train-mode BatchNormC: output, dx, dscale, dbias and the moved running
    statistics (0.9 old + 0.1 batch, biased variance)."""
    c = shape[2]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jax_bn = JaxBatchNormC()
    variables = perturbed(jax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    variables["params"]["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)

    def loss(p, xx):
        y, upd = jax_bn.apply({"params": p, "batch_stats": variables["batch_stats"]}, xx, True,
                              mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (ref_y, ref_stats)), (ref_gp, ref_gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    bn = BatchNormC(c)
    bn.load_state_dict(mtfaa_state_dict_from_flax(variables), strict=True)
    bn.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    close(y.detach(), ref_y, atol=1e-5)
    close(xt.grad, ref_gx, atol=1e-5)
    close(bn.scale.grad, ref_gp["scale"], rel_of_max=1e-5)
    close(bn.bias.grad, ref_gp["bias"], rel_of_max=1e-5)
    close(bn.mean, ref_stats["mean"], atol=1e-6)
    close(bn.var, ref_stats["var"], atol=1e-6)
    assert not bn.mean.requires_grad and not bn.var.requires_grad
    with torch.no_grad():
        eval_y = bn.eval()(xt)
    assert float((eval_y - y.detach()).abs().max()) > 1e-3  # eval uses the running statistics
