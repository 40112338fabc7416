"""Port parity: cruse_tpu_torch's depthwise stencil (``dw_causal_tm`` with its
backward, the plain versions and the CPU wrappers) against cruse_tpu, on the
CPU.

The JAX Pallas kernel runs in interpret mode, as tests/test_dw_kernel.py runs
it. Tolerances: forward 1e-5, gradients 1e-4 max-abs (float32 sums of nine
taps, and of B*K*T products for the tap gradients, taken in another order).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.ops.dw_kernel import dw_causal_tm as jax_dw_causal_tm
from cruse_tpu.ops.dw_kernel import dw_taps_reference as jax_dw_taps_reference

from cruse_tpu_torch.ops.dw_kernel import (
    DW_BANDS, DW_MAX_SPAN, DW_MIN_BLOCKS, dw_bwd_reference, dw_causal_tm, dw_finish_reference, dw_partials_reference,
    dw_plan, dw_row_floats, dw_smem_bytes, dw_stencil_bwd, dw_tile_cost, dw_stencil_fwd, dw_taps_reference, dw_walk_reference)

SHAPES = [(2, 8, 6, 40), (1, 5, 3, 23)]  # tests/test_dw_kernel.py's: B, K, C, T
STAGES = [(16, 64, 24, 626), (16, 32, 32, 626), (16, 16, 48, 626), (16, 128, 4, 626)]  # config 5b, B=16 x 10 s
RAGGED = [((2, 5, 4, 19), 8), ((1, 3, 4, 40), 64), ((2, 7, 12, 131), 2), ((1, 4, 4, 2000), 700),
          ((1, 2, 2, 8), 700)]
SMEM_BYTES = 227 * 1024  # the most shared memory a Hopper block takes


def inputs(rng, shape, d):
    b, k, c, t = shape
    return (rng.standard_normal((b, k, c, t + 2 * d)).astype(np.float32),
            rng.standard_normal((3, 3, c)).astype(np.float32))


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(rng, shape, d):
    x, wd = inputs(rng, shape, d)
    ref_kernel = np.asarray(jax_dw_causal_tm(jnp.asarray(x), jnp.asarray(wd), d, True))
    ref_plain = np.asarray(jax_dw_taps_reference(jnp.asarray(x), jnp.asarray(wd), d))
    xt, wt = torch.from_numpy(x), torch.from_numpy(wd)
    for got in (dw_causal_tm(xt, wt, d), dw_stencil_fwd(xt, wt, d), dw_taps_reference(xt, wt, d)):
        assert tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), ref_kernel, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), ref_plain, atol=1e-5)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax(rng, shape, d):
    """dx and dwd of sum(y * g) through the port's autograd.Function (whose
    CPU backward is the explicit flipped stencil and tap sums), through
    autograd on the plain forward, and through the JAX kernel's vjp."""
    x, wd = inputs(rng, shape, d)
    g = rng.standard_normal(shape).astype(np.float32)

    def jax_loss(fn):
        return jax.grad(lambda xx, ww: jnp.sum(fn(xx, ww) * g), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(wd))

    ref_kernel = jax_loss(lambda xx, ww: jax_dw_causal_tm(xx, ww, d, True))
    ref_plain = jax_loss(lambda xx, ww: jax_dw_taps_reference(xx, ww, d))
    gt = torch.from_numpy(g)
    results = []
    for fn in (dw_causal_tm, dw_taps_reference):
        xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(wd).requires_grad_()
        (fn(xt, wt, d) * gt).sum().backward()
        results.append((xt.grad, wt.grad))
    results.append(dw_stencil_bwd(gt, torch.from_numpy(x), torch.from_numpy(wd), d))
    results.append(dw_bwd_reference(gt, torch.from_numpy(x), torch.from_numpy(wd), d))
    for dx, dwd in results:
        for ref_dx, ref_dwd in (ref_kernel, ref_plain):
            np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=1e-4)
            np.testing.assert_allclose(dwd.numpy(), np.asarray(ref_dwd), atol=1e-4)


def test_dilation_past_the_signal(rng):
    """d = 64 on 19 frames: every tap but the last reads only the extension."""
    x, wd = inputs(rng, (1, 3, 4, 19), 64)
    ref = np.asarray(jax_dw_taps_reference(jnp.asarray(x), jnp.asarray(wd), 64))
    np.testing.assert_allclose(dw_causal_tm(torch.from_numpy(x), torch.from_numpy(wd), 64).numpy(),
                               ref, atol=1e-5)


def test_wrappers_check_their_inputs_and_count_no_cpu_launch(rng):
    x, wd = (torch.from_numpy(a) for a in inputs(rng, (1, 5, 3, 23), 2))
    dw_stencil_fwd.launches = dw_stencil_bwd.launches = 0
    y = dw_stencil_fwd(x, wd, 2)
    dw_stencil_bwd(torch.ones_like(y), x, wd, 2)
    assert dw_stencil_fwd.launches == 0 and dw_stencil_bwd.launches == 0  # the CPU runs the plain versions
    with pytest.raises(ValueError, match="wd must be float32"):
        dw_stencil_fwd(x, wd[:, :, :2], 2)
    with pytest.raises(ValueError, match="positive int"):
        dw_stencil_fwd(x, wd, 0)
    with pytest.raises(ValueError, match="T >= 1"):
        dw_stencil_fwd(x, wd, 14)  # 27 frames hold no output frame at d = 14
    with pytest.raises(ValueError, match="g must be float32"):
        dw_stencil_bwd(y[..., :-1], x, wd, 2)
    with pytest.raises(ValueError, match="float32"):
        dw_stencil_fwd(x.double(), wd, 2)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape,d", [(s, d) for s in STAGES for d in (1, 2, 4, 8)] + RAGGED)
def test_dw_plan_gives_a_legal_tile(shape, d, backward):
    """dw_plan's tile covers the frames (of y, or of dx backward) in the
    fewest spans of a multiple of 4 frames that a block's threads hold, its
    shared memory is the source's ring of staged rows and fits the card, and
    config 5b's stages get enough blocks to fill 132 SMs, at the band group of
    least cost among those."""
    b, k, c, t = shape
    plan = dw_plan(b, k, c, t, d, backward)
    frames = t + 2 * d if backward else t
    assert 1 <= plan.kb <= k
    assert plan.tt % 4 == 0 and 4 <= plan.tt <= DW_MAX_SPAN[backward]
    spans = -(-frames // plan.tt)
    assert spans == -(-frames // DW_MAX_SPAN[backward])
    assert (spans - 1) * plan.tt < frames <= spans * plan.tt
    assert plan.tt == (-(-frames // spans) + 3) // 4 * 4  # the fewest spans, balanced
    assert plan.tiles == b * -(-k // plan.kb) * spans
    row = dw_row_floats(plan.tt, d)
    assert row % 4 == 0 and row >= (plan.tt + 2 * d if d <= plan.tt else 3 * plan.tt) + 6
    assert plan.smem == dw_smem_bytes(plan.tt, d, backward) == 4 * 4 * (row + (plan.tt + 4 if backward else 0))
    assert plan.smem <= 48 * 1024 <= SMEM_BYTES  # no opt-in to more shared memory needed
    if shape in STAGES:
        assert plan.tiles * c >= DW_MIN_BLOCKS
        legal = [g for g in DW_BANDS if g <= k and b * c * -(-k // g) * spans >= DW_MIN_BLOCKS]
        assert dw_tile_cost(b, k, c, spans, plan.kb, backward) == min(
            dw_tile_cost(b, k, c, spans, g, backward) for g in legal)


def test_dw_plan_takes_forced_tiles_and_refuses_bad_ones():
    assert dw_plan(2, 13, 4, 131, 2, False, 4, 32)[:3] == (4, 32, 2 * 4 * 5)
    assert dw_plan(2, 13, 4, 131, 2, True, 4, 32)[:3] == (4, 32, 2 * 4 * 5)  # 135 frames of dx
    assert dw_plan(2, 13, 4, 131, 2, True, None, 768).tt == 768  # six frames a thread backward
    for backward, kb, tt in ((False, 0, None), (False, 14, None), (False, None, 30), (False, None, 644),
                             (False, None, 0), (True, None, 772)):
        with pytest.raises(ValueError, match="dw_stencil tile"):
            dw_plan(2, 13, 4, 131, 2, backward, kb, tt)


# (B, K, C, T), d, forced (kb, tt): tiles off K and T, 2d > T, d > tt (three runs a staged row)
WALKS = [((2, 13, 4, 131), 2, (4, 32)), ((2, 9, 8, 131), 2, (None, 32)), ((1, 3, 4, 40), 64, (None, None)),
         ((2, 5, 4, 19), 8, (3, 8)), ((1, 6, 4, 100), 64, (None, 32)), ((1, 7, 3, 90), 40, (3, 32)),
         ((1, 20, 2, 60), 1, (16, None))]


@pytest.mark.parametrize("shape,d,forced", WALKS)
def test_walk_matches_jax(rng, shape, d, forced):
    """dw_walk_reference, tile by tile as a block walks, gives y and dx as the
    JAX kernel (interpret mode) does: y and its vjp's dx within 1e-5."""
    x, wd = inputs(rng, shape, d)
    g = rng.standard_normal(shape).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda xx: jax_dw_causal_tm(xx, jnp.asarray(wd), d, True), jnp.asarray(x))
    dx_ref = vjp(jnp.asarray(g))[0]
    xt, wt, gt = torch.from_numpy(x), torch.from_numpy(wd), torch.from_numpy(g)
    y = dw_walk_reference(xt, wt, d, dw_plan(*shape, d, False, *forced))
    dx = dw_walk_reference(xt, wt, d, dw_plan(*shape, d, True, *forced), gt)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), atol=1e-5)


@pytest.mark.parametrize("shape,d,forced", WALKS)
def test_partials_finish_to_the_jax_tap_sums(rng, shape, d, forced):
    """dw_partials_reference (each tile's nine f32 tap sums, as dw_bwd_kernel
    takes them around each point of x) and dw_finish_reference (the f64 sum
    over the tiles) give the JAX kernel's dwd within 1e-4 x max(1, max|dwd|)."""
    x, wd = inputs(rng, shape, d)
    g = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda ww: jax_dw_causal_tm(jnp.asarray(x), ww, d, True), jnp.asarray(wd))
    dwd_ref = np.asarray(vjp(jnp.asarray(g))[0])
    plan = dw_plan(*shape, d, True, *forced)
    part = dw_partials_reference(torch.from_numpy(g), torch.from_numpy(x), d, plan)
    assert tuple(part.shape) == (shape[2], 9, plan.tiles) and part.dtype == torch.float32
    dwd = dw_finish_reference(part)
    assert dwd.dtype == torch.float32 and tuple(dwd.shape) == (3, 3, shape[2])
    assert np.abs(dwd.numpy() - dwd_ref).max() <= 1e-4 * max(1.0, np.abs(dwd_ref).max())
