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
    dw_bwd_reference, dw_causal_tm, dw_stencil_bwd, dw_stencil_fwd, dw_taps_reference)

SHAPES = [(2, 8, 6, 40), (1, 5, 3, 23)]  # tests/test_dw_kernel.py's: B, K, C, T


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
