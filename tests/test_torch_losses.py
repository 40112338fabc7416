"""Port parity: cruse_tpu_torch's training losses (``si_snr``,
``compressed_spectral_loss``) and the gradient balancer against cruse_tpu,
on the CPU, at 1e-5 relative (float32 sums in another order).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.losses.balancer import Balancer as JaxBalancer
from cruse_tpu.losses.sisnr import si_snr as jax_si_snr
from cruse_tpu.losses.sisnr import si_snr_loss as jax_si_snr_loss
from cruse_tpu.losses.spectral import compressed_spectral_loss as jax_spectral

from cruse_tpu_torch.losses.balancer import Balancer
from cruse_tpu_torch.losses.sisnr import si_snr, si_snr_loss
from cruse_tpu_torch.losses.spectral import compressed_spectral_loss

RTOL = 1e-5


def waves(rng, shape=(3, 4000)):
    ref = rng.standard_normal(shape).astype(np.float32)
    return (ref + 0.3 * rng.standard_normal(shape)).astype(np.float32), ref


def test_si_snr_matches_jax(rng):
    est, ref = waves(rng)
    got = si_snr(torch.from_numpy(est), torch.from_numpy(ref))
    np.testing.assert_allclose(float(got), float(jax_si_snr(jnp.asarray(est), jnp.asarray(ref))), rtol=RTOL)
    et = torch.from_numpy(est).requires_grad_()
    si_snr_loss(et, torch.from_numpy(ref)).backward()
    want = jax.grad(lambda e: jax_si_snr_loss(e, jnp.asarray(ref)))(jnp.asarray(est))
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("layout", ["stacked", "complex"])
def test_compressed_spectral_loss_matches_jax(rng, layout):
    est, ref = (rng.standard_normal((2, 9, 33, 2)).astype(np.float32) for _ in range(2))
    want = jax_spectral(jnp.asarray(est), jnp.asarray(ref))
    if layout == "complex":
        args = [torch.complex(torch.from_numpy(a[..., 0]), torch.from_numpy(a[..., 1])) for a in (est, ref)]
        np.testing.assert_allclose(float(compressed_spectral_loss(*args)), float(want), rtol=RTOL)
        with pytest.raises(ValueError, match="re, im"):
            compressed_spectral_loss(torch.zeros(2, 3), torch.zeros(2, 3))
        return
    et = torch.from_numpy(est).requires_grad_()
    loss = compressed_spectral_loss(et, torch.from_numpy(ref))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL)
    grad = jax.grad(lambda e: jax_spectral(e, jnp.asarray(ref)))(jnp.asarray(est))
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("rescale", [True, False], ids=["rescaled", "plain_weights"])
def test_balancer_matches_jax_over_two_steps(rng, rescale):
    """Two calls, so that the moving average of the norms is exercised:
    cotangent, losses and state after each."""
    weights = {"a": 1.0, "b": 3.0}
    target = rng.standard_normal((4, 6, 5)).astype(np.float32)
    jb = JaxBalancer.make(weights, ema_decay=0.9, rescale_grads=rescale)
    tb = Balancer.make(weights, ema_decay=0.9, rescale_grads=rescale)
    jax_fns = {"a": lambda o: jnp.mean(jnp.square(o - target)), "b": lambda o: jnp.sum(jnp.abs(o)) / 7}
    tt = torch.from_numpy(target)
    torch_fns = {"a": lambda o: ((o - tt) ** 2).mean(), "b": lambda o: o.abs().sum() / 7}
    js, ts = jb.init_state(), tb.init_state()
    for step in range(2):
        out = rng.standard_normal((4, 6, 5)).astype(np.float32) * (1 + 4 * step)
        jg, jl, js, jm = jb.output_cotangent(jax_fns, jnp.asarray(out), js)
        tg, tl, ts, tm = tb.output_cotangent(torch_fns, torch.from_numpy(out), ts)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-8)
        assert sorted(tm) == sorted(jm) == ["loss_a", "loss_b"]
        for name in weights:
            np.testing.assert_allclose(float(tl[name]), float(jl[name]), rtol=RTOL)
            np.testing.assert_allclose(float(tm[f"loss_{name}"]), float(jm[f"loss_{name}"]), rtol=RTOL)
            np.testing.assert_allclose(float(ts.total[name]), float(js.total[name]), rtol=RTOL)
            np.testing.assert_allclose(float(ts.fix[name]), float(js.fix[name]), rtol=RTOL)
        assert not tg.requires_grad


def test_balancer_reference_self_test():
    """The reference's own check: opposing unit-normed gradients cancel when
    rescaled, and add to 99 with plain weights."""
    one = torch.ones(1)
    fns = {"1": lambda x: (x - one).abs().mean(), "2": lambda x: 100.0 * (x + one).abs().mean()}
    for rescale, want in ((False, 99.0), (True, 0.0)):
        balancer = Balancer.make({"1": 1.0, "2": 1.0}, rescale_grads=rescale)
        grad, _, state, _ = balancer.output_cotangent(fns, torch.zeros(1), balancer.init_state())
        np.testing.assert_allclose(grad.numpy(), [want], atol=1e-6)
        assert float(state.fix["1"]) == 1.0
