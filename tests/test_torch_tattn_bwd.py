"""Port parity: the backward of cruse_tpu_torch's temporal attention (the
plain dense backward, the ``tattn_dq`` / ``tattn_dkv`` CPU wrappers and
autograd through ``flash_tattn_tm``) against cruse_tpu, on the CPU.

The JAX flash kernel runs in interpret mode (forward with its logsumexp, the
dq and the dk/dv kernels), as tests/test_asa_kernel.py runs it. Tolerance
2e-5 max-abs, that test's own: float32 softmax attention and its gradient,
summed in another order.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.ops.asa_kernel import flash_tattn_tm as jax_flash_tattn_tm
from cruse_tpu.ops.asa_kernel import xla_tattn_tm

from cruse_tpu_torch.ops.asa_kernel import (
    flash_tattn_tm, tattn_bwd_reference, tattn_dkv, tattn_dq, tattn_reference)
from tests.test_torch_tattn import CASES

GRAD_CASES = CASES + [(2, 3, 12, 37, 7), (2, 6, 24, 100, 126)]  # tiny; T < window


@pytest.mark.parametrize("bf,c,cv,t,w", GRAD_CASES)
def test_gradients_match_jax(bf, c, cv, t, w):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((bf, c, t), (bf, c, t), (bf, cv, t)))
    g = rng.standard_normal((bf, cv, t)).astype(np.float32)

    def jax_grads(fn):
        return jax.grad(lambda *a: jnp.sum(fn(*a) * g), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    ref_flash = jax_grads(lambda qq, kk, vv: jax_flash_tattn_tm(qq, kk, vv, w, True))
    ref_xla = jax_grads(lambda qq, kk, vv: xla_tattn_tm(qq, kk, vv, w))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    gt = torch.from_numpy(g)
    (flash_tattn_tm(qt, kt, vt, w) * gt).sum().backward()  # the CPU: autograd on the plain version
    results = [(qt.grad, kt.grad, vt.grad)]
    qd, kd, vd = qt.detach(), kt.detach(), vt.detach()
    results.append(tattn_bwd_reference(qd, kd, vd, gt, w))
    out = tattn_reference(qd, kd, vd, w)
    lse = torch.zeros(bf, t)  # the CPU wrappers take, and ignore, the kernels' lse and D
    dd = (gt * out).sum(dim=1)
    tattn_dq.launches = tattn_dkv.launches = 0
    results.append((tattn_dq(qd, kd, vd, gt, lse, dd, w), *tattn_dkv(qd, kd, vd, gt, lse, dd, w)))
    assert tattn_dq.launches == 0 and tattn_dkv.launches == 0
    for got in results:
        for ours, flash, xla in zip(got, ref_flash, ref_xla):
            np.testing.assert_allclose(ours.numpy(), np.asarray(flash), atol=2e-5)
            np.testing.assert_allclose(ours.numpy(), np.asarray(xla), atol=2e-5)


def test_backward_wrappers_check_their_inputs():
    q, k, v = torch.zeros(2, 3, 9), torch.zeros(2, 3, 9), torch.zeros(2, 8, 9)
    g, lse, dd = torch.zeros(2, 8, 9), torch.zeros(2, 9), torch.zeros(2, 9)
    with pytest.raises(ValueError, match="dout must be float32"):
        tattn_dq(q, k, v, g[:, :4], lse, dd)
    with pytest.raises(ValueError, match="lse must be float32"):
        tattn_dkv(q, k, v, g, lse[:, :4], dd)
    with pytest.raises(ValueError, match="dd must be float32"):
        tattn_dq(q, k, v, g, lse, dd.double())
    with pytest.raises(ValueError, match="window"):
        tattn_dkv(q, k, v, g, lse, dd, 0)
