"""Port parity: cruse_tpu_torch's temporal attention (the kernel's plain
version and its CPU wrapper) and ``AxialSelfAttention`` against cruse_tpu,
on the CPU.

The JAX flash kernel runs in interpret mode, as tests/test_asa_kernel.py
runs it. Tolerance 1e-5 max-abs: float32 softmax attention summed in another
order. The reference's flash path applies the causal mask even when the
ASA is non-causal; the port does not, which the last test pins.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.models.mtfaa import AxialSelfAttention as JaxASA
from cruse_tpu.ops.asa_kernel import flash_tattn_tm as jax_flash_tattn_tm
from cruse_tpu.ops.asa_kernel import xla_tattn_tm

from cruse_tpu_torch.models.mtfaa import AxialSelfAttention
from cruse_tpu_torch.ops.asa_kernel import flash_tattn_tm, tattn_reference
from cruse_tpu_torch.utils.weights import mtfaa_state_dict_from_flax

CASES = [  # tests/test_asa_kernel.py's: BF, c, C, T, window
    (3, 6, 24, 200, None),  # stage-0 geometry, T not a block multiple
    (2, 8, 32, 130, None),  # stage-1
    (2, 12, 48, 257, 50),  # stage-2, windowed
    (1, 6, 24, 128, 16),  # exact single block, small window
    (1, 8, 32, 384, 128),  # window == block edge
]


@pytest.mark.parametrize("bf,c,cv,t,w", CASES)
def test_attention_matches_jax(bf, c, cv, t, w):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((bf, c, t), (bf, c, t), (bf, cv, t)))
    ref_xla = np.asarray(xla_tattn_tm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w))
    ref_flash = np.asarray(jax_flash_tattn_tm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w, True))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    flash_tattn_tm.launches = 0
    for got in (flash_tattn_tm(qt, kt, vt, w), tattn_reference(qt, kt, vt, w)):
        np.testing.assert_allclose(got.numpy(), ref_xla, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), ref_flash, atol=1e-5)
    assert flash_tattn_tm.launches == 0  # the CPU runs the plain version


def make_asa_pair(rng, channels, causal=True, window=None, impl="auto", shape=(2, 6, 20)):
    b, f, t = shape
    x = rng.standard_normal((b, f, channels, t)).astype(np.float32)
    jax_asa = JaxASA(channels, causal=causal, window=window, impl=impl)
    variables = jax.tree_util.tree_map(np.asarray, jax_asa.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    asa = AxialSelfAttention(channels, causal=causal, window=window).eval()
    asa.load_state_dict(mtfaa_state_dict_from_flax(variables), strict=True)
    return jax_asa, variables, asa, x


@pytest.mark.parametrize("causal,window,impl", [(True, None, "auto"), (True, 7, "auto"),
                                                (True, 50, "auto"), (False, None, "xla"),
                                                (False, 7, "xla")],
                         ids=["full_causal", "windowed", "window_over_T", "non_causal",
                              "non_causal_window_unused"])
def test_asa_matches_jax(rng, causal, window, impl):
    jax_asa, variables, asa, x = make_asa_pair(rng, 16, causal, window, impl)
    ref, _ = jax_asa.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = asa(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_non_causal_asa_is_not_causal(rng):
    """Frame 0 of the non-causal ASA depends on a later frame (the
    reference's flash path would mask it); of the causal ASA it does not."""
    for causal in (False, True):
        _, _, asa, x = make_asa_pair(rng, 8, causal=causal, shape=(1, 4, 12))
        later = x.copy()
        later[..., 9] += 3.0
        with torch.no_grad():
            a, b = (asa(torch.from_numpy(u))[..., 0] for u in (x, later))
        moved = float((a - b).abs().max())
        assert (moved > 1e-3) if not causal else (moved == 0.0), (causal, moved)


def test_wrapper_checks_its_inputs():
    q = torch.zeros(2, 4, 10)
    v = torch.zeros(2, 8, 10)
    for args in [(q[0], q, v), (q, q[:, :3], v), (q, q, v[:, :, :9]), (q.double(), q, v)]:
        with pytest.raises(ValueError):
            flash_tattn_tm(*args)
    with pytest.raises(ValueError, match="window"):
        flash_tattn_tm(q, q, v, 0)
    with pytest.raises(NotImplementedError, match="streaming"):
        AxialSelfAttention(8)(torch.zeros(1, 2, 8, 5), state=(None, None, None))
