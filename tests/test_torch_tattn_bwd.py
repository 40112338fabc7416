"""Port parity: the backward of cruse_tpu_torch's temporal attention (the
plain dense backward, the ``tattn_dq`` / ``tattn_dkv`` CPU wrappers and
autograd through ``flash_tattn_tm``) against cruse_tpu, on the CPU.

The JAX flash kernel runs in interpret mode (forward with its logsumexp, the
dq and the dk/dv kernels), as tests/test_asa_kernel.py runs it. Tolerance
2e-5 max-abs, that test's own: float32 softmax attention and its gradient,
summed in another order. The dk/dv kernel's walk (``tattn_key_tiles``: which
query tiles a warp of keys visits and which carry the mask;
``tattn_dkv_walk_reference``: the base-2 walk over them) and the dq kernel's
(``tattn_dq_walk_reference``: the forward's key tiles, ``tattn_band_tiles``)
are held against the JAX gradients, fed by the JAX forward's output and
logsumexp.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.ops.asa_kernel import _fwd_impl as jax_fwd_impl
from cruse_tpu.ops.asa_kernel import flash_tattn_tm as jax_flash_tattn_tm
from cruse_tpu.ops.asa_kernel import xla_tattn_tm

from cruse_tpu_torch.ops.asa_kernel import (
    QUERY_TILE, WARP_KEYS, band_mask, flash_tattn_tm, tattn_bwd_reference, tattn_dkv,
    tattn_dkv_walk_reference, tattn_dq, tattn_dq_walk_reference, tattn_key_tiles, tattn_reference)
from tests.test_torch_tattn import CASES

GRAD_CASES = CASES + [(2, 3, 12, 37, 7), (2, 6, 24, 100, 126)]  # tiny; T < window
WALK_CASES = GRAD_CASES + [
    (2, 8, 32, 33, None),  # one key past a tile: a warp of one live key
    (2, 8, 32, 33, 7),
    (2, 8, 32, 100, 1),  # window 1: each key seen by its own query alone
    (2, 6, 24, 190, 126),  # stage 0's widths, the window inside the row
    (2, 8, 32, 65, 5),  # a last query (key) block of one frame, the window's edge inside the row
]


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


def walk_against_jax(bf, c, cv, t, w, argnums, walk):
    """A kernel walk's gradients (``walk(q, k, v, dout, lse, dd, w)``, a tuple
    in ``argnums``' order), fed by the JAX flash forward's output and residual
    logsumexp, against JAX's gradients: the flash kernel (interpret) and
    xla_tattn_tm."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((bf, c, t), (bf, c, t), (bf, cv, t)))
    g = rng.standard_normal((bf, cv, t)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    def jax_grads(fn):
        return jax.grad(lambda *a: jnp.sum(fn(*a) * g), argnums=argnums)(jq, jk, jv)

    wants = [jax_grads(lambda qq, kk, vv: jax_flash_tattn_tm(qq, kk, vv, w, True)),
             jax_grads(lambda qq, kk, vv: xla_tattn_tm(qq, kk, vv, w))]
    out, (*_, lse) = jax_fwd_impl(jq, jk, jv, w, True)
    gt = torch.from_numpy(g)
    lse_t = torch.from_numpy(np.array(lse)[:, 0, :t])
    dd = (gt * torch.from_numpy(np.array(out))).sum(dim=1)
    got = walk(*(torch.from_numpy(a) for a in (q, k, v)), gt, lse_t, dd, w)
    for want in wants:
        for ours, theirs in zip(got, want):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5)


@pytest.mark.parametrize("bf,c,cv,t,w", WALK_CASES)
def test_dkv_walk_matches_jax(bf, c, cv, t, w):
    """dk and dv of the dk/dv kernel's walk against JAX's (``walk_against_jax``)."""
    walk_against_jax(bf, c, cv, t, w, (1, 2), tattn_dkv_walk_reference)


@pytest.mark.parametrize("bf,c,cv,t,w", WALK_CASES)
def test_dq_walk_matches_jax(bf, c, cv, t, w):
    """dq of the dq kernel's walk against JAX's (``walk_against_jax``)."""
    walk_against_jax(bf, c, cv, t, w, (0,), lambda *a: (tattn_dq_walk_reference(*a),))


@pytest.mark.parametrize("t,window", [(626, 126), (626, None), (100, 126), (33, 7), (33, None), (200, 1),
                                      (200, 32), (1, 126), (31, None), (65, 5), (97, 40)])
def test_key_walk_covers_the_band(t, window):
    """Across a row's warps of 32 keys, the tiles of ``tattn_key_tiles``
    visit each (query, key) pair of the band exactly once; a tile that holds
    a pair outside the band is flagged, and the walk starts at its keys'
    diagonal tile and visits no tile that holds no pair of the band."""
    band = band_mask(t, window, "cpu").numpy()  # [query, key]
    visits = np.zeros_like(band, dtype=int)
    for s0 in range(0, t, WARP_KEYS):
        keys = slice(s0, min(s0 + WARP_KEYS, t))
        tiles = tattn_key_tiles(s0, WARP_KEYS, t, window)
        starts = [t0 for t0, _ in tiles]
        assert starts == list(range(s0, starts[-1] + 1, QUERY_TILE))
        for t0, masked in tiles:
            pairs = band[t0:t0 + QUERY_TILE, keys]
            assert pairs.any(), (s0, t0)
            assert masked == (not pairs.all()), (s0, t0)
            visits[t0:t0 + QUERY_TILE, keys] += 1
    assert (visits[band] == 1).all()


@pytest.mark.parametrize("window,most", [(126, 1.30), (None, 1.10)])
def test_key_walk_at_config_5b(window, most):
    """At T = 626 (10 s at hop 256), counting every lane of every visited
    tile (32 keys x 32 queries), the warps of a row compute at most `most`
    times the band's pairs; an interior warp at window 126 computes 1.27x and
    masks 3 of its 5 tiles (the diagonal and the two at the window's edge)."""
    t = 626
    band = band_mask(t, window, "cpu").numpy()
    computed = sum(WARP_KEYS * QUERY_TILE * len(tattn_key_tiles(s0, WARP_KEYS, t, window))
                   for s0 in range(0, t, WARP_KEYS))
    assert computed / band.sum() <= most
    if window is not None:
        tiles = tattn_key_tiles(320, WARP_KEYS, t, window)
        assert [masked for _, masked in tiles] == [True, False, False, True, True]
        assert round(len(tiles) * WARP_KEYS * QUERY_TILE / band[:, 320:352].sum(), 2) == 1.27
