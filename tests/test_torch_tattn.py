"""Port parity: cruse_tpu_torch's temporal attention (the kernel's plain
version and its CPU wrapper) and ``AxialSelfAttention`` against cruse_tpu,
on the CPU.

The JAX flash kernel runs in interpret mode, as tests/test_asa_kernel.py
runs it. Tolerance 1e-5 max-abs: float32 softmax attention summed in another
order. The reference's flash path applies the causal mask even when the
ASA is non-causal; the port does not, which ``test_non_causal_asa_is_not_causal``
pins. The forward kernel's walk (``tattn_band_tiles``: which key tiles a warp
visits and which carry the mask; ``tattn_online_reference``: the base-2
online softmax over them, with the logsumexp) is held against the JAX
forward and its residual logsumexp. The timing scripts' trace filter
(``marked_kernels``: the kernels between two runs of marker kernels, in the
device's order) is checked on made-up traces.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.models.mtfaa import AxialSelfAttention as JaxASA
from cruse_tpu.ops.asa_kernel import _fwd_impl as jax_fwd_impl
from cruse_tpu.ops.asa_kernel import flash_tattn_tm as jax_flash_tattn_tm
from cruse_tpu.ops.asa_kernel import xla_tattn_tm

from cruse_tpu_torch.models.mtfaa import AxialSelfAttention
from cruse_tpu_torch.ops.asa_kernel import (
    KEY_TILE, WARP_QUERIES, band_mask, flash_tattn_tm, tattn_band_tiles, tattn_online_reference,
    tattn_reference)
from cruse_tpu_torch.ops.tfcm_bwd_timing import marked_kernels
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


WALK_CASES = CASES + [  # BF, c, C, T, window, causal
    (1, 6, 24, 1, None, True),  # one frame
    (2, 6, 24, 31, None, True),  # T inside one key tile
    (2, 8, 32, 33, 7, True),  # one key past a tile
    (2, 8, 32, 100, 1, True),  # window 1: each query sees itself
    (2, 6, 24, 70, 200, True),  # window >= T
    (2, 3, 12, 45, 9, True),  # c = 3, C = 12
    (2, 6, 24, 100, None, False),  # non-causal
    (1, 6, 24, 33, None, False),  # non-causal, a ragged last tile of one key
]


@pytest.mark.parametrize("bf,c,cv,t,w,causal", [case if len(case) == 6 else (*case, True)
                                                for case in WALK_CASES])
def test_online_walk_matches_jax(bf, c, cv, t, w, causal):
    """(out, lse) of the kernel's walk, in warps of 32 and 64 queries, against
    JAX: the flash kernel (interpret) and xla_tattn_tm, and the flash forward's
    residual logsumexp [BF, 1, T rounded up to 128]; non-causal against the
    same softmax over every key in jnp."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((bf, c, t), (bf, c, t), (bf, cv, t)))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if causal:
        out, (*_, lse) = jax_fwd_impl(jq, jk, jv, w, True)
        wants = [np.asarray(out), np.asarray(xla_tattn_tm(jq, jk, jv, w))]
        want_lse = np.asarray(lse)[:, 0, :t]
    else:
        logits = jnp.einsum("bct,bcs->bts", jq, jk) / (c ** 0.5)
        wants = [np.asarray(jnp.einsum("bts,bcs->bct", jax.nn.softmax(logits, axis=-1), jv))]
        want_lse = np.asarray(jax.scipy.special.logsumexp(logits, axis=-1))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    for queries_per_warp in (WARP_QUERIES, 2 * WARP_QUERIES):
        got, got_lse = tattn_online_reference(qt, kt, vt, w, causal, queries_per_warp)
        for want in wants:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5)


@pytest.mark.parametrize("window,queries,ratio", [
    (126, WARP_QUERIES, 1.27), (126, 2 * WARP_QUERIES, 1.52), (None, WARP_QUERIES, 1.05),
    (None, 2 * WARP_QUERIES, 1.10)])
def test_band_walk_at_config_5b(window, queries, ratio):
    """At T = 626 (10 s at hop 256), for warps of `queries` queries: the
    tiles cover the warp's band and touch nothing outside it; an unmasked
    tile lies inside every live query's band; and the pairs computed (32 keys
    of each tile for each live query) are the expected multiple of the band's
    pairs. The kernel's warp of 32 computes 1.27x at window 126; 64 queries a
    warp (2 a thread) would compute 1.52x; a block of 128 queries over the
    same tiles computed 2.03x at window 126 and 1.21x without."""
    t = 626
    band = band_mask(t, window, "cpu").numpy()
    computed = 0
    for q0 in range(0, t, queries):
        live = band[q0:q0 + queries]  # [live queries, keys]
        tiles = tattn_band_tiles(q0, queries, t, window)
        starts = [s0 for s0, _ in tiles]
        assert starts == list(range(starts[0], starts[-1] + 1, KEY_TILE))
        seen = np.zeros(t, dtype=bool)
        for s0, masked in tiles:
            keys = live[:, s0:s0 + KEY_TILE]
            assert keys.any(), (q0, s0)  # no tile outside the band
            assert masked or (keys.all() and s0 + KEY_TILE <= t), (q0, s0)
            seen[s0:s0 + KEY_TILE] = True
        assert not (live & ~seen[None, :]).any(), q0  # every key of the band is visited
        computed += KEY_TILE * len(tiles) * live.shape[0]
    assert round(computed / band.sum(), 2) == ratio


def test_non_causal_walk_visits_every_tile():
    t = 100
    tiles = tattn_band_tiles(64, WARP_QUERIES, t, window=7, causal=False)
    assert tiles == [(0, False), (32, False), (64, False), (96, True)]  # the window is unused
    assert tattn_band_tiles(0, WARP_QUERIES, 64, causal=False) == [(0, False), (32, False)]
    assert tattn_band_tiles(96, WARP_QUERIES, t, causal=True) == [(0, False), (32, False), (64, False),
                                                                  (96, True)]


def trace_kernels(names, start=0.0):
    return [{"cat": "kernel", "name": name, "ts": start + i, "dur": 0.5} for i, name in enumerate(names)]


CALLS = ["void tattn_fwd_kernel<6, 24>(Params)"] * 4
SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"


@pytest.mark.parametrize("events,want", [
    (trace_kernels([SPIN] * 3 + CALLS + [SPIN] * 3), 4),  # a whole trace
    (trace_kernels([SPIN] * 3 + CALLS + [SPIN]), 4),  # it lost its last two events
    (trace_kernels([SPIN] + CALLS + [SPIN] * 3), 4),  # it lost its first two events
    (trace_kernels([SPIN] * 3 + CALLS[:3] + [SPIN] * 3, start=-50.0)  # an earlier trace's kernels, then this one's
     + trace_kernels([SPIN] * 3 + CALLS + [SPIN] * 3)[::-1], 4),  # in any order
    (trace_kernels([SPIN] * 3 + CALLS), None),  # it lost every closing marker
    (trace_kernels(CALLS), None),  # no marker
    ([{"cat": "cpu_op", "name": SPIN, "ts": 0.0, "dur": 1.0}] + trace_kernels(CALLS + [SPIN]), None),  # host ops
])
def test_traced_calls_lie_between_device_markers(events, want):
    kernels = marked_kernels(events)
    if want is None:
        assert kernels is None
    else:
        assert [e["name"] for e in kernels] == CALLS[:want]
        assert all(e["ts"] >= 0 for e in kernels)


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
    with pytest.raises(ValueError, match="streaming attention needs a finite window"):
        AxialSelfAttention(8).carry(torch.zeros(1, 2, 8, 5), state=(None, None, None))
