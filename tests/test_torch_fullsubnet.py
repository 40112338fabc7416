"""Port parity: cruse_tpu_torch's FullSubNet pieces against cruse_tpu, on the
CPU: the input norms, the sub-band ops, ``drop_band``, the cIRM helpers, the
plain GRU, the model with both norm kinds and with and without look-ahead,
the weight bridge both ways, and the GRU kernels' plans and grid limit at
FullSubNet's shapes.

Inputs are seeded with numpy, weights made by flax and carried across by the
bridge. Tolerances: the norms 1e-6 relative or absolute on outputs of order
one (the same float32 formulas; ``torch.cumsum`` adds in another order than
XLA, and the cumulative layer norm's variance is a difference of running
sums), the index ops exactly, the
GRU and the model (outputs and state) 1e-5, chunked against whole calls 1e-6
(the port's own cumulative sums, restarted at a chunk's edge).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.dsp import features as jfeatures
from cruse_tpu.dsp import mask as jmask
from cruse_tpu.models import fullsubnet as jf
from cruse_tpu.nn import gru as jgru
from cruse_tpu.nn import norms as jnorms
from cruse_tpu.nn import subband as jsubband

from cruse_tpu_torch.dsp.features import drop_band
from cruse_tpu_torch.dsp.mask import complex_mul, compress_cirm, decompress_cirm
from cruse_tpu_torch.models import FullSubNet, FullSubNetConfig, build_from_config
from cruse_tpu_torch.nn import norms
from cruse_tpu_torch.nn.gru import GRU
from cruse_tpu_torch.nn.subband import _reflect_indices, freq_unfold, reduce_complexity_separately
from cruse_tpu_torch.ops import gru_kernel
from cruse_tpu_torch.utils.weights import (flax_from_state_dict, flax_param_paths, jax_keystr,
                                           state_dict_from_flax)

# unequal B, T and F, so that a wrong permute of the sub-band units cannot pass
SMALL = dict(num_freqs=33, num_neighbors=3, fb_hidden=16, fb_layers=2, sb_hidden=8, sb_layers=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def positive(rng, *shape):
    return (np.abs(rng.standard_normal(shape)) + 0.05).astype(np.float32)


def make_fullsubnet_pair(rng, args: dict, seed: int = 0):
    """A cruse_tpu FullSubNet with flax-initialised variables and the port's
    FullSubNet carrying them."""
    jax_model = jf.FullSubNet(jf.FullSubNetConfig(**args))
    mag = jnp.ones((1, 4, args["num_freqs"]), jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jax_model.init)(jax.random.PRNGKey(seed), mag))
    model = FullSubNet(FullSubNetConfig(**args)).eval()
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return jax_model, variables, model


def close(ours, theirs, **tol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), **tol)


# ---------------- the norms ----------------


@pytest.mark.parametrize("name", sorted(norms.NORM_REGISTRY))
def test_every_registered_norm_matches_jax(rng, name):
    x = positive(rng, 2, 3, 9, 7)  # [B, C, T, F]
    extra = {"sample_length": 4} if "forgetting" in name else {}
    ours = norms.NORM_REGISTRY[name](torch.from_numpy(x), **extra)
    theirs = jnorms.NORM_REGISTRY[name](jnp.asarray(x), **extra)
    assert ours.dtype == torch.float32
    close(ours, theirs, rtol=1e-6, atol=1e-6)


def test_hybrid_norm_after_its_warm_up_matches_jax(rng):
    x = positive(rng, 2, 12, 5)
    close(norms.hybrid_norm(torch.from_numpy(x), sample_length=5),
          jnorms.hybrid_norm(jnp.asarray(x), sample_length=5), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("carry_fn,whole_fn", [
    ("cumulative_laplace_norm_carry", "cumulative_laplace_norm"),
    ("cumulative_layer_norm_carry", "cumulative_layer_norm")], ids=["laplace", "layer"])
def test_carried_norms_match_jax_and_their_whole_calls(rng, carry_fn, whole_fn):
    """Against JAX with and without a carry in; the port's chunked calls
    against its own whole call; the count stays float32, as in JAX."""
    x = positive(rng, 3, 11, 6)
    carry_in = tuple(positive(rng, 3) * (i + 1) for i in range(len(getattr(jnorms, carry_fn)(jnp.asarray(x))[1])))
    for carry in (None, carry_in):
        y, new = getattr(norms, carry_fn)(torch.from_numpy(x), None if carry is None else
                                          tuple(torch.from_numpy(c) for c in carry))
        jy, jnew = getattr(jnorms, carry_fn)(jnp.asarray(x), None if carry is None else
                                             tuple(jnp.asarray(c) for c in carry))
        close(y, jy, rtol=1e-6, atol=1e-6)
        for a, b in zip(new, jnew):
            assert a.dtype == torch.float32 and a.shape == b.shape
            close(a, b, rtol=1e-6)
    whole = getattr(norms, whole_fn)(torch.from_numpy(x))
    first, carry = getattr(norms, carry_fn)(torch.from_numpy(x[:, :4]))
    second, carry = getattr(norms, carry_fn)(torch.from_numpy(x[:, 4:5]), carry)
    third, carry = getattr(norms, carry_fn)(torch.from_numpy(x[:, 5:]), carry)
    close(torch.cat([first, second, third], dim=1), whole, rtol=1e-6, atol=1e-6)
    assert float(carry[-1][0]) == 11 * 6


def test_exponential_unit_norm_and_alpha_match_jax(rng):
    mag = positive(rng, 2, 8, 5)
    alpha = norms.get_norm_alpha(16000, 160, 1.0)
    assert alpha == jnorms.get_norm_alpha(16000, 160, 1.0)
    y, s = norms.exponential_unit_norm(torch.from_numpy(mag), alpha)
    jy, js = jnorms.exponential_unit_norm(jnp.asarray(mag), alpha)
    close(y, jy, rtol=1e-6)
    close(s, js, rtol=1e-6)
    state = positive(rng, 2, 5)
    y, s = norms.exponential_unit_norm(torch.from_numpy(mag[:, 3:]), 0.9, torch.from_numpy(state))
    jy, js = jnorms.exponential_unit_norm(jnp.asarray(mag[:, 3:]), 0.9, jnp.asarray(state))
    close(y, jy, rtol=1e-6)
    close(s, js, rtol=1e-6)


def test_norm_wrapper_refuses_an_unknown_name():
    assert norms.norm_wrapper("hybrid_norm") is norms.hybrid_norm
    with pytest.raises(NotImplementedError, match="unknown norm 'layer_norm'") as ours:
        norms.norm_wrapper("layer_norm")
    with pytest.raises(NotImplementedError) as theirs:
        jnorms.norm_wrapper("layer_norm")
    assert str(ours.value) == str(theirs.value)


# ---------------- the sub-band ops ----------------


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 9, 12], ids=lambda n: f"n{n}")
def test_freq_unfold_matches_jax_exactly(rng, n):
    """Edges at every width, n >= F / 2 (9 of F = 17) and n >= F (12 of F = 9)
    included: the table reflects once at each edge, as JAX's does."""
    for f in (17, 9):
        x = rng.standard_normal((2, 5, f)).astype(np.float32)
        ours = freq_unfold(torch.from_numpy(x), n)
        theirs = np.asarray(jsubband.freq_unfold(jnp.asarray(x), n))
        assert ours.shape == theirs.shape
        np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(_reflect_indices(5, 2)[[0, 4]], [[2, 1, 0, 1, 2], [2, 3, 4, 3, 2]])


def test_reduce_complexity_separately_matches_jax(rng):
    sub = rng.standard_normal((6, 4, 17, 5)).astype(np.float32)
    full = rng.standard_normal((6, 4, 17, 1)).astype(np.float32)
    ours = reduce_complexity_separately(torch.from_numpy(sub), torch.from_numpy(full))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(
        jsubband.reduce_complexity_separately(jnp.asarray(sub), jnp.asarray(full))))
    with pytest.raises(ValueError, match="3 groups"):
        reduce_complexity_separately(torch.from_numpy(sub[:4]), torch.from_numpy(full[:4]))


@pytest.mark.parametrize("groups,b,f", [(2, 5, 16), (2, 4, 17), (3, 7, 20), (1, 3, 8)],
                         ids=["even", "odd_bins", "three", "one"])
def test_drop_band_matches_jax_exactly(rng, groups, b, f):
    x = rng.standard_normal((b, 2, f, 6)).astype(np.float32)  # [B, C, F, T]
    ours = drop_band(torch.from_numpy(x), groups)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jfeatures.drop_band(jnp.asarray(x), groups)))
    with pytest.raises(ValueError, match="exceed"):
        drop_band(torch.from_numpy(x[:groups]), groups)


def test_cirm_helpers_match_jax(rng):
    m = (rng.standard_normal((3, 5, 2)) * 6).astype(np.float32)
    m[0, 0] = (-9.95, 12.0)  # past the clamp
    close(decompress_cirm(torch.from_numpy(m)), jmask.decompress_cirm(jnp.asarray(m)), rtol=1e-6, atol=1e-6)
    inside = np.clip(m, -9, 9)
    close(compress_cirm(decompress_cirm(torch.from_numpy(inside))), inside, rtol=1e-4, atol=1e-4)
    a, b, c, d = (rng.standard_normal((4, 7)).astype(np.float32) for _ in range(4))
    for ours, theirs in zip(complex_mul(*map(torch.from_numpy, (a, b, c, d))),
                            jmask.complex_mul(*map(jnp.asarray, (a, b, c, d)))):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


# ---------------- the GRU and the model ----------------


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "state"])
def test_plain_gru_matches_jax(rng, with_h0):
    x = rng.standard_normal((3, 11, 6)).astype(np.float32)
    h0 = rng.standard_normal((3, 10)).astype(np.float32) if with_h0 else None
    jax_gru = jgru.GRU(10)
    variables = jax_gru.init(jax.random.PRNGKey(1), jnp.asarray(x))
    assert set(variables["params"]) == {"layer"}
    gru = GRU(6, 10)
    gru.load_state_dict({f"layer.{k}": torch.from_numpy(np.array(v))
                         for k, v in variables["params"]["layer"].items()}, strict=True)
    jy, jh = jax_gru.apply(variables, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    with torch.no_grad():
        y, h = gru(torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    assert y.shape == (3, 11, 10) and h.shape == (3, 10)
    close(y, jy, atol=1e-5)
    close(h, jh, atol=1e-5)
    bound = 10 ** -0.5  # the seeded init: uniform in +-1/sqrt(H)
    gru.reset_parameters(torch.Generator().manual_seed(0))
    assert all(0 < float(p.detach().abs().max()) <= bound for p in gru.parameters())


MODEL_CASES = [dict(norm=norm, look_ahead=la) for norm in ("offline_laplace_norm", "cumulative_laplace_norm")
               for la in (0, 2)]


@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda c: f"{c['norm'].split('_')[0]}_la{c['look_ahead']}")
def test_model_matches_jax(rng, case):
    """Outputs and the state a state=None call returns, at unequal B, T, F."""
    jax_model, variables, model = make_fullsubnet_pair(rng, dict(SMALL, **case))
    mag = positive(rng, 3, 20, SMALL["num_freqs"])
    ref, ref_state = jax_model.apply(variables, jnp.asarray(mag))
    with torch.no_grad():
        cirm, state = model(torch.from_numpy(mag))
    assert cirm.shape == (3, 20, SMALL["num_freqs"], 2)
    close(cirm, ref, atol=1e-5)
    assert sorted(state) == sorted(ref_state)
    for key, value in ref_state.items():
        for ours, theirs in zip(jax.tree_util.tree_leaves(state[key]), jax.tree_util.tree_leaves(value)):
            assert tuple(ours.shape) == theirs.shape, key
            close(ours, theirs, rtol=1e-5, atol=1e-5)
    if case["look_ahead"]:
        assert float(cirm[:, -case["look_ahead"]:].abs().max()) == 0.0


@pytest.mark.parametrize("norm", ["offline_gaussian_norm", "cumulative_layer_norm", "hybrid_norm"])
def test_model_takes_the_other_one_argument_norms(rng, norm):
    jax_model, variables, model = make_fullsubnet_pair(rng, dict(SMALL, norm=norm, fb_layers=1, sb_layers=1))
    mag = positive(rng, 2, 9, SMALL["num_freqs"])
    with torch.no_grad():
        cirm, _ = model(torch.from_numpy(mag))
    close(cirm, jax_model.apply(variables, jnp.asarray(mag))[0], atol=1e-5)


def test_chunked_calls_carry_the_cumulative_norm(rng):
    """Three chunks through the carried state against one whole call, and
    init_state's leaves against JAX's."""
    jax_model, variables, model = make_fullsubnet_pair(rng, dict(SMALL, norm="cumulative_laplace_norm"))
    mag = torch.from_numpy(positive(rng, 2, 13, SMALL["num_freqs"]))
    state = model.init_state(2)
    jstate = jax_model.init_state(2)
    assert sorted(state) == sorted(jstate)
    for key in jstate:
        for ours, theirs in zip(jax.tree_util.tree_leaves(state[key]), jax.tree_util.tree_leaves(jstate[key])):
            assert tuple(ours.shape) == theirs.shape and float(ours.abs().max()) == 0.0
    with torch.no_grad():
        whole, _ = model(mag, model.init_state(2))
        outs = []
        for lo, hi in ((0, 5), (5, 6), (6, 13)):
            out, state = model(mag[:, lo:hi], state)
            outs.append(out)
    close(torch.cat(outs, dim=1), whole, atol=1e-6)


def test_model_refuses_another_width_and_builds_from_its_config():
    model = FullSubNet(FullSubNetConfig(**SMALL))
    with pytest.raises(ValueError, match="num_freqs=33"):
        model(torch.zeros(1, 4, 32))
    built = build_from_config({"path": "cruse_tpu.models.fullsubnet.FullSubNetConfig", "args": SMALL},
                              generator=torch.Generator().manual_seed(3))
    assert isinstance(built, FullSubNet) and built.config == FullSubNetConfig(**SMALL)
    assert dataclasses.asdict(FullSubNetConfig()) == dataclasses.asdict(jf.FullSubNetConfig())
    again = build_from_config({"path": "x.FullSubNetConfig", "args": SMALL}, generator=torch.Generator().manual_seed(3))
    for a, b in zip(built.state_dict().values(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_weights_round_trip_and_flax_paths(rng):
    """flax -> torch -> flax gives the same tree bit for bit; every parameter
    names its flax leaf and rank, so freeze patterns and AdamW's mask read
    the JAX tree."""
    _, variables, model = make_fullsubnet_pair(rng, SMALL)
    back = flax_from_state_dict(model)
    assert back["batch_stats"] == {}
    flat = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    want = dict(jax.tree_util.tree_flatten_with_path(variables["params"])[0])
    assert flat.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(flat[key], value)
    paths = flax_param_paths(model)
    assert len(paths) == len(want) == 4 * 4 + 2 * 2
    assert paths["sb_gru_1.layer.w_hh"] == ("sb_gru_1/layer/w_hh", 3)
    assert paths["fb_out.weight"] == ("fb_out/kernel", 2) and paths["sb_out.bias"] == ("sb_out/bias", 1)
    assert jax_keystr(paths["fb_gru_0.layer.b_ih"][0]) == jax.tree_util.keystr(
        next(k for k in want if "fb_gru_0" in jax.tree_util.keystr(k) and "b_ih" in jax.tree_util.keystr(k)))


# ---------------- the GRU kernels at FullSubNet's shapes ----------------


@pytest.mark.parametrize("h", [512, 384], ids=["full_band", "sub_band"])
def test_published_widths_take_the_streamed_kernels(h):
    """The backward: no cluster of up to 8 holds an f32 weight of H = 512 or
    384 with a dhp tile, but 16 blocks hold each (U = 32 and 24, the carry's
    partial sums reduce-scattered), so the full band's rows take route A's
    16-block kernel; the sub band's (its 257 bins folded into the batch)
    would need more waves of the 7 16-block clusters an H100 runs at once than
    the plan allows (2 at T = 1, 8 over more steps), so the row-tiled
    backward takes them, at R = 16 in the step (B = 8 x 257). The forward:
    the full band's rows (B = 16, 8 or 1) take the resident kernel at 16
    blocks x 8 rows; the sub band's take the row-tiled kernel."""
    for b, t in ((16, 626), (8, 188), (1, 1)):
        assert gru_kernel.resident_bwd_plan(b, t, 1, h) == gru_kernel.scatter_fit(h) != None  # noqa: E711
    for b, t in ((16 * 257, 626), (8 * 257, 188), (257, 1)):
        assert gru_kernel.resident_bwd_plan(b, t, 1, h) is None
    assert gru_kernel.bwd_cluster_fit(h) is None and h <= gru_kernel.MAX_HIDDEN
    assert gru_kernel.scatter_fit(h) == ((16, 32, 8, 229392) if h == 512 else (16, 24, 8, 172048))
    assert gru_kernel.bwd_row_tile(8 * 257, 1, h) == 16
    for b, t in ((16, 626), (8, 188), (8, 1), (1, 1)):
        plan = gru_kernel.resident_plan(b, t, 1, h)
        if h == 512:
            assert plan == (16, 32, 229376, 8)
        else:  # a lone 16-row tile of 16 blocks would take it, but FullSubNet's sub band is never that few rows
            assert plan == (16, 24, 159744, 16)
    for b, t in ((16 * 257, 626), (8 * 257, 188), (257, 1)):
        assert gru_kernel.resident_plan(b, t, 1, h) is None


@pytest.mark.parametrize("shape, route, rows, blocks", [
    ((16, 626, 1, 512), "resident", 8, 2 * 16),  # full band offline: 2 clusters of 16 blocks
    ((8, 188, 1, 512), "resident", 8, 16),  # in the train step, and the 8-slot server's hop
    ((8, 1, 1, 512), "resident", 8, 16),
    ((1, 1, 1, 512), "resident", 8, 16),  # the B=1 hop
    ((16 * 257, 626, 1, 384), "rows", 32, 129),  # sub band offline
    ((8 * 257, 188, 1, 384), "rows", 16, 129),  # in the train step
    ((257, 1, 1, 384), "rows", 8, 33),  # the B=1 hop
])
def test_fullsubnet_forward_routes(shape, route, rows, blocks):
    """The plan at FullSubNet's shapes with the H100's co-resident count as
    the default: route A (16 blocks x 8 rows, 229,376 B) for the full band,
    route B with its R and grid for the sub band; config 1 keeps its plan."""
    b, t, g, h = shape
    plan = gru_kernel.resident_plan(*shape)
    if route == "resident":
        assert plan == (16, 32, 229376, 8) and plan.rows == rows
        assert plan.cs * g * gru_kernel.grid_rows(b, plan.rows) == blocks
    else:
        assert plan is None and gru_kernel.row_tile(b, g, h) == rows
        assert g * gru_kernel.grid_rows(b, rows) == blocks
    assert gru_kernel.resident_plan(256, 1001, 4, 176) == (2, 88, 208384, 16)


@pytest.mark.parametrize("clusters, hop, sequence", [(0, 0, 0), (1, 16, 64), (2, 32, 128), (7, 112, 448)])
def test_co_resident_count_decides_route_a(clusters, hop, sequence):
    """The plan takes a cluster of 16 only where the launch's clusters run in
    at most HOP_CLUSTER_WAVES = 2 waves of the count it is given at T = 1,
    MAX_CLUSTER_WAVES = 8 over more steps (8 rows a cluster at H = 512):
    never where the card schedules no 16-block cluster; the plans of
    portable clusters ignore the count."""
    assert (gru_kernel.HOP_CLUSTER_WAVES, gru_kernel.MAX_CLUSTER_WAVES) == (2, 8)
    for b in (1, 8, 16, 24, 32, 64, 112, 120, 128, 448, 456):
        for t, limit in ((1, hop), (188, sequence)):
            want = (16, 32, 229376, 8) if b <= limit else None
            assert gru_kernel.resident_plan(b, t, 1, 512, clusters=clusters) == want, (b, t)
    assert gru_kernel.resident_plan(256, 1001, 4, 176, clusters=clusters) == (2, 88, 208384, 16)


def test_forward_takes_the_planned_route(rng, monkeypatch):
    """_forward_impl on (stand-in) CUDA tensors: the launcher that
    forward_plan names, with the card's count (stood in) where the fit is a
    cluster of 16, and no other."""
    seen = []
    monkeypatch.setattr(gru_kernel, "_runs_plain", lambda x: False)
    monkeypatch.setattr(gru_kernel, "co_resident_clusters", lambda device, h, dtype: seen.append(h) or 1)
    monkeypatch.setattr(gru_kernel, "launch_resident", lambda *a, **k: ("resident",))
    monkeypatch.setattr(gru_kernel, "launch_streamed", lambda *a, **k: ("rows",))
    for (b, h), want in (((16, 512), "resident"), ((17, 512), "rows"), ((3, 384), "resident"),
                         ((33, 384), "rows"), ((5, 176), "resident")):
        x = torch.zeros(b, 1, 1, 3 * h)  # a hop: 2 waves of the one cluster stood in
        args = (x, torch.zeros(b, 1, h), torch.zeros(1, 3 * h, h), torch.zeros(1, 3 * h))
        assert gru_kernel._forward_impl(*args) == (want,)
    assert seen == [512, 512, 384, 384]  # portable clusters ask nothing


def test_grid_limit_of_the_gru_launches():
    """grid_rows: ceil(B / rows a block) along y, rows R for the row-tiled
    forward and backward, the fit's rows for the resident forward and
    backward; past 65,535 blocks a ValueError, as the attention and TFCM
    launchers do."""
    bwd = gru_kernel.bwd_cluster_fit(176)[2]
    assert gru_kernel.cluster_fit(176).rows == 16 and gru_kernel.cluster_fit(512).rows == 8
    assert bwd == gru_kernel.scatter_fit(512)[2] == 8
    assert gru_kernel.grid_rows(16 * 257, 32) == 129
    assert gru_kernel.grid_rows(8 * 257, gru_kernel.bwd_row_tile(8 * 257, 1, 384)) == 129  # route B in the step
    assert gru_kernel.grid_rows(16 * 257, 8) == 514
    for rows in gru_kernel.ROW_TILES:  # the row-tiled kernels' R, both directions
        assert gru_kernel.grid_rows(rows * 65535, rows) == 65535
    assert gru_kernel.grid_rows(bwd * 65535, bwd) == 65535
    for b, rows in ((8 * 65535 + 1, 8), (16 * 65535 + 1, 16), (bwd * 65535 + 1, bwd),
                    (2048 * 257, 8), (32 * 65535 + 1, 32)):
        with pytest.raises(ValueError, match="65535"):
            gru_kernel.grid_rows(b, rows)
    # a pool of 2,048 FullSubNet slots: R = 8 would take as few waves but pass the grid's limit, so R = 16
    r = gru_kernel.bwd_row_tile(2048 * 257, 1, 384)
    assert r == 16 and gru_kernel.grid_rows(2048 * 257, r) == 32896


def test_launchers_check_the_grid_before_they_launch(monkeypatch):
    """Both forward launchers and both backward launchers refuse a batch past
    the grid limit: their tensor checks run on meta tensors (no storage, so
    no kernel could be reached), with the device check patched to pass."""
    b, h = 32 * 65535 + 1, 384  # the row-tiled forward's largest tile, R = 32, at this B; the backward's, 16
    x = torch.empty(b, 1, 1, 3 * h, device="meta")
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda", 0)))
    h0, w, bias = torch.empty(b, 1, h, device="meta"), torch.empty(1, 3 * h, h, device="meta"), \
        torch.empty(1, 3 * h, device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="65535"):
        gru_kernel.launch_streamed(x, h0, w, bias)
    y = torch.empty(b, 1, 1, h, device="meta")
    with pytest.raises(ValueError, match="65535"):
        gru_kernel.launch_gru_bwd_streamed(x, x, y, h0, y, h0, w, x, x, h0)
    h = 176
    b = 16 * 65535 + 1
    x, h0 = torch.empty(b, 1, 4, 3 * h, device="meta"), torch.empty(b, 4, h, device="meta")
    w, bias, y = torch.empty(4, 3 * h, h, device="meta"), torch.empty(4, 3 * h, device="meta"), \
        torch.empty(b, 1, 4, h, device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="65535"):
        gru_kernel.launch_resident(x, h0, w, bias)
    with pytest.raises(ValueError, match="65535"):
        gru_kernel.launch_gru_bwd_resident(x, x, y, h0, y, h0, w, x, x, h0)
