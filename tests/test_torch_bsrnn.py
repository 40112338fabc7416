"""Port parity: cruse_tpu_torch's BSRNN and its LSTM against cruse_tpu, on the
CPU at small widths (``configs/tiny_bsrnn.toml``'s ``num_channel = 8``,
``num_layer = 1``, and ``num_layer = 2``), offline and causal.

The port's seeded weights cross the bridge to a flax tree (whose structure
and shapes are checked against the JAX model's own ``init``) and both
packages run on it. Each JAX model is jitted once, on one input, in a module
fixture. Tolerances: the LSTM 1e-5, BSRNN and its parts 1e-5, the tolerance
of tests/test_mtfaa_bsrnn.py; a causal model's chunked calls against its
full call 1e-5; the int8 route exact (the same codes and scales).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruse_tpu.models import bsrnn as jb
from cruse_tpu.nn.lstm import LSTM as JaxLSTM
from cruse_tpu.nn.quantize import dequantize_tree, quantize_tree

from cruse_tpu_torch.models import BSRNN, BsrnnConfig, build_from_config
from cruse_tpu_torch.models.bsrnn import BAND_WIDTHS, BandSplit, MaskDecoder, apply_three_tap_mask
from cruse_tpu_torch.nn.lstm import LSTM, lstm_scan
from cruse_tpu_torch.nn.quantize import SCALE_KEY, dequantize_state_dict, int8_state_dict, load_int8_for_serving
from cruse_tpu_torch.utils.config import load_config
from cruse_tpu_torch.utils.weights import flax_from_state_dict, flax_param_paths, state_dict_from_flax

ROOT = Path(__file__).resolve().parent.parent
N = 8  # configs/tiny_bsrnn.toml's num_channel
T = 7
VARIANTS = [(False, 1), (True, 1), (False, 2), (True, 2)]
IDS = ["offline-1", "causal-1", "offline-2", "causal-2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spectrum(rng, b, t):
    return (rng.standard_normal((b, t, 257)) + 1j * rng.standard_normal((b, t, 257))).astype(np.complex64)


def make_pair(causal: bool, layers: int, seed: int = 0):
    """(the JAX model, the flax variables, the port's model): the port's
    seeded weights carried to a flax tree by the bridge."""
    model = BSRNN(BsrnnConfig(N, layers, causal), generator=torch.Generator().manual_seed(seed)).eval()
    return jb.BSRNN(num_channel=N, num_layer=layers, causal=causal), flax_from_state_dict(model), model


@pytest.fixture(scope="module")
def models():
    """Each variant's pair and the JAX model's output on one spectrum,
    computed once."""
    rng = np.random.default_rng(11)
    spec = spectrum(rng, 2, T)
    made = {}
    for i, (causal, layers) in enumerate(VARIANTS):
        jax_model, variables, model = make_pair(causal, layers, seed=i)
        ref, ref_state = jax.jit(jax_model.apply)({"params": variables["params"]}, jnp.asarray(spec))
        made[(causal, layers)] = dict(jax_model=jax_model, variables=variables, model=model, ref=np.asarray(ref),
                                      ref_state=jax.tree_util.tree_map(np.asarray, ref_state))
    return spec, made


# ---------------- the LSTM ----------------


def jax_lstm_params(lstm: LSTM) -> dict:
    names = ("w_ih", "w_hh", "b_ih", "b_hh")
    return {name + sfx: lstm.weights(d)[j].detach().numpy()
            for d, sfx in enumerate(("", "_reverse")[: lstm.dirs]) for j, name in enumerate(names)}


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "state"])
def test_lstm_matches_jax(rng, bidirectional, with_state):
    lstm = LSTM(5, 6, bidirectional=bidirectional)
    lstm.reset_parameters(torch.Generator().manual_seed(1))
    dirs = 2 if bidirectional else 1
    x = rng.standard_normal((3, 9, 5)).astype(np.float32)
    state = tuple(rng.standard_normal((3, dirs, 6)).astype(np.float32) for _ in range(2)) if with_state else None
    ref, (rh, rc) = JaxLSTM(6, bidirectional=bidirectional).apply(
        {"params": jax_lstm_params(lstm)}, jnp.asarray(x), None if state is None else tuple(map(jnp.asarray, state)))
    with torch.no_grad():
        y, (h, c) = lstm(torch.from_numpy(x), None if state is None else tuple(map(torch.from_numpy, state)))
    assert y.shape == (3, 9, 6 * dirs) and h.shape == c.shape == (3, dirs, 6)
    for ours, theirs in ((y, ref), (h, rh), (c, rc)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
def test_lstm_module_matches_the_plain_scan(rng, bidirectional):
    """nn.LSTM's path against ``lstm_scan`` on the same weights (the module's
    ``plain`` flag), and ``lstm_scan`` against its definition at one step."""
    lstm = LSTM(4, 5, bidirectional=bidirectional)
    lstm.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.from_numpy(rng.standard_normal((2, 6, 4)).astype(np.float32))
    state = tuple(torch.from_numpy(rng.standard_normal((2, lstm.dirs, 5)).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        fast = lstm(x, state)
        lstm.plain = True
        plain = lstm(x, state)
    for a, b in zip(torch.utils._pytree.tree_leaves(fast), torch.utils._pytree.tree_leaves(plain)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    w_ih, w_hh, b_ih, b_hh = (w.detach() for w in lstm.weights(0))
    _, (h, c) = lstm_scan((x @ w_ih.T + b_ih)[:, :1], state[0][:, 0], state[1][:, 0], w_hh, b_hh)
    i, f, g, o = (x[:, 0] @ w_ih.T + b_ih + state[0][:, 0] @ w_hh.T + b_hh).chunk(4, dim=-1)
    want_c = torch.sigmoid(f) * state[1][:, 0] + torch.sigmoid(i) * torch.tanh(g)
    torch.testing.assert_close(c, want_c)
    torch.testing.assert_close(h, torch.sigmoid(o) * torch.tanh(want_c))


# ---------------- the pieces ----------------


@pytest.fixture(scope="module")
def pieces():
    """BandSplit and MaskDecoder, offline and causal, each against JAX in one
    jitted call (with a carry for the causal ones)."""
    rng = np.random.default_rng(5)
    x_ri = rng.standard_normal((2, T, 257, 2)).astype(np.float32)
    z = rng.standard_normal((2, T, len(BAND_WIDTHS), N)).astype(np.float32)
    carries = tuple((np.float32(rng.uniform(0, 3)) * np.ones(2, np.float32),
                     np.float32(rng.uniform(3, 9)) * np.ones(2, np.float32), np.full(2, 40.0, np.float32))
                    for _ in BAND_WIDTHS)
    gen = torch.Generator().manual_seed(9)
    made, params = {}, {}
    for causal in (False, True):
        for name, cls in (("split", BandSplit), ("dec", MaskDecoder)):
            module = cls(N, causal, gen)
            with torch.no_grad():  # a non-trivial affine
                for p in module.parameters():
                    if p.dim() == 1 and not p.any():
                        p.normal_(0, 0.1, generator=gen)
            made[(name, causal)] = module
            params[(name, causal)] = flax_from_state_dict(BSRNN(BsrnnConfig(N, 1)), {
                f"band_split.{k}" if name == "split" else f"mask_decoder.{k}": v
                for k, v in module.state_dict().items()})["params"]["band_split" if name == "split" else "mask_decoder"]

    def run(params, x_ri, z, carries):
        out = {}
        for causal in (False, True):
            c = carries if causal else None
            out[("split", causal)] = jb.BandSplit(N, causal=causal).apply({"params": params[("split", causal)]},
                                                                         x_ri, c)
            out[("dec", causal)] = jb.MaskDecoder(N, causal=causal).apply({"params": params[("dec", causal)]},
                                                                         z, c)
        return out

    refs = jax.tree_util.tree_map(np.asarray, jax.jit(run)(params, x_ri, z, carries))
    return dict(x_ri=x_ri, z=z, carries=carries, made=made, refs=refs)


@pytest.mark.parametrize("causal", [False, True], ids=["offline", "causal"])
@pytest.mark.parametrize("name", ["split", "dec"], ids=["BandSplit", "MaskDecoder"])
def test_band_split_and_mask_decoder_match_jax(pieces, name, causal):
    module = pieces["made"][(name, causal)]
    x = pieces["x_ri"] if name == "split" else pieces["z"]
    carries = tuple(tuple(map(torch.from_numpy, c)) for c in pieces["carries"]) if causal else None
    with torch.no_grad():
        out, new = module(torch.from_numpy(x), carries)
    ref, ref_new = pieces["refs"][(name, causal)]
    want_shape = (2, T, len(BAND_WIDTHS), N) if name == "split" else (2, T, 257, 3, 2)
    assert out.shape == want_shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    if causal:
        for ours, theirs in zip(torch.utils._pytree.tree_leaves(new), jax.tree_util.tree_leaves(ref_new)):
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5)
    else:
        assert new == () and ref_new is None


def test_three_tap_mask_matches_jax_at_the_edges(rng):
    """The first bin takes no x[f-1] tap and the last no x[f+1]: with every
    other tap zero, only the edge taps that exist move the edge bins."""
    spec = spectrum(rng, 2, 3)
    m = rng.standard_normal((2, 3, 257, 3, 2)).astype(np.float32)
    x_ri = np.stack([spec.real, spec.imag], axis=-1)
    ref = np.asarray(jb.apply_three_tap_mask(jnp.asarray(spec), jnp.asarray(m)))
    ours = apply_three_tap_mask(torch.from_numpy(x_ri), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(ours[..., 0] + 1j * ours[..., 1], ref, atol=1e-5)
    edge = np.zeros_like(m)
    edge[:, :, 0, 2, 0] = edge[:, :, -1, 0, 0] = 1.0  # 1 + 0j: x[1] into bin 0, x[F-2] into bin F-1
    out = apply_three_tap_mask(torch.from_numpy(x_ri), torch.from_numpy(edge)).numpy()
    np.testing.assert_array_equal(out[:, :, 0], x_ri[:, :, 1])
    np.testing.assert_array_equal(out[:, :, -1], x_ri[:, :, -2])
    assert not out[:, :, 1:-1].any()


# ---------------- the model ----------------


@pytest.mark.parametrize("causal,layers", VARIANTS, ids=IDS)
def test_bsrnn_matches_jax(models, causal, layers):
    """The complex spectrum in, the enhanced one out, within 1e-5; the
    causal model's new state (every norm's carry, every time LSTM's (h, c))
    too; the RI input gives the same output."""
    spec, made = models
    m = made[(causal, layers)]
    with torch.no_grad():
        out, state = m["model"](torch.from_numpy(spec))
        ri_out, _ = m["model"](torch.from_numpy(np.stack([spec.real, spec.imag], axis=-1)))
    assert out.shape == m["ref"].shape == spec.shape and out.dtype == torch.complex64
    np.testing.assert_allclose(out.numpy(), m["ref"], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ri_out, out, atol=0, rtol=0)
    if causal:
        assert state.keys() == m["ref_state"].keys()
        assert len(torch.utils._pytree.tree_leaves(state)) == 3 * (2 * len(BAND_WIDTHS) + 2 * layers) + 2 * layers
        for key in state:
            for a, b in zip(torch.utils._pytree.tree_leaves(state[key]),
                            jax.tree_util.tree_leaves(m["ref_state"][key])):
                assert a.shape == b.shape, key
                np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5, err_msg=key)
    else:
        assert state is None and m["ref_state"] is None


@pytest.mark.parametrize("causal", [False, True], ids=["offline", "causal"])
def test_bridge_tree_is_the_jax_models_own(models, causal):
    """The port's weights bridged to flax have the JAX init's structure and
    shapes, and come back through ``state_dict_from_flax`` bit for bit under
    ``strict=True``; an LSTM's flax leaf keeps torch's layout."""
    spec, made = models
    m = made[(causal, 2)]
    shapes = jax.eval_shape(m["jax_model"].init, jax.random.PRNGKey(0), jnp.asarray(spec))["params"]
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(m["variables"]["params"])
    for a, b in zip(jax.tree_util.tree_leaves(shapes), jax.tree_util.tree_leaves(m["variables"]["params"])):
        assert a.shape == b.shape
    model = BSRNN(BsrnnConfig(N, 2, causal), generator=torch.Generator().manual_seed(99))
    model.load_state_dict(state_dict_from_flax(m["variables"], model), strict=True)
    for key, value in m["model"].state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    assert m["variables"]["params"]["lstm_k_1"]["w_ih_reverse"].shape == (4 * 2 * N, N)
    paths = flax_param_paths(model)
    assert paths["lstm_t_0.rnn.weight_hh_l0"] == ("lstm_t_0/w_hh", 2)
    assert paths["band_split.fc_3.weight"] == ("band_split/fc_3/kernel", 2)
    assert paths["mask_decoder.norm_30.scale"] == ("mask_decoder/norm_30/scale", 1)


def test_int8_route_matches_jax(models):
    """``int8_state_dict`` holds the JAX rule's codes and scales: dequantized,
    each entry equals the JAX dequantized tree bridged; an LSTM leaf's scales
    run along its last axis (the input, torch's last axis too), a Dense
    kernel's along the Linear's output rows. ``load_int8_for_serving`` loads
    them strictly."""
    _, made = models
    m = made[(True, 1)]
    state, report = int8_state_dict(m["model"], m["variables"], min_size=64)
    want = state_dict_from_flax({"params": dequantize_tree(quantize_tree(m["variables"]["params"], min_size=64))},
                                m["model"])
    got = dequantize_state_dict(state)
    assert got.keys() == want.keys() and report["leaves_quantized"] > 60
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert state["lstm_t_0.rnn.weight_ih_l0"][SCALE_KEY].shape == (1, N)
    assert state["lstm_t_0.rnn.weight_hh_l0"][SCALE_KEY].shape == (1, 2 * N)
    assert state["mask_decoder.fc1_0.weight"][SCALE_KEY].shape == (4 * N, 1)
    model = BSRNN(BsrnnConfig(N, 1, True))
    assert "int8 weights" in load_int8_for_serving(model)
    assert isinstance(model.lstm_t_0.rnn.weight_ih_l0, torch.nn.Parameter)


def test_causal_chunks_continue_the_full_call(rng):
    """Ragged chunks (T = 3, 1, 4) threading the state equal one call on all
    8 frames; a chunk's output does not depend on later frames."""
    model = BSRNN(BsrnnConfig(N, 2, True), generator=torch.Generator().manual_seed(4)).eval()
    spec = torch.from_numpy(spectrum(rng, 2, 8))
    with torch.no_grad():
        full, full_state = model(spec)
        state, outs, start = model.init_state(2), [], 0
        for t in (3, 1, 4):
            out, state = model(spec[:, start : start + t], state)
            outs.append(out)
            start += t
        torch.testing.assert_close(torch.cat(outs, dim=1), full, atol=1e-5, rtol=1e-5)
        for a, b in zip(torch.utils._pytree.tree_leaves(state), torch.utils._pytree.tree_leaves(full_state)):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        changed = spec.clone()
        changed[:, 5:] *= 3.0
        moved, _ = model(changed)
    torch.testing.assert_close(moved[:, :5], full[:, :5], atol=1e-6, rtol=1e-6)
    assert not torch.allclose(moved[:, 5:], full[:, 5:])


def test_init_state_is_the_jax_layout():
    model = BSRNN(BsrnnConfig(N, 2, True))
    ours = model.init_state(3)
    theirs = jb.BSRNN(num_channel=N, num_layer=2, causal=True).init_state(3)
    assert jax.tree_util.tree_structure(theirs) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, ours))
    for key in ours:
        for a, b in zip(torch.utils._pytree.tree_leaves(ours[key]), jax.tree_util.tree_leaves(theirs[key])):
            assert tuple(a.shape) == b.shape and not a.any(), key
    assert ours["time_lstm"][0][0].shape == (3 * 31, 1, 2 * N)
    with pytest.raises(ValueError, match="causal"):
        BSRNN(BsrnnConfig(N, 1)).init_state(1)


def test_bsrnn_refuses_other_bins_and_a_gradient_in_eval_mode(rng):
    model = BSRNN(BsrnnConfig(N, 1)).eval()
    with pytest.raises(ValueError, match="257"):
        model(torch.zeros(1, 2, 161, dtype=torch.complex64))
    with pytest.raises(ValueError, match="training mode"):
        model(torch.from_numpy(spectrum(rng, 1, 2)), None, True)


@pytest.mark.parametrize("name", ["tiny_bsrnn.toml", "tiny_bsrnn_causal.toml"])
def test_build_from_config_builds_the_tiny_configs(name):
    config = load_config(str(ROOT / "configs" / name))
    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(0))
    assert isinstance(model, BSRNN)
    assert model.config == BsrnnConfig(num_channel=8, num_layer=1, causal=name == "tiny_bsrnn_causal.toml")
    assert BSRNN().config == BsrnnConfig(num_channel=128, num_layer=6, causal=False)
