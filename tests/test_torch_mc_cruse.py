"""Port parity: the multi-mic McCruse against cruse_tpu, on the CPU, at
``configs/tiny_mc.toml``'s widths (mic pairs (0, 1), (0, 2), so three mics;
the CRUSE trunk (4, 8, 8, 16) with 4 GRU groups; n_fft 320, hop 160).

Checked: the multi-channel STFT and every directional-feature function
(1e-5 max-abs), an exactly silent frame included; ``McCruseNet`` through the
weight bridge (mask 1e-5) and its int8 route (the JAX rule's codes,
dequantized, against JAX's ``dequantize_tree`` of ``quantize_variables``);
the strategies ``multi_channel_directional`` and ``auto``, the streamed
``run``, a server of 3 slots serving 4 sessions, and the infer and serve CLIs
on 3-channel wavs (waveforms 1e-4); ``multi_channel_mag_to_mag`` through a
stand-in mask model defined here for both packages (no zoo model of either
takes its ``[B, C, T, F]`` magnitudes); the streamed artifact (float32 and
int8) against the eager stream (1e-6) and through ``run_exported``; and the
refusals (the offline export, a wrong mic count).

Inputs are made as ``tests/test_mc_cruse.py`` makes them: a clean signal,
its copies delayed by 3 samples a mic, and independent noise on every mic.
"""
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruse_tpu.dsp import features as jfeat
from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.dsp.stft import istft as jax_istft
from cruse_tpu.dsp.stft import mc_stft as jax_mc_stft
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig
from cruse_tpu.infer.server import StreamingServer as JaxStreamingServer
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer
from cruse_tpu.models.cruse import CruseConfig as JaxCruseConfig
from cruse_tpu.models.mc_cruse import McCruseConfig as JaxMcCruseConfig
from cruse_tpu.models.mc_cruse import McCruseNet as JaxMcCruseNet
from cruse_tpu.nn import quantize as jq
from cruse_tpu.train.step import mc_model_forward as jax_mc_model_forward

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp import features
from cruse_tpu_torch.dsp.stft import StftConfig, istft, mc_stft
from cruse_tpu_torch.infer import artifact as artifact_lib
from cruse_tpu_torch.infer import export as export_lib
from cruse_tpu_torch.infer.__main__ import main as cli_main
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.run_exported import main as run_exported_main
from cruse_tpu_torch.infer.serve import main as serve_main
from cruse_tpu_torch.infer.server import StreamingServer
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import CruseConfig, McCruseConfig, McCruseNet, build_from_config
from cruse_tpu_torch.nn import quantize as tq
from cruse_tpu_torch.train.step import forward_for_model
from cruse_tpu_torch.utils.config import load_config
from cruse_tpu_torch.utils.weights import flax_from_state_dict, save_flax_npz, state_dict_from_flax
from tests.test_torch_artifact import one_torch_thread  # noqa: F401  (autouse, module scope)
from tests.test_torch_streaming import ROOT
from tests.test_torch_tfcm import perturbed

PAIRS = ((0, 1), (0, 2))
MICS = 3
TRUNK = dict(in_freq=161, channels=(4, 8, 8, 16), rnn_groups=4)
STFT = dict(n_fft=320, hop_length=160)
HOP = STFT["hop_length"]
FEATURE_TOL, MASK_TOL, WAV_TOL, EAGER_TOL = 1e-5, 1e-5, 1e-4, 1e-6
SLOTS = 3
# (length in hops, extra samples, feed sizes in hops, cycled); "a" ends first, so "d" reuses its slot
SESSIONS = {"a": (3, 37, (0.5, 2.25, 1.1)), "b": (6, 11, (2.3, 0.08, 1.6, 0.9)),
            "c": (4, 90, (0.0, 1.4, 0.7, 2.0)), "d": (4, 5, (1.25, 0.6))}


def mc_batch(rng, b: int, length: int, mics: int = MICS, delay: int = 3) -> np.ndarray:
    """[B, M, L]: a clean signal, its copies delayed by ``delay`` samples a
    mic, and independent noise on every mic."""
    clean = rng.standard_normal((b, length)).astype(np.float32) * 0.1
    noise = rng.standard_normal((b, mics, length)).astype(np.float32) * 0.1
    return (np.stack([np.roll(clean, i * delay, axis=-1) for i in range(mics)], axis=1) + noise).astype(np.float32)


def make_mc_pair(rng, use_sin_ipd: bool = False):
    """A cruse_tpu McCruseNet with flax-initialised variables (BatchNorm
    statistics, scales and the PReLU slope moved off their defaults) and the
    port's McCruseNet carrying them through the bridge."""
    jax_model = JaxMcCruseNet(JaxMcCruseConfig(mic_pairs=PAIRS, use_sin_ipd=use_sin_ipd,
                                               cruse=JaxCruseConfig(**TRUNK)))
    feats = jnp.zeros((1, 4, jax_model.config.feature_dim), jnp.float32)
    variables = perturbed(jax.jit(jax_model.init)(jax.random.PRNGKey(0), feats), rng)
    model = McCruseNet(McCruseConfig(mic_pairs=PAIRS, use_sin_ipd=use_sin_ipd, cruse=CruseConfig(**TRUNK))).eval()
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return jax_model, variables, model


@pytest.fixture(scope="module")
def pair():
    return make_mc_pair(np.random.default_rng(11))


def ri_of(spec) -> np.ndarray:
    return np.stack([np.real(spec), np.imag(spec)], axis=-1).astype(np.float32)


# ---------------- the DSP ----------------


def test_mc_stft_matches_jax(rng):
    y = mc_batch(rng, 2, 3000)
    ours = mc_stft(torch.from_numpy(y), StftConfig(**STFT))
    ref = np.asarray(jax_mc_stft(jnp.asarray(y), JaxStftConfig(**STFT)))
    assert ours.shape == ref.shape == (2, MICS, 3000 // HOP + 1, 161)
    assert np.abs(ours.numpy() - ref).max() < FEATURE_TOL
    with pytest.raises(ValueError, match=r"\[B, C, L\]"):
        mc_stft(torch.from_numpy(y[0]), StftConfig(**STFT))


@pytest.mark.parametrize("use_sin", [False, True], ids=["cos", "cos_sin"])
def test_feature_functions_match_jax(rng, use_sin):
    ri = ri_of(np.asarray(jax_mc_stft(jnp.asarray(mc_batch(rng, 2, 2400)), JaxStftConfig(**STFT))))
    t_ri = torch.from_numpy(ri)
    mag = np.sqrt(ri[..., 0] ** 2 + ri[..., 1] ** 2 + 1e-8)
    phase = np.arctan2(ri[..., 1], ri[..., 0])
    checks = {
        "log_power_spectrum": (features.log_power_spectrum(torch.from_numpy(mag)),
                               jfeat.log_power_spectrum(jnp.asarray(mag))),
        "channelwise_layer_norm": (features.channelwise_layer_norm(torch.from_numpy(mag), dim=-2),
                                   jfeat.channelwise_layer_norm(jnp.asarray(mag), axis=-2)),
        "ipd_features": (features.ipd_features(torch.from_numpy(phase), PAIRS, use_sin),
                         jfeat.ipd_features(jnp.asarray(phase), PAIRS, use_sin)),
        "directional_features_from_ri": (features.directional_features_from_ri(t_ri, PAIRS, 1, use_sin),
                                         jfeat.directional_features_from_ri(jnp.asarray(ri), PAIRS, 1, use_sin)),
    }
    for name, (ours, ref) in checks.items():
        assert ours.shape == ref.shape, name
        assert np.abs(ours.numpy() - np.asarray(ref)).max() < FEATURE_TOL, name
    scale, bias = rng.uniform(0.5, 1.5, 161).astype(np.float32), rng.standard_normal(161).astype(np.float32)
    ours = features.channelwise_layer_norm(torch.from_numpy(mag), torch.from_numpy(scale), torch.from_numpy(bias))
    assert np.abs(ours.numpy() - np.asarray(jfeat.channelwise_layer_norm(jnp.asarray(mag), scale, bias))).max() \
        < FEATURE_TOL


@pytest.mark.parametrize("stacked", [False, True], ids=["time_major", "channel_stacked"])
@pytest.mark.parametrize("use_sin", [False, True], ids=["cos", "cos_sin"])
def test_directional_feature_computer_matches_jax(rng, monkeypatch, stacked, use_sin):
    """The computer from waveforms. Its spectrum is the port's ``mc_stft``
    (held to JAX's above); the two STFTs differ by ~1e-6, which the log power
    and the phase of near-empty bins amplify to ~3e-4, so the JAX computer
    is given the port's spectrum, and its features, magnitude and phase are
    held to the port's at 1e-5; its own spectrum is held to the port's too."""
    jax_stft_module = importlib.import_module("cruse_tpu.dsp.stft")  # the package's ``stft`` shadows the module
    y = mc_batch(rng, 2, 2400)
    ours = features.DirectionalFeatureComputer(StftConfig(**STFT), PAIRS, lps_channel=2, use_sin_ipd=use_sin,
                                               channel_stacked=stacked)
    ref = jfeat.DirectionalFeatureComputer(JaxStftConfig(**STFT), PAIRS, lps_channel=2, use_sin_ipd=use_sin,
                                           channel_stacked=stacked)
    assert ours.directional_feature_dim == ref.directional_feature_dim
    got = ours(torch.from_numpy(y))
    own_spectrum = [np.asarray(t) for t in ref(jnp.asarray(y))[3:]]
    spec = mc_stft(torch.from_numpy(y), StftConfig(**STFT)).numpy()
    monkeypatch.setattr(jax_stft_module, "mc_stft", lambda _y, _cfg: jnp.asarray(spec))
    want = ref(jnp.asarray(y))
    for name, a, b in zip(("features", "magnitude", "phase", "real", "imag"), got, want):
        assert a.shape == b.shape, name
        assert np.abs(a.numpy() - np.asarray(b)).max() < FEATURE_TOL, name
    for a, b in zip(got[3:], own_spectrum):
        assert np.abs(a.numpy() - b).max() < FEATURE_TOL
    assert got[0].shape[1 if stacked else -1] == ours.directional_feature_dim


def test_silent_frame_gives_the_same_features():
    """A spectrum with an exactly zero frame on every mic. There atan2(0, 0)
    is 0 in both packages, so every IPD is cos 1, sin 0, exactly; the log
    power is the same constant log(2e-8) in every bin, so its layer norm is
    (x - mean) / sqrt(1e-5), 0 but for the rounding of the mean, which each
    package sums in its own order: within 4 ulps of log(2e-8) over
    sqrt(1e-5) of 0 in both. The other frames agree within 1e-5."""
    rng = np.random.default_rng(3)
    ri = rng.standard_normal((1, MICS, 5, 161, 2)).astype(np.float32)
    ri[:, :, 2] = 0.0
    ours = features.directional_features_from_ri(torch.from_numpy(ri), PAIRS, 0, True).numpy()[0]
    ref = np.asarray(jfeat.directional_features_from_ri(jnp.asarray(ri), PAIRS, 0, True))[0]
    live = [0, 1, 3, 4]
    assert np.abs(ours[live] - ref[live]).max() < FEATURE_TOL
    lps_bound = 4 * abs(np.spacing(np.float32(np.log(2e-8)))) / np.sqrt(1e-5)
    for silent in (ours[2], ref[2]):
        np.testing.assert_array_equal(silent[161:], np.r_[np.ones(2 * 161), np.zeros(2 * 161)])  # cos 1, sin 0
        assert np.abs(silent[:161]).max() <= lps_bound


# ---------------- the model ----------------


@pytest.mark.parametrize("use_sin", [False, True], ids=["cos", "cos_sin"])
def test_model_matches_jax(rng, use_sin):
    jax_model, variables, model = make_mc_pair(np.random.default_rng(12), use_sin)
    feats = rng.standard_normal((2, 9, model.config.feature_dim)).astype(np.float32)
    ref, _ = jax_model.apply(variables, jnp.asarray(feats))
    with torch.no_grad():
        ours, state = model(torch.from_numpy(feats))
    assert ours.shape == ref.shape == (2, 9, 161)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() < MASK_TOL
    assert [tuple(t.shape) for t in state[1]] == [(2, 4, 16 * 11 // 4)] * 2
    with pytest.raises(ValueError, match="features"):
        model(torch.zeros(1, 2, 161))


def test_bridge_round_trips_and_builds_from_the_toml(pair):
    _, variables, model = pair
    back, want = _flat(flax_from_state_dict(model)), _flat(variables)
    assert back.keys() == want.keys() and "params/PReLU_0/negative_slope" in want
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    built = build_from_config(load_config(str(ROOT / "configs/tiny_mc.toml"))["model"])
    assert isinstance(built, McCruseNet) and built.config == model.config
    assert built.config.num_mics == MICS and built.config.feature_dim == 161 * 3


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_flat(value, path) if isinstance(value, dict) else {path: np.asarray(value)})
    return out


def test_int8_bridge_matches_jax(pair, rng):
    jax_model, variables, model = pair
    state, report = tq.int8_state_dict(model, variables)
    assert report["leaves_quantized"] >= 1 and tq.is_quantized_leaf(state["spatial_proj.weight"])
    copy = McCruseNet(model.config).eval()
    tq.load_dequantized(copy, state)
    feats = rng.standard_normal((2, 7, model.config.feature_dim)).astype(np.float32)
    ref, _ = jax_model.apply(jq.dequantize_tree(jq.quantize_variables(variables)), jnp.asarray(feats))
    with torch.no_grad():
        ours, _ = copy(torch.from_numpy(feats))
    assert np.abs(ours.numpy() - np.asarray(ref)).max() < MASK_TOL


# ---------------- the strategies ----------------


@pytest.mark.parametrize("postfilter", [None, "sin"])
def test_directional_strategy_matches_jax(pair, rng, tmp_path, postfilter):
    jax_model, variables, model = pair
    noisy = mc_batch(rng, 2, 4321)
    jax_inf = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
        type="multi_channel_directional", stft=JaxStftConfig(**STFT), postfilter=postfilter,
        output_dir=str(tmp_path / "jax")))
    inf = BatchInferencer(model, InferencerConfig(type="multi_channel_directional", stft=StftConfig(**STFT),
                                                  postfilter=postfilter), device="cpu")
    ref = np.asarray(jax_inf._strategy(jnp.asarray(noisy)))
    ours = inf.multi_channel_directional(torch.from_numpy(noisy)).numpy()
    assert ours.shape == ref.shape == (2, 4321)
    assert np.abs(ours - ref).max() < WAV_TOL


def test_auto_matches_jax_adapter(pair, rng):
    """``auto`` on [B, M, L]: the multi-channel STFT through the adapter, held
    against JAX's ``mc_model_forward`` on JAX's ``mc_stft`` (JAX's own
    ``auto`` takes [B, L] only), and against ``multi_channel_directional``."""
    jax_model, variables, model = pair
    noisy = mc_batch(rng, 2, 3999)
    cfg = JaxStftConfig(**STFT)
    ri = ri_of(np.asarray(jax_mc_stft(jnp.asarray(noisy), cfg)))
    enhanced, _ = jax_mc_model_forward(jax_model)(variables["params"], variables["batch_stats"], jnp.asarray(ri),
                                                  train=False)
    ref = np.asarray(jax_istft((enhanced[..., 0], enhanced[..., 1]), cfg, length=noisy.shape[-1]))
    inf = BatchInferencer(model, InferencerConfig(type="auto", stft=StftConfig(**STFT)), device="cpu")
    ours = inf.auto(torch.from_numpy(noisy)).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() < WAV_TOL
    directional = BatchInferencer(model, InferencerConfig(type="multi_channel_directional", stft=StftConfig(**STFT)),
                                  device="cpu").multi_channel_directional(torch.from_numpy(noisy)).numpy()
    assert np.abs(ours - directional).max() < EAGER_TOL
    with pytest.raises(ValueError, match="multi-channel adapter"):
        forward_for_model(model)(torch.zeros(1, 4, 161, 2))


W_STAND_IN = np.array([0.7, -0.4, 0.2], np.float32)


class JaxStandIn(fnn.Module):
    """A mask model of all channels' magnitudes: log1p features, a gate from
    a weighted sum over channels, times channel 0's magnitude."""

    def compress(self, mags):
        return jnp.log1p(mags)

    @fnn.compact
    def __call__(self, feats, state=None):
        w = self.param("w", lambda key: jnp.asarray(W_STAND_IN))
        return jax.nn.sigmoid(jnp.einsum("bctf,c->btf", feats, w)) * jnp.expm1(feats[:, 0]), None


class StandIn(torch.nn.Module):
    """``JaxStandIn`` in PyTorch."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(W_STAND_IN.copy()))

    def compress(self, mags):
        return torch.log1p(mags)

    def forward(self, feats, state=None):
        return torch.sigmoid(torch.einsum("bctf,c->btf", feats, self.w)) * torch.expm1(feats[:, 0]), None


@pytest.mark.parametrize("reference", [0, 2])
def test_multi_channel_mag_to_mag_matches_jax(rng, tmp_path, reference):
    noisy = mc_batch(rng, 2, 3000)
    jax_inf = JaxBatchInferencer(JaxStandIn(), {"params": {"w": jnp.asarray(W_STAND_IN)}}, JaxInferencerConfig(
        type="multi_channel_mag_to_mag", stft=JaxStftConfig(**STFT), reference_channel=reference,
        output_dir=str(tmp_path / "jax")))
    inf = BatchInferencer(StandIn(), InferencerConfig(type="multi_channel_mag_to_mag", stft=StftConfig(**STFT),
                                                      reference_channel=reference), device="cpu")
    ref = np.asarray(jax_inf._strategy(jnp.asarray(noisy)))
    ours = inf.multi_channel_mag_to_mag(torch.from_numpy(noisy)).numpy()
    assert ours.shape == ref.shape == (2, 3000)
    assert np.abs(ours - ref).max() < WAV_TOL


def test_run_batched_and_enhance_long_take_multi_mic(pair, rng, tmp_path):
    """[M, L] wavs of ragged lengths through ``run_batched`` against the JAX
    package's, and a long [1, M, L] through ``enhance_long``."""
    jax_model, variables, model = pair
    wavs = [mc_batch(rng, 1, n)[0] for n in (2000, 3333, 2890)]
    names = ["x", "y", "z"]
    jcfg = JaxInferencerConfig(type="multi_channel_directional", stft=JaxStftConfig(**STFT),
                               output_dir=str(tmp_path / "jax"))
    jax_inf = JaxBatchInferencer(jax_model, variables, jcfg)
    inf = BatchInferencer(model, InferencerConfig(type="multi_channel_directional", stft=StftConfig(**STFT),
                                                  output_dir=str(tmp_path / "torch")), device="cpu")
    ours = inf.run_batched(wavs, names, batch_size=2, write=False)
    ref = jax_inf.run_batched(wavs, names, batch_size=2, write=False)
    for (name, a, _), (_, b, _), w in zip(ours, ref, wavs):
        assert a.shape == b.shape == (w.shape[-1],), name
        assert np.abs(a.astype(np.float64) - b).max() / 32768.0 <= WAV_TOL, name
    # JAX's enhance_long pads [B, L] only: its strategy on the same 50 % chunks, stitched by its overlap_cat
    long = mc_batch(rng, 1, 16000 * 2 + 777)
    got = inf.enhance_long(torch.from_numpy(long), chunk_seconds=0.5).numpy()
    chunk = 8000 - 8000 % (2 * HOP)
    halves = -(-(long.shape[-1] - chunk) // (chunk // 2))
    padded = np.pad(long, ((0, 0), (0, 0), (0, halves * chunk // 2 + chunk - long.shape[-1])))
    want = np.asarray(jfeat.overlap_cat([jax_inf._strategy(jnp.asarray(padded[..., i * chunk // 2 : i * chunk // 2 + chunk]))
                                         for i in range(halves + 1)]))[..., : long.shape[-1]]
    assert got.shape == want.shape == (1, long.shape[-1])
    assert np.abs(got - want).max() < WAV_TOL


@pytest.mark.parametrize("kind,error", [("mag_to_mag", "multi_channel_directional"),
                                        ("multi_channel_mag_to_mag", "directional features")])
def test_single_channel_strategies_refuse_mc_cruse(pair, kind, error):
    with pytest.raises(ValueError, match=error):
        BatchInferencer(pair[2], InferencerConfig(type=kind, stft=StftConfig(**STFT)), device="cpu")


# ---------------- streaming and the server ----------------


@pytest.mark.parametrize("batch,samples", [(2, 3000), (1, 1777)])
def test_stream_matches_jax_and_the_offline_call(pair, rng, batch, samples):
    """Hop by hop ([B, M, hop] in) against JAX's StreamingEnhancer.run, and
    against the port's offline center=False call through the adapter."""
    jax_model, variables, model = pair
    cfg = StftConfig(**STFT, center=False)
    wav = mc_batch(rng, batch, samples)
    ref = np.asarray(JaxStreamingEnhancer(jax_model, variables, JaxStftConfig(**STFT, center=False))
                     .run(jnp.asarray(wav)))
    enh = StreamingEnhancer(model, cfg)
    streamed = enh.run(torch.from_numpy(wav))
    assert streamed.shape == ref.shape == (batch, (samples - HOP) // HOP * HOP)
    assert np.abs(streamed.numpy() - ref).max() < WAV_TOL
    with torch.no_grad():
        spec = mc_stft(torch.from_numpy(wav), cfg)
        out = forward_for_model(model)(torch.stack([spec.real, spec.imag], dim=-1))
        offline = istft((out[..., 0], out[..., 1]), cfg)
    n, m = cfg.n_fft, min(streamed.shape[-1], offline.shape[-1])
    np.testing.assert_allclose(streamed[:, n : m - n].numpy(), offline[:, n : m - n].numpy(), atol=WAV_TOL)
    state = enh.init_state(batch)
    assert tuple(state.input_tail.shape) == (batch, MICS, 160) and tuple(state.ola_tail.shape) == (batch, 160)
    x = torch.from_numpy(wav[..., : 4 * HOP])
    multi, _ = enh.step_multi(state, x)
    steps = []
    for i in range(4):
        out, state = enh.step(state, x[..., i * HOP : (i + 1) * HOP])
        steps.append(out)
    torch.testing.assert_close(multi, torch.cat(steps, -1), rtol=0, atol=0)
    assert enh.measure_rtf(wav, num_frames=3) > 0


def session_wavs(seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {k: mc_batch(rng, 1, n * HOP + extra)[0] for k, (n, extra, _) in SESSIONS.items()}


def drive(server, wavs: dict) -> tuple[dict, dict]:
    """tests/test_torch_server.py's ``drive`` on [M, L] sessions: a, b, c
    opened at once (a fourth open must fail), fed ragged chunks of every mic
    an iteration; each drained and closed when its input is in, d opened in
    the first freed slot."""
    slots, outs, pos, turn = {}, {k: [] for k in wavs}, {k: 0 for k in wavs}, {k: 0 for k in wavs}
    for k in "abc":
        slots[k] = server.open()
    with pytest.raises(RuntimeError, match="busy"):
        server.open()
    live, waiting = ["a", "b", "c"], ["d"]
    while live:
        for k in live:
            sizes = SESSIONS[k][2]
            n = int(sizes[turn[k] % len(sizes)] * HOP)
            turn[k] += 1
            server.feed(slots[k], wavs[k][:, pos[k] : pos[k] + n])
            pos[k] = min(pos[k] + n, wavs[k].shape[-1])
        label = {slots[k]: k for k in live}
        for sid, out in server.step().items():
            outs[label[sid]].append(np.asarray(out))
        for k in list(live):
            if pos[k] == wavs[k].shape[-1] and not server.ready(slots[k]):
                outs[k].append(np.asarray(server.drain(slots[k])))
                server.close(slots[k])
                live.remove(k)
                if waiting:
                    nxt = waiting.pop()
                    slots[nxt] = server.open()
                    live.append(nxt)
    return {k: np.concatenate(v) for k, v in outs.items()}, slots


def test_server_sessions_match_jax_and_single_streams(pair):
    jax_model, variables, model = pair
    cfg = StftConfig(**STFT, center=False)
    wavs = session_wavs()
    server = StreamingServer(model, cfg, SLOTS, device="cpu")
    assert server.mics == MICS and tuple(server._state.input_tail.shape) == (SLOTS, MICS, 160)
    ours, slots = drive(server, wavs)
    ref, jax_slots = drive(JaxStreamingServer(jax_model, variables, JaxStftConfig(**STFT, center=False), SLOTS), wavs)
    assert slots == jax_slots and slots["d"] == slots["a"] == 0
    enh = StreamingEnhancer(model, cfg)
    for k, wav in wavs.items():
        assert ours[k].shape == ref[k].shape == (wav.shape[-1],), k
        assert np.abs(ours[k] - ref[k]).max() <= WAV_TOL, k
        padded = np.pad(wav, ((0, 0), (0, (-wav.shape[-1]) % HOP)))
        alone, _ = enh.step_multi(enh.init_state(1), torch.from_numpy(padded[None]))
        assert np.abs(ours[k] - alone[0, : wav.shape[-1]].numpy()).max() <= EAGER_TOL, k
    with pytest.raises(ValueError, match="3-mic"):
        server.feed(server.open(), np.zeros(HOP, np.float32))


def test_mixed_pools_in_a_multi_model_server(pair):
    """A mono CRUSE pool beside the 3-mic pool: each session against its own
    single stream."""
    from cruse_tpu_torch.infer.server import MultiModelServer
    from cruse_tpu_torch.models import CruseNet

    model = pair[2]
    cfg = StftConfig(**STFT, center=False)
    mono = CruseNet(CruseConfig(**TRUNK), generator=torch.Generator().manual_seed(2)).eval()
    server = MultiModelServer()
    server.add_model("mc", model, cfg, max_streams=2, device="cpu")
    server.add_model("mono", mono, cfg, max_streams=2, device="cpu")
    wavs = session_wavs(5)
    handles = {"mc": server.open("mc"), "mono": server.open("mono", priority=1)}
    inputs = {"mc": wavs["b"][:, : 5 * HOP], "mono": wavs["b"][0, : 5 * HOP]}
    for name, handle in handles.items():
        server.feed(handle, inputs[name])
    outs = {name: [] for name in handles}
    while any(server.ready(h) for h in handles.values()):
        for (name, _), hop in server.step().items():
            outs[name].append(hop)
    for name, m in (("mc", model), ("mono", mono)):
        enh = StreamingEnhancer(m, cfg)
        alone, _ = enh.step_multi(enh.init_state(1), torch.from_numpy(inputs[name][None]))
        assert np.abs(np.concatenate(outs[name]) - alone[0].numpy()).max() <= EAGER_TOL, name


# ---------------- the CLIs and the artifact ----------------


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory, pair):
    """configs/tiny_mc.toml, a bridge .npz of the pair's weights and two
    3-channel wavs, made once."""
    root = tmp_path_factory.mktemp("mc_cli")
    save_flax_npz(pair[1], str(root / "w.npz"))
    (root / "in").mkdir()
    rng = np.random.default_rng(4)
    for name, n in (("u0", 4000), ("u1", 5123)):
        write_wav(str(root / "in" / f"{name}.wav"), mc_batch(rng, 1, n)[0], 16000)
    return root


def _int16(y: np.ndarray) -> np.ndarray:
    return to_int16_scaled(y).astype(np.float64) / 32768.0


@pytest.mark.parametrize("mode", ["offline", "streaming", "served"])
def test_clis_match_jax(pair, cli_inputs, mode):
    """``python -m cruse_tpu_torch.infer`` (offline: the TOML's
    multi_channel_directional; ``--streaming``) and ``...infer.serve`` on
    3-channel wavs, in this process: each wav within 1e-4 of the JAX path on
    the same weights (offline, the strategy; streamed, the primed
    ``run``; served, the JAX server's session)."""
    jax_model, variables, _ = pair
    root, out_dir = cli_inputs, cli_inputs / mode
    config = str(ROOT / "configs/tiny_mc.toml")
    if mode == "served":
        serve_main(["-M", f"mc={config}:{root / 'w.npz'}", "-I", str(root / "in"), "-O", str(out_dir),
                    "--max_streams", "2", "--device", "cpu"])
    else:
        cli_main(["-C", config, "-I", str(root / "in"), "-O", str(out_dir), "--weights", str(root / "w.npz"),
                  "--device", "cpu"] + (["--streaming"] if mode == "streaming" else []))
    jcfg = JaxStftConfig(**STFT, center=mode == "offline")
    for name in ("u0", "u1"):
        noisy = read_wav(str(root / "in" / f"{name}.wav"), mono=False)[0]
        assert noisy.shape[0] == MICS
        if mode == "offline":
            ref = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
                type="multi_channel_directional", stft=jcfg, output_dir=str(root / "jax")))._strategy(
                jnp.asarray(noisy[None]))
        elif mode == "streaming":
            ref = JaxStreamingEnhancer(jax_model, variables, jcfg).run(jnp.asarray(noisy[None]))
        else:
            ref = JaxStreamingServer(jax_model, variables, jcfg, 1)
            sid = ref.open()
            ref = np.concatenate([ref.run_session(noisy, sid), ref.drain(sid)])[None]
        ref = _int16(np.asarray(ref)[0])
        out, sr = read_wav(str(out_dir / f"{name}.wav"))
        assert sr == 16000 and out.shape == ref.shape, (mode, name)
        assert np.abs(out - ref).max() <= WAV_TOL, (mode, name)


@pytest.fixture(scope="module")
def streamed_artifacts(tmp_path_factory, cli_inputs):
    """configs/tiny_mc.toml exported --streaming at B=2 by the CLI, float32
    and int8, on the bridged weights."""
    root = tmp_path_factory.mktemp("mc_artifacts")
    paths = {}
    for quant in (None, "int8"):
        paths[quant] = root / f"mc_{quant or 'fp32'}.zip"
        export_lib.main(["-C", str(ROOT / "configs/tiny_mc.toml"), "-O", str(paths[quant]), "--weights",
                         str(cli_inputs / "w.npz"), "--batch", "2", "--streaming", "--device", "cpu"]
                        + (["--quantize", "int8"] if quant else []))
    return paths


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_streamed_artifact_matches_eager(pair, streamed_artifacts, rng, quant):
    """The artifact's hop is [B, M, hop]; its stream against the eager
    StreamingEnhancer on the same (for int8: dequantized) weights."""
    variables = pair[1]
    art = artifact_lib.load(str(streamed_artifacts[quant]), "cpu")
    assert art.meta["num_mics"] == MICS and art.hop_shape == (2, MICS, HOP) and art.meta["quantized"] == quant
    model = McCruseNet(pair[2].config).eval()
    if quant:
        tq.load_dequantized(model, tq.int8_state_dict(model, variables)[0])
        assert any(t.dtype == torch.int8 for t in art.program.state_dict.values())
    else:
        model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    enh = StreamingEnhancer(model, StftConfig(**STFT, center=False))
    wav = torch.from_numpy(mc_batch(rng, 2, 160 + 6 * HOP))
    state, e_state = art.prime(art.init_state(), wav[..., :160]), enh.prime(enh.init_state(2), wav[..., :160])
    for i in range(6):
        hop = wav[..., 160 + i * HOP : 160 + (i + 1) * HOP]
        out, state = art.step(state, hop)
        e_out, e_state = enh.step(e_state, hop)
        assert out.shape == (2, HOP)
        assert (out - e_out).abs().max() < EAGER_TOL


def test_run_exported_on_a_multi_mic_artifact(streamed_artifacts, cli_inputs, tmp_path, capsys):
    """run_exported (its ``main``) streams the two 3-channel wavs through the
    float32 artifact, as the artifact streams them here."""
    run_exported_main(["-A", str(streamed_artifacts[None]), "-I", str(cli_inputs / "in"), "-O", str(tmp_path),
                       "--device", "cpu"])
    assert "mics=3" in capsys.readouterr().out
    art = artifact_lib.load(str(streamed_artifacts[None]), "cpu")
    wavs = [read_wav(str(cli_inputs / "in" / f"{n}.wav"), mono=False)[0] for n in ("u0", "u1")]
    n_hops = -(-(max(w.shape[-1] for w in wavs) - 160) // HOP)
    feed = np.zeros((2, MICS, 160 + n_hops * HOP), np.float32)
    for i, w in enumerate(wavs):
        feed[i, :, : w.shape[-1]] = w
    feed = torch.from_numpy(feed)
    state, outs = art.prime(art.init_state(), feed[..., :160]), []
    for h in range(n_hops):
        out, state = art.step(state, feed[..., 160 + h * HOP : 160 + (h + 1) * HOP])
        outs.append(out)
    streamed = torch.cat(outs, -1).numpy()
    for i, (name, w) in enumerate(zip(("u0", "u1"), wavs)):
        got = read_wav(str(tmp_path / f"{name}.wav"))[0]
        np.testing.assert_array_equal(got, to_int16_scaled(streamed[i, : w.shape[-1]]).astype(np.float32) / 32768.0)
    with pytest.raises(SystemExit, match="3-mic"):
        write_wav(str(tmp_path / "mono" / "m.wav"), np.zeros(800, np.float32), 16000)
        run_exported_main(["-A", str(streamed_artifacts[None]), "-I", str(tmp_path / "mono"), "-O",
                           str(tmp_path / "o"), "--device", "cpu"])


def test_offline_export_refuses_mc_cruse_by_name(pair, tmp_path):
    with pytest.raises(NotImplementedError, match="McCruse offline.*JAX exporter"):
        export_lib.export_offline(pair[2], InferencerConfig(type="multi_channel_directional",
                                                            stft=StftConfig(**STFT)), 1, 1600, "cpu")
    with pytest.raises(NotImplementedError, match="McCruse offline"):
        export_lib.main(["-C", str(ROOT / "configs/tiny_mc.toml"), "-O", str(tmp_path / "a.zip"), "--seconds",
                         "0.5", "--device", "cpu"])
    assert not (tmp_path / "a.zip").exists()
