"""Port parity: cruse_tpu_torch's CRUSE+DF (config 3) and the offline ``auto``
path against cruse_tpu, on the CPU, with weights carried across by the bridge.

BatchNorm statistics are perturbed on the JAX side, so a bridge that forgot
to copy them fails. Tolerances: mask and coefficients at 1e-5 (float32 nets
of the same layers); the enhanced waveform at 1e-4 max-abs, the BASELINE
contract for noisy wav -> enhanced wav.
"""
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig
from cruse_tpu.models.cruse import CruseConfig as JaxCruseConfig
from cruse_tpu.models.cruse_df import CruseDfConfig as JaxCruseDfConfig
from cruse_tpu.models.cruse_df import CruseDfNet as JaxCruseDfNet
from cruse_tpu.models.cruse_df import apply_cruse_df as jax_apply_cruse_df
from cruse_tpu.utils.config import load_config

from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.models import CruseConfig, CruseDfConfig, CruseDfNet, build_from_config
from cruse_tpu_torch.models.cruse_df import apply_cruse_df
from cruse_tpu_torch.utils.weights import load_flax_npz, save_flax_npz, state_dict_from_flax
from tests.test_torch_cruse import noisy_batch

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SMALL_TRUNK = dict(in_freq=161, channels=(4, 8, 8, 16), rnn_groups=4)
SMALL = dict(df_bins=24, df_taps_t=1, df_taps_f=1)  # configs/tiny_cruse_df.toml's head


def make_df_pair(rng, trunk: dict | None = None, head: dict | None = None, seed: int = 0):
    """A cruse_tpu CruseDfNet with seeded variables and perturbed BatchNorm
    statistics, and the port's CruseDfNet carrying the same weights; with
    no arguments, config 3's full width (CruseDfConfig() defaults)."""
    head = head or {}
    jcfg = JaxCruseDfConfig(cruse=JaxCruseConfig(**(trunk or {}), emit_features=True), **head)
    jax_model = JaxCruseDfNet(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init(
        jax.random.PRNGKey(seed), jnp.ones((1, 4, jcfg.cruse.in_freq), jnp.float32)))
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.2, 0.6, a.shape).astype(np.float32), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    cfg = CruseDfConfig(cruse=CruseConfig(**(trunk or {})), **head)
    model = CruseDfNet(cfg).eval()
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return jax_model, variables, model


def test_config_defaults_are_config_3():
    cfg = CruseDfConfig()
    assert cfg.cruse.emit_features and cfg.cruse.bottleneck_dim == 704 and cfg.cruse.rnn_groups == 4
    assert (cfg.df_bins, cfg.df_taps_t, cfg.df_taps_f, cfg.num_taps) == (96, 2, 1, 15)
    model = CruseDfNet(cfg)
    assert tuple(model.df_head.weight.shape) == (96 * 15 * 2, 704)
    # a dict trunk (a config file's nested table) is coerced, emit_features forced
    coerced = CruseDfConfig(cruse={"channels": [4, 8], "kernel": [2, 3], "emit_features": False})
    assert coerced.cruse == CruseConfig(channels=(4, 8), emit_features=True)


@pytest.mark.parametrize("head", [SMALL, dict(df_bins=32, df_taps_t=2, df_taps_f=0)],
                         ids=["t1f1", "t2f0"])
def test_mask_and_coefs_match_jax(rng, head):
    jax_model, variables, model = make_df_pair(rng, SMALL_TRUNK, head)
    mag = np.abs(rng.standard_normal((2, 20, 161))).astype(np.float32)
    (ref_mask, ref_coefs), _ = jax.jit(jax_model.apply)(variables, jax_model.compress(jnp.asarray(mag)))
    with torch.no_grad():
        (mask, coefs), _ = model(model.compress(torch.from_numpy(mag)))
    assert tuple(coefs.shape) == (2, 20, head["df_bins"], model.config.num_taps, 2)
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref_mask), atol=1e-5)
    np.testing.assert_allclose(coefs.numpy(), np.asarray(ref_coefs), atol=1e-5)


def test_apply_cruse_df_matches_jax(rng):
    cfg = CruseDfConfig(cruse=CruseConfig(**SMALL_TRUNK), **SMALL)
    jcfg = JaxCruseDfConfig(cruse=JaxCruseConfig(**SMALL_TRUNK, emit_features=True), **SMALL)
    spec = (rng.standard_normal((2, 30, 161)) + 1j * rng.standard_normal((2, 30, 161))).astype(np.complex64)
    mask = rng.uniform(0, 1, (2, 30, 161)).astype(np.float32)
    coefs = (rng.standard_normal((2, 30, 24, 9, 2)) * 0.2).astype(np.float32)
    ref = np.asarray(jax_apply_cruse_df(jnp.asarray(spec), jnp.asarray(mask), jnp.asarray(coefs), jcfg))
    ours = apply_cruse_df(torch.from_numpy(spec), torch.from_numpy(mask), torch.from_numpy(coefs), cfg)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def _auto_pair(jax_model, variables, model, tmp_path):
    stft_args = dict(n_fft=320, hop_length=160)
    jax_inf = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
        type="auto", stft=JaxStftConfig(**stft_args), output_dir=str(tmp_path / "jax")))
    inf = BatchInferencer(model, InferencerConfig(type="auto", stft=StftConfig(**stft_args),
                                                  output_dir=str(tmp_path / "torch")), device="cpu")
    return jax_inf, inf


@pytest.mark.parametrize("width", ["small", "config3"])
def test_auto_waveform_matches_jax(rng, tmp_path, width):
    """noisy wav -> enhanced wav through BatchInferencer(type="auto") in both
    packages: at small widths (B=2, 0.5 s) and at config 3's full width
    (CruseDfConfig() defaults, B=1, 1 s)."""
    if width == "small":
        pair, noisy = make_df_pair(rng, SMALL_TRUNK, SMALL), noisy_batch(rng, 2, 8000)
    else:
        pair, noisy = make_df_pair(rng), noisy_batch(rng, 1, 16000)
    jax_inf, inf = _auto_pair(*pair, tmp_path)
    ref = np.asarray(jax_inf._strategy(jnp.asarray(noisy)))
    ours = inf.auto(torch.from_numpy(noisy)).numpy()
    assert ours.shape == ref.shape == noisy.shape
    err = np.abs(ours - ref).max()
    assert err < 1e-4, f"enhanced waveform max-abs {err} >= 1e-4"


def test_auto_run_batched_matches_jax(rng, tmp_path):
    pair = make_df_pair(rng, SMALL_TRUNK, SMALL)
    wavs = [noisy_batch(rng, 1, n)[0] for n in (4000, 6543, 9100)]
    names = ["a", "b", "c"]
    jax_inf, inf = _auto_pair(*pair, tmp_path)
    ref = jax_inf.run_batched(wavs, names, batch_size=2, write=False)
    ours = inf.run_batched(wavs, names, batch_size=2, write=False)
    for (name, a, _), (_, b, _) in zip(ours, ref):
        assert a.shape == b.shape
        assert np.abs(a.astype(np.float64) - b.astype(np.float64)).max() / 32768.0 <= 1e-4, name


def test_build_from_config_tiny_cruse_df():
    config = load_config(str(CONFIGS / "tiny_cruse_df.toml"))
    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(1))
    assert isinstance(model, CruseDfNet)
    assert model.config == CruseDfConfig(cruse=CruseConfig(**SMALL_TRUNK), **SMALL)
    again = build_from_config(config["model"], generator=torch.Generator().manual_seed(1))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert config["inferencer"]["type"] == "auto"
    BatchInferencer(model, InferencerConfig(type="auto"), device="cpu")  # the strategy the config names
    with pytest.raises(ValueError, match="auto"):
        BatchInferencer(model, InferencerConfig(type="mag_to_mag"))


def test_bridge_npz_round_trip(rng, tmp_path):
    _, variables, model = make_df_pair(rng, SMALL_TRUNK, SMALL)
    kernel = variables["params"]["df_head"]["kernel"]
    np.testing.assert_array_equal(model.df_head.weight.detach().numpy(), kernel.T)
    mean = variables["batch_stats"]["cruse"]["enc_1"]["bn"]["mean"]
    np.testing.assert_array_equal(model.cruse.enc_1.bn.running_mean.numpy(), mean)
    path = tmp_path / "w.npz"
    save_flax_npz(variables, str(path))
    loaded = state_dict_from_flax(load_flax_npz(str(path)), model)
    assert loaded.keys() == model.state_dict().keys()
    for key, value in model.state_dict().items():
        torch.testing.assert_close(loaded[key], value, rtol=0, atol=0)
