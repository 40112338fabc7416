"""Port parity: cruse_tpu_torch's CRUSE and the offline enhancement path
against cruse_tpu, on the CPU, with weights carried across by the bridge.

BatchNorm statistics are perturbed away from their defaults on the JAX side,
so a bridge that forgot to copy them fails. Tolerances: the mask at 1e-5
(float32 nets of the same layers); the enhanced waveform at 1e-4 max-abs,
the BASELINE contract for noisy wav -> enhanced wav.
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
from cruse_tpu.models import CruseConfig as JaxCruseConfig
from cruse_tpu.models import CruseNet as JaxCruseNet
from cruse_tpu.utils.config import load_config

from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.models import CruseConfig, CruseNet, build_from_config
from cruse_tpu_torch.models.cruse import cruse_init_state, enhance_spectrum
from cruse_tpu_torch.utils.weights import (
    cruse_state_dict_from_flax, load_flax_npz, save_flax_npz)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SMALL = dict(in_freq=161, channels=(4, 8, 8, 16), rnn_groups=4)


def make_pair(cfg_kwargs: dict, rng, seed: int = 0):
    """A cruse_tpu CruseNet with seeded variables and perturbed BatchNorm
    statistics, and the port's CruseNet carrying the same weights."""
    jax_model = JaxCruseNet(JaxCruseConfig(**cfg_kwargs))
    feat = jnp.ones((1, 4, cfg_kwargs.get("in_freq", 161)), jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init(jax.random.PRNGKey(seed), feat))
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.2, 0.6, a.shape).astype(np.float32), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    model = CruseNet(CruseConfig(**cfg_kwargs)).eval()
    model.load_state_dict(cruse_state_dict_from_flax(variables, model.config), strict=True)
    return jax_model, variables, model


def noisy_batch(rng, b, length):
    t = np.arange(length) / 16000.0
    tone = 0.2 * np.sin(2 * np.pi * rng.uniform(150, 400, (b, 1)) * t)
    return (tone + 0.05 * rng.standard_normal((b, length))).astype(np.float32)


VARIANTS = {
    "transposed": {},
    "upsample": dict(decoder_mode="upsample"),
    "relu_log1p_noskip": dict(mask_activation="relu", feature_compression="log1p",
                              skip_convs=False),
    "linear_uncompressed": dict(mask_activation="none", feature_compression="none"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cruse_mask_matches_jax(rng, variant):
    jax_model, variables, model = make_pair(dict(SMALL, **VARIANTS[variant]), rng)
    mag = np.abs(rng.standard_normal((2, 20, 161))).astype(np.float32)
    feat = jax_model.compress(jnp.asarray(mag))
    ref, _ = jax.jit(jax_model.apply)(variables, feat)
    with torch.no_grad():
        mask, _ = model(model.compress(torch.from_numpy(mag)))
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref), atol=1e-5)


def test_bridge_carries_batch_stats_and_npz(rng, tmp_path):
    _, variables, model = make_pair(SMALL, rng)
    mean = variables["batch_stats"]["enc_1"]["bn"]["mean"]
    np.testing.assert_array_equal(model.enc_1.bn.running_mean.numpy(), mean)
    assert not np.allclose(mean, 0.0)
    path = tmp_path / "w.npz"
    save_flax_npz(variables, str(path))
    loaded = cruse_state_dict_from_flax(load_flax_npz(str(path)), model.config)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(loaded[key], value, rtol=0, atol=0)


def test_carried_state_continues_the_utterance(rng):
    """Two calls with the returned state equal one call over the whole input."""
    _, _, model = make_pair(SMALL, rng)
    feat = torch.from_numpy(np.abs(rng.standard_normal((2, 12, 161))).astype(np.float32))
    with torch.no_grad():
        whole, _ = model(feat)
        first, state = model(feat[:, :5], cruse_init_state(model.config, 2))
        second, _ = model(feat[:, 5:], state)
    torch.testing.assert_close(torch.cat([first, second], dim=1), whole, rtol=0, atol=1e-6)


def test_enhance_spectrum_matches_jax(rng):
    from cruse_tpu.models.cruse import enhance_spectrum as jax_enhance_spectrum

    jax_model, variables, model = make_pair(SMALL, rng)
    spec = (rng.standard_normal((1, 9, 161)) + 1j * rng.standard_normal((1, 9, 161)))
    spec = spec.astype(np.complex64)
    ref, ref_mask, _ = jax_enhance_spectrum(jax_model, variables, jnp.asarray(spec))
    with torch.no_grad():
        out, mask, _ = enhance_spectrum(model, torch.from_numpy(spec))
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref_mask), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _pipeline_pair(cfg_kwargs, rng, tmp_path):
    jax_model, variables, model = make_pair(cfg_kwargs, rng)
    jax_inf = JaxBatchInferencer(
        jax_model, variables,
        JaxInferencerConfig(stft=JaxStftConfig(n_fft=320, hop_length=160),
                            output_dir=str(tmp_path / "jax")))
    inf = BatchInferencer(model, InferencerConfig(stft=StftConfig(n_fft=320, hop_length=160),
                                                  output_dir=str(tmp_path / "torch")), device="cpu")
    return jax_inf, inf


@pytest.mark.parametrize("width", ["small", "cruse_base"])
def test_mag_to_mag_waveform_matches_jax(rng, tmp_path, width):
    """noisy wav -> enhanced wav through BatchInferencer.mag_to_mag in both
    packages: at small widths (B=2, 0.5 s) and at the full width of
    configs/cruse_base.toml (B=1, 1 s)."""
    if width == "small":
        cfg_kwargs, noisy = SMALL, noisy_batch(rng, 2, 8000)
    else:
        args = load_config(str(CONFIGS / "cruse_base.toml"))["model"]["args"]
        cfg_kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in args.items()}
        noisy = noisy_batch(rng, 1, 16000)
    jax_inf, inf = _pipeline_pair(cfg_kwargs, rng, tmp_path)
    ref = np.asarray(jax_inf._strategy(jnp.asarray(noisy)))
    ours = inf.mag_to_mag(torch.from_numpy(noisy)).numpy()
    assert ours.shape == ref.shape == noisy.shape
    err = np.abs(ours - ref).max()
    assert err < 1e-4, f"enhanced waveform max-abs {err} >= 1e-4"


def test_build_from_config_maps_the_class_name():
    config = load_config(str(CONFIGS / "tiny_cruse.toml"))
    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(1))
    assert isinstance(model, CruseNet) and model.config.channels == (4, 8, 8, 16)
    again = build_from_config(config["model"], generator=torch.Generator().manual_seed(1))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_from_config({"path": "cruse_tpu.nn.gru.SqueezedGRU", "args": {}})
