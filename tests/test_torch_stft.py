"""Port parity: cruse_tpu_torch.dsp.stft against cruse_tpu.dsp.stft on the
CPU, at 1e-5 max-abs (float32 spectra of unit-scale noise; the two sides take
the DFT by different summation orders)."""
import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cruse_tpu_torch.dsp.stft import StftConfig, istft, istft_mag_phase, mag_phase, stft
from cruse_tpu_torch.dsp.windows import get_window

# the module, not the function that cruse_tpu.dsp re-exports under its name
jax_stft_mod = importlib.import_module("cruse_tpu.dsp.stft")

GEOMETRIES = [
    dict(n_fft=320, hop_length=160),
    dict(n_fft=512, hop_length=128, window="sqrt_hann"),
    dict(n_fft=512, hop_length=256, win_length=400),
]
IDS = ["320-160-hann", "512-128-sqrt_hann", "512-256-win400"]


def _pair(geometry):
    return StftConfig(**geometry), jax_stft_mod.StftConfig(**geometry)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_stft_matches_jax(rng, geometry):
    cfg, jcfg = _pair(geometry)
    y = (rng.standard_normal((2, 8000)) * 0.5).astype(np.float32)
    ours = stft(torch.from_numpy(y), cfg).numpy()
    ref = np.asarray(jax_stft_mod.stft(jnp.asarray(y), jcfg))
    assert ours.shape == ref.shape == (2, jcfg.num_frames(8000), cfg.num_bins)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_istft_round_trip(rng, geometry):
    cfg, _ = _pair(geometry)
    y = (rng.standard_normal((2, 8000)) * 0.5).astype(np.float32)
    back = istft(stft(torch.from_numpy(y), cfg), cfg, length=8000).numpy()
    np.testing.assert_allclose(back, y, atol=1e-5)


def _retained_envelope(cfg, num_frames, length):
    """Overlap-added squared window over the samples the iSTFT returns."""
    w2 = get_window(cfg.window, cfg.n_fft).astype(np.float64) ** 2
    env = np.zeros(cfg.n_fft + cfg.hop_length * (num_frames - 1))
    for t in range(num_frames):
        env[t * cfg.hop_length : t * cfg.hop_length + cfg.n_fft] += w2
    env = env[cfg.n_fft // 2 :][:length]
    return np.pad(env, (0, length - env.shape[0]), constant_values=1.0)


@pytest.mark.parametrize("length", [None, 7900, 8000, 8100, 8160, 8400])
def test_istft_length_tails_match_jax(rng, length):
    """Default trim, shorter, exact, the partial-envelope tail, and zero
    padding past the last frame, as cruse_tpu's explicit-length semantics.

    In the tail both sides divide by an envelope that falls to w[-1]^2 ~ 1e-8,
    which magnifies float32 rounding there; so the 1e-5 holds for the
    difference times the envelope (the overlap-added numerator), which is
    the difference itself wherever the envelope is 1."""
    cfg, jcfg = _pair(GEOMETRIES[0])
    y = (rng.standard_normal((1, 8000)) * 0.5).astype(np.float32)
    spec = jax_stft_mod.stft(jnp.asarray(y), jcfg)
    spec = spec * (1.0 + 0.5 * jnp.asarray(rng.uniform(size=spec.shape).astype(np.float32)))
    ref = np.asarray(jax_stft_mod.istft(spec, jcfg, length=length))
    ours = istft(torch.from_numpy(np.array(spec)), cfg, length=length).numpy()
    assert ours.shape == ref.shape
    env = _retained_envelope(cfg, spec.shape[1], ref.shape[-1])
    np.testing.assert_allclose((ours - ref) * np.minimum(env, 1.0), 0.0, atol=1e-5)
    available = 8000 + cfg.n_fft // 2  # samples the frames cover after the centre trim
    if ref.shape[-1] > available:
        assert not ours[:, available:].any() and not ref[:, available:].any()


@pytest.mark.parametrize("length", [None, 7900, 8200])
def test_istft_uncentred_matches_jax(rng, length):
    """center=False (the streaming contract): the JAX package's own
    overlap-add with the 1e-11 envelope guard, where torch.istft raises on
    a Hann window's zero first sample. As in the tail test above, the 1e-5
    holds for the difference times the envelope: at the first samples the
    envelope falls to w[1]^2 ~ 1e-8 and magnifies float32 rounding."""
    geometry = dict(GEOMETRIES[0], center=False)
    cfg, jcfg = _pair(geometry)
    y = (rng.standard_normal((2, 8000)) * 0.5).astype(np.float32)
    spec = jax_stft_mod.stft(jnp.asarray(y), jcfg)
    spec = spec * (1.0 + 0.5 * jnp.asarray(rng.uniform(size=spec.shape).astype(np.float32)))
    ref = np.asarray(jax_stft_mod.istft(spec, jcfg, length=length))
    ours = istft(torch.from_numpy(np.array(spec)), cfg, length=length).numpy()
    assert ours.shape == ref.shape == (2, length or cfg.n_fft + cfg.hop_length * (spec.shape[1] - 1))
    env = jax_stft_mod._ola_envelope(jcfg, spec.shape[1])[: ref.shape[-1]]
    env = np.pad(env, (0, ref.shape[-1] - env.shape[0]), constant_values=1.0)
    np.testing.assert_allclose((ours - ref) * np.minimum(env, 1.0), 0.0, atol=1e-5)
    np.testing.assert_allclose(ours[:, 320:7680], ref[:, 320:7680], atol=1e-5)  # envelope >= 0.5
    # without the spectrum's perturbation, the frames reconstruct the input
    back = istft(stft(torch.from_numpy(y), cfg), cfg).numpy()
    np.testing.assert_allclose(back[:, 320:7680], y[:, 320:7680], atol=1e-5)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_dft_bases_and_envelope_match_jax(geometry):
    from cruse_tpu_torch.dsp import stft as ours

    cfg, jcfg = _pair(geometry)
    np.testing.assert_array_equal(ours._padded_window(cfg), jax_stft_mod._padded_window(jcfg))
    np.testing.assert_array_equal(ours._analysis_kernel(cfg), jax_stft_mod._analysis_kernel(jcfg)[:, 0])
    np.testing.assert_array_equal(ours._synthesis_kernel(cfg),
                                  jax_stft_mod._synthesis_kernel(jcfg)[:, 0])
    np.testing.assert_array_equal(ours._ola_envelope(cfg, 7), jax_stft_mod._ola_envelope(jcfg, 7))


def test_mag_phase_round_trip_matches_jax(rng):
    cfg, jcfg = _pair(GEOMETRIES[0])
    y = (rng.standard_normal((2, 4000)) * 0.5).astype(np.float32)
    spec = stft(torch.from_numpy(y), cfg)
    mag, phase = mag_phase(spec)
    jmag, jphase = jax_stft_mod.mag_phase(jnp.asarray(spec.numpy()))
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), atol=1e-5)
    ours = istft_mag_phase(mag, phase, cfg, length=4000).numpy()
    ref = np.asarray(jax_stft_mod.istft_mag_phase(jmag, jphase, jcfg, length=4000))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_allclose(ours, y, atol=1e-5)
