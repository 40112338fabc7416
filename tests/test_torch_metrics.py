"""Port parity: cruse_tpu_torch.metrics (copies of cruse_tpu/metrics: SI-SDR,
SDR, STOI, ESTOI, PMOS and the native WB/NB-PESQ in numpy and scipy, the
registry and the composite best-model score) against cruse_tpu.metrics on
numpy-seeded signals. Both run the same numpy code, so every value agrees to
1e-12."""
import numpy as np
import pytest

from cruse_tpu.metrics import registry as jax_registry

from cruse_tpu_torch.metrics import registry

SR = 16000
NATIVE = ("SI_SDR", "SDR", "STOI", "ESTOI", "PMOS", "WB_PESQ", "NB_PESQ")


@pytest.fixture(scope="module")
def signals():
    """A speech-like reference (harmonics under a syllable envelope) and a
    noisy, slightly distorted estimate of it, 1.5 s."""
    rng = np.random.default_rng(3)
    t = np.arange(int(1.5 * SR)) / SR
    clean = sum(np.sin(2 * np.pi * k * 140 * t) / k for k in range(1, 6))
    clean = (0.3 * clean * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t))).astype(np.float32)
    estimate = (np.tanh(1.5 * clean) / 1.5 + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    return clean, estimate


@pytest.mark.parametrize("name", NATIVE)
def test_metric_matches_jax(signals, name):
    clean, estimate = signals
    ours = registry.compute_metric(name, clean, estimate, sr=SR)
    theirs = jax_registry.compute_metric(name, clean, estimate, sr=SR)
    assert np.isfinite(ours)
    np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=1e-12)


def test_registry_and_availability_match_jax():
    assert list(registry.REGISTERED_METRICS) == list(jax_registry.REGISTERED_METRICS)
    assert registry.available_metrics() == jax_registry.available_metrics()
    with pytest.raises(KeyError, match="not registered"):
        registry.compute_metric("NOPE", np.zeros(10), np.zeros(10))


@pytest.mark.parametrize("means", [
    {"STOI": 0.8, "WB_PESQ": 2.5, "PMOS": 3.0},
    {"STOI": 0.7, "PMOS": 2.0},
    {"STOI": 0.9},
    {"SI_SDR": 10.0},
])
def test_composite_score_matches_jax(means):
    assert registry.composite_score(means) == jax_registry.composite_score(means)
