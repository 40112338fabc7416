"""Port parity: cruse_tpu_torch.data.mixer (the single-channel mixer, batched
over B with tensors) against cruse_tpu.data.mixer on the CPU.

The JAX mixer draws each row's randomness from a key split off the batch's;
the test splits the keys exactly as ``mix_batch`` (one key a row) and
``mix_components`` / ``mix_single`` (six keys a row) do, turns them into the
port's draws and injects those. Tolerances: ``fft_convolve`` and
``add_reverb`` 1e-5; ``mix_batch`` 1e-5 absolute (the output is at -25 +- 10
dBFS and below the 0.99 clipping guard), with reverberated clean speech and
noise included. With the EQ chain on, the rows without EQ are held to the
JAX mixer at 1e-5, and the EQ rows to the JAX package's mixing before the
chain, then its chain run section by section through its sequential
``lfilter``, within 1e-4 of max|y| (the JAX mixer's own associative
float32 chain misses that by up to 1e-3 of max|y| on some draws;
tests/test_torch_biquad.py). The port's own draws: over 4,096 rows the SNRs
are the configured integers, each one drawn, the levels lie in target +-
floating, the Bernoulli shares are within 0.04 of their proportions
(4.5 standard deviations), and a mix meets its SNR and level.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.data import mixer as jmixer
from cruse_tpu.dsp import biquad as jb

from cruse_tpu_torch.data import mixer
from cruse_tpu_torch.dsp import biquad as tb
from tests.test_torch_biquad import jax_draws

B, L, R = 8, 4000, 3200


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(5)
    t = np.arange(L) / 16000
    clean = np.stack([0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * t) * (1 + np.sin(2 * np.pi * 3 * t))
                      for _ in range(B)]).astype(np.float32)
    noise = (0.1 * rng.standard_normal((B, L))).astype(np.float32)
    rir = np.zeros((B, R), np.float32)
    for i in range(B):
        d = int(rng.integers(5, 60))
        rir[i, d:] = 0.9 * np.exp(-np.arange(R - d) / rng.uniform(400, 1200)) * rng.standard_normal(R - d)
        rir[i, d] = 1.0
    rir[-1] = 0.0  # an all-zero row: "no reverb"
    rir_noise = np.roll(rir, 3, axis=0)
    return clean, noise, rir, rir_noise


def draws_from_key(key, cfg):
    """The port's draws of the JAX mixer's rows, split from ``key`` as it splits them."""
    rows = {k: [] for k in ("use_rev", "use_rev_n", "snr", "dbfs", "use_eq")}
    eq = []
    for k in jax.random.split(key, B):
        k_rev, k_revn, k_snr, k_dbfs, k_eq, k_equse = jax.random.split(k, 6)
        rows["use_rev"].append(bool(jax.random.uniform(k_rev, ()) < cfg.reverb_proportion))
        rows["use_rev_n"].append(bool(jax.random.uniform(k_revn, ()) < cfg.reverb_noise_proportion))
        rows["snr"].append(int(jax.random.randint(k_snr, (), cfg.snr_range[0], cfg.snr_range[1] + 1)))
        rows["dbfs"].append(float(jax.random.uniform(
            k_dbfs, (), minval=cfg.target_db_fs - cfg.target_db_fs_floating,
            maxval=cfg.target_db_fs + cfg.target_db_fs_floating)))
        rows["use_eq"].append(bool(jax.random.uniform(k_equse, ()) < cfg.eq_proportion))
        eq.append(jax_draws(k_eq, cfg.eq_filters))
    eq_draws = tb.EqDraws(*(torch.stack([getattr(d, f) for d in eq]) for f in ("kind", "u", "gain_db", "q")))
    return mixer.MixDraws(use_rev=torch.tensor(rows["use_rev"]), use_rev_n=torch.tensor(rows["use_rev_n"]),
                          snr=torch.tensor(rows["snr"]), dbfs=torch.tensor(rows["dbfs"], dtype=torch.float32),
                          use_eq=torch.tensor(rows["use_eq"]), eq=eq_draws if cfg.eq_proportion > 0 else None)


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_fft_convolve_and_add_reverb_match_jax(audio):
    clean, _, rir, _ = audio
    np.testing.assert_allclose(mixer.fft_convolve(t(clean), t(rir)).numpy(),
                               np.asarray(jmixer.fft_convolve(jnp.asarray(clean), jnp.asarray(rir))),
                               rtol=0, atol=1e-5)
    rev, early = mixer.add_reverb(t(clean), t(rir))
    for i in range(B):
        jrev, jearly = jmixer.add_reverb(jnp.asarray(clean[i]), jnp.asarray(rir[i]))
        np.testing.assert_allclose(rev[i].numpy(), np.asarray(jrev), rtol=0, atol=1e-5)
        np.testing.assert_allclose(early[i].numpy(), np.asarray(jearly), rtol=0, atol=1e-5)
    assert np.abs((rev - early).numpy()).max() > 1e-3  # the late tail was cut


CONFIGS = {
    "plain": mixer.MixerConfig(snr_range=(-5, 20)),
    "reverb": mixer.MixerConfig(snr_range=(0, 10), reverb_proportion=0.5, reverb_noise_proportion=0.5),
    "loud": mixer.MixerConfig(snr_range=(30, 30), target_db_fs=-5.0, target_db_fs_floating=4.0),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mix_batch_with_jax_draws(audio, name):
    cfg = CONFIGS[name]
    clean, noise, rir, rir_noise = audio
    key = jax.random.PRNGKey(11)
    draws = draws_from_key(key, cfg)
    rirs = (rir, rir_noise) if cfg.reverb_proportion > 0 else (None, None)
    ours = mixer.mix_batch(t(clean), t(noise), cfg, draws, *(None if r is None else t(r) for r in rirs))
    theirs = jmixer.mix_batch(key, jnp.asarray(clean), jnp.asarray(noise), cfg,
                              *(None if r is None else jnp.asarray(r) for r in rirs))
    for got, want in zip(ours, theirs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if name == "reverb":
        assert 0 < int(draws.use_rev.sum()) < B and 0 < int(draws.use_rev_n.sum()) < B
    if name == "loud":  # the clipping guard acted
        assert np.abs(ours[0].numpy()).max(axis=-1).max() == pytest.approx(0.99, abs=1e-6)


def test_mix_batch_with_eq_and_jax_draws(audio):
    cfg = mixer.MixerConfig(snr_range=(0, 15), eq_proportion=0.5)
    clean, noise, _, _ = audio
    key = jax.random.PRNGKey(4)
    draws = draws_from_key(key, cfg)
    assert 0 < int(draws.use_eq.sum()) < B
    ours, target = mixer.mix_batch(t(clean), t(noise), cfg, draws)
    jnoisy, jtarget = jmixer.mix_batch(key, jnp.asarray(clean), jnp.asarray(noise), cfg)
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), rtol=0, atol=1e-5)
    b, a = tb.eq_chain_coeffs(draws.eq)  # [S, B, 3]
    for i, (k, use_eq) in enumerate(zip(jax.random.split(key, B), draws.use_eq.tolist())):
        if not use_eq:
            np.testing.assert_allclose(ours[i].numpy(), np.asarray(jnoisy[i]), rtol=0, atol=1e-5)
            continue
        clean_s, noise_s, _ = jmixer.mix_components(k, jnp.asarray(clean[i]), jnp.asarray(noise[i]), cfg)
        want = clean_s + noise_s
        for s in range(cfg.eq_filters):
            want = jb.lfilter(want, jnp.asarray(b[s, i].numpy()), jnp.asarray(a[s, i].numpy()), method="scan")
        scale = float(np.abs(np.asarray(want)).max())
        assert float(np.abs(ours[i].numpy() - np.asarray(want)).max()) < 1e-4 * scale, i


def test_mix_single_is_a_batch_of_one(audio):
    cfg = CONFIGS["reverb"]
    clean, noise, rir, rir_noise = audio
    draws = mixer.draw_mix(torch.Generator().manual_seed(2), 1, cfg)
    one = mixer.mix_single(t(clean[0]), t(noise[0]), cfg, draws, t(rir[0]), t(rir_noise[0]))
    batch = mixer.mix_batch(t(clean[:1]), t(noise[:1]), cfg, draws, t(rir[:1]), t(rir_noise[:1]))
    for got, want in zip(one, batch):
        assert torch.equal(got, want[0])


def test_own_draws_stay_in_their_ranges(audio):
    cfg = mixer.MixerConfig(snr_range=(-5, 20), target_db_fs=-25.0, target_db_fs_floating=10.0,
                            reverb_proportion=0.3, reverb_noise_proportion=0.6, eq_proportion=0.2)
    gen = torch.Generator().manual_seed(0)
    d = mixer.draw_mix(gen, 4096, cfg)
    assert d.snr.dtype == torch.int64 and set(d.snr.unique().tolist()) == set(range(-5, 21))
    assert ((d.dbfs >= -35.0) & (d.dbfs <= -15.0)).all() and float(d.dbfs.std()) > 5.0
    for flags, p in ((d.use_rev, 0.3), (d.use_rev_n, 0.6), (d.use_eq, 0.2)):
        assert abs(float(flags.float().mean()) - p) < 0.04
    assert d.eq.kind.shape == (4096, cfg.eq_filters)
    # a mix meets its draws: the noise at the row's SNR, the mix at its level
    clean, noise, _, _ = audio
    quiet = mixer.MixerConfig(snr_range=(-5, 20))
    draws = mixer.draw_mix(gen, B, quiet)
    clean_s, noise_s, _ = mixer.mix_components(t(clean), t(noise), quiet, draws)
    snr = 20 * torch.log10(clean_s.pow(2).mean(-1).sqrt() / noise_s.pow(2).mean(-1).sqrt())
    np.testing.assert_allclose(snr.numpy(), draws.snr.numpy(), atol=1e-3)
    level = 20 * torch.log10((clean_s + noise_s).pow(2).mean(-1).sqrt())
    unclipped = (clean_s + noise_s).abs().amax(-1) < 0.99
    assert unclipped.any()
    np.testing.assert_allclose(level[unclipped].numpy(), draws.dbfs[unclipped].numpy(), atol=1e-3)
