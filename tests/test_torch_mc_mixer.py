"""Port parity: the multi-channel mixers of cruse_tpu_torch.data.mixer (free
field, the image-source room, measured array RIRs; batched over B with
tensors) against cruse_tpu.data.mixer on the CPU, at B=4 x 4000 samples and
3 or 4 mics.

The JAX mixers draw each row's randomness from keys split off the batch's
(``jax_mc_draws`` splits them exactly as ``mix_batch_mc*`` ->
``mix_single_mc*`` -> ``room_transfers`` -> ``_sample_shoebox`` do) and
the port's ``McDraws`` carry the values those draws return: the integer SNR,
the level in dBFS, the delays and the gain jitter, the room's size, the
source's and the array's fractions, T60 and the tail's normal draws.
Tolerances: ``fractional_delay`` and the free-field mixer 1e-5 absolute;
``room_transfers`` 1e-4 of max|H| (H and mic 0's early part); the room and
measured mixes 1e-4 absolute (the outputs lie under the 0.99 clipping
guard), under every array geometry, a custom array equal to the linear one
giving the same mix, and both target modes. The port's own draws: the
delays in range with mic 0's zero, the rooms and T60 in their ranges, the
sources and arrays 0.5 m or more inside the walls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruse_tpu.data import mixer as jmixer

from cruse_tpu_torch.data import mixer

B, L, R = 4, 4000, 1600
MICS = 4
FREE_TOL, ROOM_H_TOL, MIX_TOL = 1e-5, 1e-4, 1e-4
# 0.25 s of late tail keeps the room's nfft at 8192 here
ROOM = mixer.RoomConfig(rir_seconds=0.25)
JAX_ROOM = jmixer.RoomConfig(rir_seconds=0.25)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(6)
    time = np.arange(L) / 16000
    clean = np.stack([0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * time) * (1 + np.sin(2 * np.pi * 3 * time))
                      for _ in range(B)]).astype(np.float32)
    noise = (0.1 * rng.standard_normal((B, L))).astype(np.float32)
    rirs = []
    for _ in range(2):  # speech and noise, [B, M, R] each: a direct tap a mic and a decaying tail
        r = np.zeros((B, MICS, R), np.float32)
        for i in range(B):
            base = int(rng.integers(10, 60))
            for m in range(MICS):
                d = base + 3 * m
                r[i, m, d + 1:] = 0.3 * np.exp(-np.arange(R - d - 1) / rng.uniform(200, 600)) \
                    * rng.standard_normal(R - d - 1)
                r[i, m, d] = 0.95 - 0.1 * m
        rirs.append(r)
    return clean, noise, rirs[0], rirs[1]


def _level(k_snr, k_dbfs, cfg):
    snr = int(jax.random.randint(k_snr, (), cfg.snr_range[0], cfg.snr_range[1] + 1))
    dbfs = float(jax.random.uniform(k_dbfs, (), minval=cfg.target_db_fs - cfg.target_db_fs_floating,
                                    maxval=cfg.target_db_fs + cfg.target_db_fs_floating))
    return snr, dbfs


def jax_room_draws(key, num_mics: int, room) -> dict:
    """One source's room as ``room_transfers(key, ...)`` draws it, as values."""
    k_geo, k_tail = jax.random.split(key)
    kl, ks, ka, kt = jax.random.split(k_geo, 4)
    lo = jnp.array([room.room_lx[0], room.room_ly[0], room.room_lz[0]])
    hi = jnp.array([room.room_lx[1], room.room_ly[1], room.room_lz[1]])
    return {"dims": np.asarray(jax.random.uniform(kl, (3,), minval=lo, maxval=hi)),
            "source": np.asarray(jax.random.uniform(ks, (3,))), "center": np.asarray(jax.random.uniform(ka, (3,))),
            "t60": float(jax.random.uniform(kt, (), minval=room.t60[0], maxval=room.t60[1])),
            "tail": np.asarray(jax.random.normal(k_tail, (num_mics, int(room.rir_seconds * room.sr))))
            if room.late_tail else None}


def room_draws(rows: list) -> mixer.RoomDraws:
    stack = lambda name: torch.from_numpy(np.stack([np.asarray(r[name], np.float32) for r in rows]))  # noqa: E731
    return mixer.RoomDraws(dims=stack("dims"), source=stack("source"), center=stack("center"), t60=stack("t60"),
                           tail=None if rows[0]["tail"] is None else stack("tail"))


def jax_mc_draws(key, kind: str, cfg, batch: int = B, num_mics: int = MICS, room=JAX_ROOM,
                 max_delay: float = 8.0, gain_jitter_db: float = 1.0) -> mixer.McDraws:
    """The port's draws of the JAX mixer ``kind`` ("free", "room" or "rir")
    called with ``key``: each row's key split as the JAX mixer splits it."""
    snr, dbfs, extra = [], [], {"delay_c": [], "delay_n": [], "gain_db": [], "speech": [], "noise": []}
    for k in jax.random.split(key, batch):
        if kind == "free":
            k_mix, k_dc, k_dn, k_g = jax.random.split(k, 4)
            level = _level(*jax.random.split(k_mix, 6)[2:4], cfg)
            for name, k_m, lo, hi in (("delay_c", k_dc, 0.0, max_delay), ("delay_n", k_dn, 0.0, max_delay),
                                      ("gain_db", k_g, -gain_jitter_db, gain_jitter_db)):
                extra[name].append(np.asarray(
                    jax.random.uniform(k_m, (num_mics,), minval=lo, maxval=hi).at[0].set(0.0)))
        elif kind == "room":
            k_rc, k_rn, k_snr, k_dbfs = jax.random.split(k, 4)
            level = _level(k_snr, k_dbfs, cfg)
            extra["speech"].append(jax_room_draws(k_rc, num_mics, room))
            extra["noise"].append(jax_room_draws(k_rn, num_mics, room))
        else:
            level = _level(*jax.random.split(k), cfg)
        snr.append(level[0])
        dbfs.append(level[1])
    draws = mixer.McDraws(snr=torch.tensor(snr), dbfs=torch.tensor(dbfs, dtype=torch.float32))
    if kind == "free":
        for name in ("delay_c", "delay_n", "gain_db"):
            setattr(draws, name, torch.from_numpy(np.stack(extra[name])))
    if kind == "room":
        draws.speech_room, draws.noise_room = room_draws(extra["speech"]), room_draws(extra["noise"])
    return draws


def close(got, want, tol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol, (what, err)
    return err


def test_fractional_delay_matches_jax(audio):
    clean = audio[0]
    delays = np.array([0.0, 0.37, 3.5, 7.93], np.float32)
    ours = mixer.fractional_delay(t(clean), t(delays))
    for i in range(B):
        close(ours[i].numpy(), jmixer.fractional_delay(jnp.asarray(clean[i]), delays[i]), FREE_TOL, i)
    # an integer delay is a shift
    shifted = mixer.fractional_delay(t(clean[:1]), torch.tensor([5.0]))[0].numpy()
    close(shifted[5:], clean[0, :-5], 1e-5, "shift")
    # broadcast over mics: [B, 1, L] by [B, M]
    per_mic = mixer.fractional_delay(t(clean)[:, None], t(np.tile(delays, (B, 1))))
    assert per_mic.shape == (B, MICS, L)
    close(per_mic[:, 2].numpy(), mixer.fractional_delay(t(clean), torch.full((B,), 3.5)).numpy(), 0.0, "broadcast")


MC_CONFIGS = {"plain": mixer.MixerConfig(snr_range=(-5, 20)),
              "loud": mixer.MixerConfig(snr_range=(30, 30), target_db_fs=-5.0, target_db_fs_floating=4.0)}


@pytest.mark.parametrize("name", list(MC_CONFIGS))
def test_free_field_mixer_matches_jax(audio, name):
    cfg = MC_CONFIGS[name]
    clean, noise = audio[:2]
    key = jax.random.PRNGKey(3)
    draws = jax_mc_draws(key, "free", cfg)
    ours = mixer.mix_batch_mc(t(clean), t(noise), cfg, draws)
    theirs = jmixer.mix_batch_mc(key, jnp.asarray(clean), jnp.asarray(noise), cfg, MICS)
    assert ours[0].shape == (B, MICS, L) and ours[1].shape == (B, L)
    for got, want, what in zip(ours, theirs, ("noisy", "target")):
        close(got.numpy(), want, FREE_TOL, what)
    assert float((ours[0][:, 1] - ours[0][:, 0]).abs().max()) > 1e-3  # the mics differ


def test_room_transfers_match_jax():
    key = jax.random.PRNGKey(8)
    nfft = 8192
    for k in jax.random.split(key, 2):
        h, h_early, t60 = jmixer.room_transfers(k, MICS, nfft, JAX_ROOM)
        draws = room_draws([jax_room_draws(k, MICS, JAX_ROOM)])
        ours, ours_early = mixer.room_transfers(draws, MICS, nfft, ROOM)
        assert ours.shape == (1, MICS, nfft // 2 + 1) and ours_early.shape == (1, nfft // 2 + 1)
        scale = float(np.abs(np.asarray(h)).max())
        close(ours[0].numpy(), h, ROOM_H_TOL * scale, "H")
        close(ours_early[0].numpy(), h_early, ROOM_H_TOL * float(np.abs(np.asarray(h_early)).max()), "H_early")
        assert float(draws.t60[0]) == float(t60)


GEOMETRIES = {
    "linear": {},
    "circular": dict(array_geometry="circular", array_radius=0.06),
    "custom": dict(array_geometry="custom",
                   mic_positions=((-0.05, 0.0, 0.0), (0.0, 0.01, 0.0), (0.08, 0.0, 0.02), (0.0, -0.04, 0.0))),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_room_mixer_matches_jax(audio, geometry):
    cfg = mixer.MixerConfig(snr_range=(0, 15))
    room, jroom = (dataclasses.replace(r, **GEOMETRIES[geometry]) for r in (ROOM, JAX_ROOM))
    clean, noise = audio[:2]
    key = jax.random.PRNGKey(5)
    draws = jax_mc_draws(key, "room", cfg, room=jroom)
    ours = mixer.mix_batch_mc_room(t(clean), t(noise), cfg, room, MICS, draws)
    theirs = jmixer.mix_batch_mc_room(key, jnp.asarray(clean), jnp.asarray(noise), cfg, jroom, MICS)
    assert ours[0].shape == (B, MICS, L) and ours[1].shape == (B, L)
    for got, want, what in zip(ours, theirs, ("noisy", "target")):
        close(got.numpy(), want, MIX_TOL, what)
    assert float(ours[0].abs().max()) <= 0.99 + 1e-6


def test_custom_array_equal_to_linear_gives_the_same_mix(audio):
    cfg = mixer.MixerConfig(snr_range=(0, 15))
    spacing = ROOM.mic_spacing
    custom = dataclasses.replace(ROOM, array_geometry="custom", mic_positions=tuple(
        ((m - (MICS - 1) / 2) * spacing, 0.0, 0.0) for m in range(MICS)))
    clean, noise = audio[:2]
    draws = mixer.draw_mc_room(torch.Generator().manual_seed(1), B, MICS, ROOM, cfg)
    linear = mixer.mix_batch_mc_room(t(clean), t(noise), cfg, ROOM, MICS, draws)
    other = mixer.mix_batch_mc_room(t(clean), t(noise), cfg, custom, MICS, draws)
    for a, b in zip(linear, other):
        close(a.numpy(), b.numpy(), 1e-6, "custom = linear")
    with pytest.raises(ValueError, match=r"mic_positions must be \[3, 3\]"):
        mixer.mix_batch_mc_room(t(clean), t(noise), cfg, custom, 3, mixer.draw_mc_room(
            torch.Generator().manual_seed(1), B, 3, ROOM, cfg))


@pytest.mark.parametrize("early", [True, False], ids=["early_target", "reverberant_target"])
def test_room_mixer_target_modes(audio, early):
    """``use_early_reverb_target`` off: mic 0's reverberant speech is the target."""
    cfg = mixer.MixerConfig(snr_range=(5, 5), use_early_reverb_target=early)
    room = dataclasses.replace(ROOM, late_tail=False)
    jroom = dataclasses.replace(JAX_ROOM, late_tail=False)
    clean, noise = audio[:2]
    key = jax.random.PRNGKey(12)
    ours = mixer.mix_batch_mc_room(t(clean), t(noise), cfg, room, 3, jax_mc_draws(key, "room", cfg, num_mics=3,
                                                                                   room=jroom))
    theirs = jmixer.mix_batch_mc_room(key, jnp.asarray(clean), jnp.asarray(noise), cfg, jroom, 3)
    for got, want, what in zip(ours, theirs, ("noisy", "target")):
        close(got.numpy(), want, MIX_TOL, what)


@pytest.mark.parametrize("early", [True, False], ids=["early_target", "reverberant_target"])
def test_measured_rir_mixer_matches_jax(audio, early):
    cfg = mixer.MixerConfig(snr_range=(-5, 10), use_early_reverb_target=early)
    clean, noise, rir_c, rir_n = audio
    key = jax.random.PRNGKey(9)
    draws = jax_mc_draws(key, "rir", cfg)
    ours = mixer.mix_batch_mc_rir(t(clean), t(noise), cfg, draws, t(rir_c), t(rir_n))
    theirs = jmixer.mix_batch_mc_rir(key, jnp.asarray(clean), jnp.asarray(noise), cfg, jnp.asarray(rir_c),
                                     jnp.asarray(rir_n))
    for got, want, what in zip(ours, theirs, ("noisy", "target")):
        close(got.numpy(), want, MIX_TOL, what)
    if early:  # the early target lacks the tail that the reverberant mic 0 carries
        late = mixer.mix_batch_mc_rir(t(clean), t(noise), dataclasses.replace(cfg, use_early_reverb_target=False),
                                      draws, t(rir_c), t(rir_n))[1]
        assert float((late - ours[1]).abs().max()) > 1e-3


def test_own_draws_stay_in_their_ranges():
    cfg = mixer.MixerConfig(snr_range=(-5, 20))
    gen = torch.Generator().manual_seed(0)
    free = mixer.draw_mc(gen, 512, MICS, cfg, max_delay=6.0, gain_jitter_db=2.0)
    for name, lo, hi in (("delay_c", 0.0, 6.0), ("delay_n", 0.0, 6.0), ("gain_db", -2.0, 2.0)):
        x = getattr(free, name)
        assert x.shape == (512, MICS) and bool((x[:, 0] == 0).all()), name
        assert bool(((x[:, 1:] >= lo) & (x[:, 1:] <= hi)).all()) and float(x[:, 1:].std()) > 0.2 * (hi - lo), name
    assert set(free.snr.unique().tolist()) == set(range(-5, 21))
    assert bool(((free.dbfs >= -35.0) & (free.dbfs <= -15.0)).all())

    room = mixer.draw_mc_room(gen, 512, MICS, ROOM, cfg)
    for source in (room.speech_room, room.noise_room):
        for axis, (lo, hi) in enumerate((ROOM.room_lx, ROOM.room_ly, ROOM.room_lz)):
            dims = source.dims[:, axis]
            assert bool(((dims >= lo) & (dims <= hi)).all()) and float(dims.max() - dims.min()) > 0.8 * (hi - lo)
        assert bool(((source.t60 >= ROOM.t60[0]) & (source.t60 <= ROOM.t60[1])).all())
        assert source.tail.shape == (512, MICS, int(ROOM.rir_seconds * ROOM.sr))
        positions, _, mics = mixer._sample_shoebox(source, MICS, ROOM)
        direct = positions[:, 2 * 36 + 2 * 6 + 2]  # q = 0 and the sign +1 on every axis: the source itself
        center = mics.mean(dim=1)
        for point in (direct, center):
            assert bool(((point >= 0.5 - 1e-5) & (point <= source.dims - 0.5 + 1e-5)).all())
        assert torch.allclose(direct, source.source * (source.dims - 1.0) + 0.5)
    # the same sequence of draws for a config, whatever the batch holds
    a = mixer.draw_mc_rir(torch.Generator().manual_seed(4), 8, cfg)
    b = mixer.draw_mc_rir(torch.Generator().manual_seed(4), 8, cfg)
    assert torch.equal(a.snr, b.snr) and torch.equal(a.dbfs, b.dbfs)
