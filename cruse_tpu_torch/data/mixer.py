"""On-card synthetic mixing: RIR reverb, SNR scaling, dBFS jitter, EQ, and
the multi-channel mixers (counterpart of ``cruse_tpu/data/mixer.py``).

The JAX package mixes one example under ``vmap`` with its randomness split
from a key. Here a batch is mixed at once with tensor ops on its device, and
the randomness is split from the arithmetic: ``draw_mix`` makes a batch's
draws from an explicit ``torch.Generator`` (on the card, the card's
generator), and ``mix_batch`` is a deterministic function of the audio and
the draws, so a test can inject the JAX package's draws. Per row the draws
are: whether the clean speech is reverberated (``use_rev``) and the noise
(``use_rev_n``), the integer SNR, the output level in dBFS, whether the EQ
chain applies (``use_eq``) and the chain's own draws (``dsp/biquad.py``).

The multi-channel mixers make ``(noisy [B, M, L], target [B, L])``, mic 0
the reference, with draws split the same way (``McDraws``):

- ``mix_batch_mc``, free field: each mic hears the clean and noise
  components of ``mix_components`` with its own fractional delays and a gain
  jitter (mic 0 undelayed at unit gain); draws: the SNR, the level, the
  delays and the jitter;
- ``mix_batch_mc_room``, the image-source room: speech and noise are two
  sources in one random shoebox (``RoomConfig``), each mic's transfer
  function summed over the images as phase ramps, plus a decaying random
  late tail; the target is the early part at mic 0; draws: per source the
  room, the source and array positions, T60 and the tail, then the SNR and
  the level;
- ``mix_batch_mc_rir``, measured array RIRs ``[B, M, R]`` per source; draws:
  the SNR and the level.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from cruse_tpu_torch.dsp.biquad import EqDraws, draw_eq, eq_chain_from_draws


def fft_convolve(x: torch.Tensor, h: torch.Tensor, out_len: int | None = None) -> torch.Tensor:
    """Linear convolution along the last axis via the rFFT. x: [..., L],
    h: [..., R]."""
    n = x.shape[-1] + h.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(h, nfft), nfft)[..., :n]
    return y if out_len is None else y[..., :out_len]


def early_part(rir: torch.Tensor, predelay_ms: float, sr: int) -> torch.Tensor:
    """The RIR cut ``predelay_ms`` after its direct path (its largest tap, the
    first of equals), row by row. rir: [..., R]."""
    direct_idx = torch.argmax(rir.abs(), dim=-1, keepdim=True)
    early_end = direct_idx + int(predelay_ms * sr / 1000.0)
    ramp = torch.arange(rir.shape[-1], device=rir.device)
    return torch.where(ramp < early_end, rir, torch.zeros((), dtype=rir.dtype, device=rir.device))


def add_reverb(clean: torch.Tensor, rir: torch.Tensor, predelay_ms: float = 50.0, sr: int = 16000):
    """Convolve clean speech with a RIR, row by row; also return the
    early-reflection target (``early_part`` of the RIR). clean: [..., L],
    rir: [..., R]. Returns (reverberant, early), both [..., L]."""
    length = clean.shape[-1]
    return (fft_convolve(clean, rir, out_len=length),
            fft_convolve(clean, early_part(rir, predelay_ms, sr), out_len=length))


@dataclasses.dataclass(frozen=True)
class MixerConfig:
    sr: int = 16000
    snr_range: tuple = (-5, 20)
    target_db_fs: float = -25.0
    target_db_fs_floating: float = 10.0
    reverb_proportion: float = 0.0
    reverb_noise_proportion: float = 0.0
    predelay_ms: float = 50.0
    use_early_reverb_target: bool = True
    eq_proportion: float = 0.0  # random biquad chain on the noisy mix
    eq_filters: int = 3
    clip_threshold: float = 0.99
    eps: float = 1e-7


@dataclasses.dataclass
class MixDraws:
    """A batch's draws, [B] each; ``eq`` is [B, eq_filters] or None when the
    config applies no EQ."""

    use_rev: torch.Tensor
    use_rev_n: torch.Tensor
    snr: torch.Tensor
    dbfs: torch.Tensor
    use_eq: torch.Tensor
    eq: Optional[EqDraws] = None


def draw_mix(generator: torch.Generator, batch_size: int, cfg: MixerConfig) -> MixDraws:
    """The draws of one batch from ``generator``, on its device: Bernoulli
    reverb and EQ flags at their proportions, the SNR uniform over the
    integers of ``snr_range`` (both ends included), the level uniform in
    ``target_db_fs +- target_db_fs_floating``. Always the same sequence of
    draws for a config, whatever the batch holds."""
    device, shape = generator.device, (batch_size,)

    def rand():
        return torch.rand(shape, generator=generator, device=device)

    use_rev, use_rev_n = rand() < cfg.reverb_proportion, rand() < cfg.reverb_noise_proportion
    snr, dbfs = _draw_level(generator, batch_size, cfg)
    use_eq = rand() < cfg.eq_proportion
    eq = draw_eq(generator, shape, cfg.eq_filters) if cfg.eq_proportion > 0 else None
    return MixDraws(use_rev=use_rev, use_rev_n=use_rev_n, snr=snr, dbfs=dbfs, use_eq=use_eq, eq=eq)


def _draw_level(generator: torch.Generator, batch_size: int, cfg: MixerConfig):
    """(snr, dbfs), [B] each: the SNR uniform over the integers of
    ``snr_range`` (both ends included), the level uniform in ``target_db_fs
    +- target_db_fs_floating``."""
    device = generator.device
    snr = torch.randint(int(cfg.snr_range[0]), int(cfg.snr_range[1]) + 1, (batch_size,), generator=generator,
                        device=device)
    lo = cfg.target_db_fs - cfg.target_db_fs_floating
    return snr, lo + 2 * cfg.target_db_fs_floating * torch.rand((batch_size,), generator=generator, device=device)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True))


def _peak(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax(dim=-1, keepdim=True)


def mix_components(clean: torch.Tensor, noise: torch.Tensor, cfg: MixerConfig, draws: MixDraws,
                   rir: torch.Tensor | None = None, rir_noise: torch.Tensor | None = None):
    """The mixing up to (scaled clean, scaled noise, target), [B, L] each;
    noisy = clean_s + noise_s."""
    eps = cfg.eps
    target = clean
    if rir is not None:
        reverberant, early = add_reverb(clean, rir, cfg.predelay_ms, cfg.sr)
        use_rev = draws.use_rev[:, None]
        clean = torch.where(use_rev, reverberant, clean)
        target = torch.where(use_rev, early if cfg.use_early_reverb_target else reverberant, target)
    if rir_noise is not None:
        rev_noise = fft_convolve(noise, rir_noise, out_len=noise.shape[-1])
        noise = torch.where(draws.use_rev_n[:, None], rev_noise, noise)

    # peak normalisation (the target scales with the clean signal)
    clean_peak = _peak(clean) + eps
    clean, target = clean / clean_peak, target / clean_peak
    noise = noise / (_peak(noise) + eps)

    snr = draws.snr.to(torch.float32)[:, None]
    noise = noise * (_rms(clean) / (10.0 ** (snr / 20.0)) / (_rms(noise) + eps))
    noisy = clean + noise

    # random output level
    scalar = 10.0 ** (draws.dbfs.to(torch.float32)[:, None] / 20.0) / (_rms(noisy) + eps)
    noisy, target = noisy * scalar, target * scalar

    # clipping guard
    peak = _peak(noisy)
    fix = torch.where(peak > cfg.clip_threshold, cfg.clip_threshold / (peak + eps), torch.ones_like(peak))
    return clean * scalar * fix, noise * scalar * fix, target * fix


def mix_batch(clean: torch.Tensor, noise: torch.Tensor, cfg: MixerConfig, draws: MixDraws,
              rir: torch.Tensor | None = None, rir_noise: torch.Tensor | None = None):
    """Mix a batch: clean, noise [B, L] (rir, rir_noise [B, R], zero-padded
    to one length) -> (noisy [B, L], target [B, L]).

      1. optional reverb on clean (``use_rev``); the target stays the
         early-reflection signal when configured;
      2. optional reverb on noise (``use_rev_n``);
      3. peak-normalise both; scale the noise to the row's SNR by RMS;
      4. scale to the row's dBFS;
      5. clipping guard: rescale all if |noisy| exceeds the threshold;
      6. optional EQ chain on the noisy signal (``use_eq``).
    """
    clean_s, noise_s, target = mix_components(clean, noise, cfg, draws, rir, rir_noise)
    noisy = clean_s + noise_s
    if cfg.eq_proportion > 0:
        noisy = torch.where(draws.use_eq[:, None], eq_chain_from_draws(noisy, draws.eq, cfg.sr), noisy)
    return noisy, target


def mix_single(clean: torch.Tensor, noise: torch.Tensor, cfg: MixerConfig, draws: MixDraws,
               rir: torch.Tensor | None = None, rir_noise: torch.Tensor | None = None):
    """One example, [L] each (draws of a batch of 1): (noisy [L], target [L])."""
    rows = [None if r is None else r[None] for r in (rir, rir_noise)]
    noisy, target = mix_batch(clean[None], noise[None], cfg, draws, *rows)
    return noisy[0], target[0]


# ---------------- multi-channel mixers ----------------


@dataclasses.dataclass(frozen=True)
class RoomConfig:
    """Random shoebox rooms for ``mix_batch_mc_room``: the image-source model
    (Allen and Berkley) up to ``max_order`` reflections an axis, summed
    exactly in the frequency domain (fractional delays as phase ramps), plus
    an optional decorrelated late tail decaying at the drawn T60. The array:
    ``linear`` along x at ``mic_spacing``, ``circular`` of ``array_radius``
    in the xy-plane (mic 0 at azimuth 0), or ``custom``, the offsets
    ``mic_positions`` ((x, y, z), ...) from the array's centre, in metres."""

    sr: int = 16000
    room_lx: tuple = (4.0, 8.0)
    room_ly: tuple = (3.0, 6.0)
    room_lz: tuple = (2.4, 3.5)
    t60: tuple = (0.2, 0.6)
    max_order: int = 1  # images an axis: 2 (2 order + 1); order 1 -> 216 in all
    mic_spacing: float = 0.05
    array_geometry: str = "linear"  # "linear" | "circular" | "custom"
    array_radius: float = 0.05
    mic_positions: tuple = ()
    rir_seconds: float = 0.4
    late_tail: bool = True
    c: float = 343.0


@dataclasses.dataclass
class RoomDraws:
    """One source's rooms, a row each: the room's size ``dims`` [N, 3] in
    metres, the source's and the array centre's positions as fractions of
    the room's interior (``source``, ``center`` [N, 3], in [0, 1)), ``t60``
    [N] in seconds, and the late tail's normal draws [N, M, rir_seconds sr]
    (None without a tail)."""

    dims: torch.Tensor
    source: torch.Tensor
    center: torch.Tensor
    t60: torch.Tensor
    tail: Optional[torch.Tensor] = None


@dataclasses.dataclass
class McDraws:
    """A multi-channel batch's draws: the integer SNR and the level in dBFS,
    [B] each, and the mixer's own. Free field: the clean and the noise
    component's delays in samples and the gain jitter in dB, [B, M] each,
    mic 0's zero. Room: a ``RoomDraws`` for the speech and one for the
    noise."""

    snr: torch.Tensor
    dbfs: torch.Tensor
    delay_c: Optional[torch.Tensor] = None
    delay_n: Optional[torch.Tensor] = None
    gain_db: Optional[torch.Tensor] = None
    speech_room: Optional[RoomDraws] = None
    noise_room: Optional[RoomDraws] = None


# float32(-2 pi), the first factor of every phase ramp, as the JAX package rounds it
_MINUS_TWO_PI = -2.0 * math.pi
IMAGE_CHUNK = 24  # images summed at once: the memory of a chunk is [N, 24, M, bins]


def _omega(nfft: int, device) -> torch.Tensor:
    """-2 pi f in float32 for the rFFT bins f of ``nfft`` (cycles a sample)."""
    return torch.tensor(_MINUS_TWO_PI, dtype=torch.float32, device=device) * torch.fft.rfftfreq(nfft, device=device)


def _irfft(spec: torch.Tensor, nfft: int) -> torch.Tensor:
    """``irfft`` of a spectrum whose DC and Nyquist bins may hold an
    imaginary part (a phase ramp gives them one): that part is dropped, as
    the CPU's c2r transform drops it and cuFFT's does not. nfft is even."""
    spec = spec.clone()
    spec.imag[..., 0] = 0.0
    spec.imag[..., -1] = 0.0
    return torch.fft.irfft(spec, nfft)


def fractional_delay(x: torch.Tensor, delay: torch.Tensor) -> torch.Tensor:
    """Delay x [..., L] by ``delay`` samples (fractional delays too; [...],
    broadcast against x's leading dimensions) through the rFFT phase ramp,
    zero-padded to ``nfft = 1 << (L + 63).bit_length()`` so that nothing
    wraps around."""
    length = x.shape[-1]
    nfft = 1 << (length + 63).bit_length()
    theta = _omega(nfft, x.device) * delay[..., None]
    return _irfft(torch.fft.rfft(x, nfft) * torch.complex(torch.cos(theta), torch.sin(theta)), nfft)[..., :length]


def draw_mc(generator: torch.Generator, batch_size: int, num_mics: int, cfg: MixerConfig,
            max_delay: float = 8.0, gain_jitter_db: float = 1.0) -> McDraws:
    """The free-field mixer's draws of one batch from ``generator``, on its
    device: the SNR and the level, then the clean and the noise delays,
    uniform in [0, max_delay], and the gain jitter, uniform in +-
    gain_jitter_db; mic 0's set to zero."""
    snr, dbfs = _draw_level(generator, batch_size, cfg)

    def per_mic(lo: float, hi: float) -> torch.Tensor:
        x = lo + (hi - lo) * torch.rand((batch_size, num_mics), generator=generator, device=generator.device)
        x[:, 0] = 0.0
        return x

    return McDraws(snr=snr, dbfs=dbfs, delay_c=per_mic(0.0, max_delay), delay_n=per_mic(0.0, max_delay),
                   gain_db=per_mic(-gain_jitter_db, gain_jitter_db))


def mix_batch_mc(clean: torch.Tensor, noise: torch.Tensor, cfg: MixerConfig, draws: McDraws):
    """The free-field mixture: clean, noise [B, L] -> (noisy [B, M, L], target
    [B, L]). ``mix_components`` scales both components and the target; each
    mic hears the clean and the noise component with its own fractional
    delays and gain, ``g (delay(clean, d_c) + delay(noise, d_n))``."""
    clean_s, noise_s, target = mix_components(clean, noise, cfg, draws)
    gain = 10.0 ** (draws.gain_db / 20.0)
    mics = fractional_delay(clean_s[:, None], draws.delay_c) + fractional_delay(noise_s[:, None], draws.delay_n)
    return gain[..., None] * mics, target


def _array_offsets(num_mics: int, room: RoomConfig, device) -> torch.Tensor:
    """The mics' offsets [M, 3] from the array's centre."""
    index = torch.arange(num_mics, dtype=torch.float32, device=device)
    zeros = torch.zeros_like(index)
    if room.array_geometry == "linear":
        offsets = (index - (num_mics - 1) / 2.0) * room.mic_spacing
        return torch.stack([offsets, zeros, zeros], dim=-1)
    if room.array_geometry == "circular":
        azimuth = 2.0 * math.pi * index / num_mics
        return torch.stack([room.array_radius * torch.cos(azimuth), room.array_radius * torch.sin(azimuth), zeros],
                           dim=-1)
    if room.array_geometry == "custom":
        positions = torch.tensor(room.mic_positions, dtype=torch.float32, device=device)
        if tuple(positions.shape) != (num_mics, 3):
            raise ValueError(f"mic_positions must be [{num_mics}, 3] (x, y, z) offsets, got "
                             f"{tuple(positions.shape)}")
        return positions
    raise ValueError(f"unknown array_geometry {room.array_geometry!r}")


def draw_room(generator: torch.Generator, batch_size: int, num_mics: int, room: RoomConfig) -> RoomDraws:
    """One source's rooms for a batch from ``generator``, on its device: the
    size uniform in the configured ranges, the source's and the array's
    fractions uniform in [0, 1), T60 uniform in its range, and the tail's
    normal draws."""
    device = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    lo = torch.tensor([room.room_lx[0], room.room_ly[0], room.room_lz[0]], device=device)
    hi = torch.tensor([room.room_lx[1], room.room_ly[1], room.room_lz[1]], device=device)
    dims = lo + (hi - lo) * rand(batch_size, 3)
    source, center = rand(batch_size, 3), rand(batch_size, 3)
    t60 = room.t60[0] + (room.t60[1] - room.t60[0]) * rand(batch_size)
    tail = (torch.randn((batch_size, num_mics, int(room.rir_seconds * room.sr)), generator=generator, device=device)
            if room.late_tail else None)
    return RoomDraws(dims=dims, source=source, center=center, t60=t60, tail=tail)


def draw_mc_room(generator: torch.Generator, batch_size: int, num_mics: int, room: RoomConfig,
                 cfg: MixerConfig) -> McDraws:
    """The room mixer's draws of one batch: the speech's rooms, the noise's,
    then the SNR and the level."""
    speech_room = draw_room(generator, batch_size, num_mics, room)
    noise_room = draw_room(generator, batch_size, num_mics, room)
    snr, dbfs = _draw_level(generator, batch_size, cfg)
    return McDraws(snr=snr, dbfs=dbfs, speech_room=speech_room, noise_room=noise_room)


def draw_mc_rir(generator: torch.Generator, batch_size: int, cfg: MixerConfig) -> McDraws:
    """The measured-RIR mixer's draws of one batch: the SNR and the level."""
    snr, dbfs = _draw_level(generator, batch_size, cfg)
    return McDraws(snr=snr, dbfs=dbfs)


def _sample_shoebox(draws: RoomDraws, num_mics: int, room: RoomConfig):
    """The image sources of each row's room: (positions [N, Ni, 3],
    amplitudes [N, Ni], mic positions [N, M, 3]). The source and the array's
    centre lie 0.5 m or more inside the walls; the walls' reflection
    coefficient follows from T60 by Sabine's formula."""
    dims, device = draws.dims, draws.dims.device
    source = draws.source * (dims - 1.0) + 0.5
    center = draws.center * (dims - 1.0) + 0.5
    mics = center[:, None, :] + _array_offsets(num_mics, room, device)[None]
    volume = dims[:, 0] * dims[:, 1] * dims[:, 2]
    surface = 2.0 * (dims[:, 0] * dims[:, 1] + dims[:, 0] * dims[:, 2] + dims[:, 1] * dims[:, 2])
    absorption = torch.clamp(0.161 * volume / (surface * draws.t60), 0.01, 0.99)
    beta = torch.sqrt(1.0 - absorption)

    n = room.max_order
    q = torch.arange(-n, n + 1, device=device).repeat_interleave(2)  # wall-pair index
    sign = torch.tensor([1.0, -1.0], device=device).repeat(2 * n + 1)
    # per axis the images sign * s + 2 q l, reflected |2q| (sign +1) or |2q - 1| (sign -1) times
    reflections = torch.where(sign > 0, (2 * q).abs(), (2 * q - 1).abs())
    axes = [sign * source[:, i, None] + (2.0 * q.to(torch.float32)) * dims[:, i, None] for i in range(3)]
    na = sign.shape[0]
    grid = torch.arange(na, device=device)
    ii = grid.repeat_interleave(na * na)
    jj = grid.repeat_interleave(na).repeat(na)
    kk = grid.repeat(na * na)
    positions = torch.stack([axes[0][:, ii], axes[1][:, jj], axes[2][:, kk]], dim=-1)
    amplitudes = beta[:, None] ** (reflections[ii] + reflections[jj] + reflections[kk])
    return positions, amplitudes, mics


def room_transfers(draws: RoomDraws, num_mics: int, nfft: int, room: RoomConfig, early_ms: float = 50.0):
    """Each mic's transfer function for one source a row: (H [N, M, F], mic
    0's early part H_early [N, F]: the images that arrive within
    ``early_ms`` of the direct path). Each image adds ``g exp(-2 pi i f d)``
    at its delay d (samples) with the gain ``beta^reflections / (4 pi
    max(distance, 0.1))``, IMAGE_CHUNK images at a time; the late tail's
    spectrum is added to H."""
    positions, amplitudes, mics = _sample_shoebox(draws, num_mics, room)
    diff = positions[:, :, None, :] - mics[:, None, :, :]  # [N, Ni, M, 3]
    dist = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2])
    sr = room.sr
    delay = dist / room.c * sr
    gain = amplitudes[:, :, None] / ((4.0 * math.pi) * torch.clamp(dist, min=0.1))
    rows = torch.arange(dist.shape[0], device=dist.device)
    direct_delay = delay[rows, torch.argmin(dist[:, :, 0], dim=1), 0]
    early_cut = direct_delay + early_ms * sr / 1000.0

    omega = _omega(nfft, dist.device)
    bins = omega.shape[0]
    h_re = dist.new_zeros((dist.shape[0], num_mics, bins))
    h_im = torch.zeros_like(h_re)
    e_re = dist.new_zeros((dist.shape[0], bins))
    e_im = torch.zeros_like(e_re)
    for start in range(0, delay.shape[1], IMAGE_CHUNK):
        d = delay[:, start : start + IMAGE_CHUNK]
        g = gain[:, start : start + IMAGE_CHUNK]
        theta = omega * d[..., None]  # [N, chunk, M, F]
        cos, sin = torch.cos(theta), torch.sin(theta)
        h_re += (g[..., None] * cos).sum(dim=1)
        h_im += (g[..., None] * sin).sum(dim=1)
        early = g[..., 0] * (d[..., 0] <= early_cut[:, None]).to(torch.float32)
        e_re += (early[..., None] * cos[:, :, 0]).sum(dim=1)
        e_im += (early[..., None] * sin[:, :, 0]).sum(dim=1)
        del theta, cos, sin
    h = torch.complex(h_re, h_im)
    if room.late_tail:
        # starting after the last image of the order could land, its energy a
        # continuation of the images' mean gain
        t = torch.arange(int(room.rir_seconds * sr), dtype=torch.float32, device=dist.device) / sr
        begin = (direct_delay / sr + 0.012 * (2 * room.max_order + 1))[:, None]
        envelope = (torch.exp(-6.908 * torch.clamp(t - begin, min=0.0) / draws.t60[:, None])
                    * (t >= begin).to(torch.float32))
        mean_gain = gain.mean(dim=(1, 2))
        h = h + torch.fft.rfft((mean_gain[:, None] * envelope)[:, None, :] * draws.tail, nfft)
    return h, torch.complex(e_re, e_im)


def _finish_mc_mix(draws: McDraws, rev_c: torch.Tensor, rev_n: torch.Tensor, target: torch.Tensor,
                   cfg: MixerConfig):
    """The multi-channel mixing's tail: the noise scaled to the row's SNR at
    the reference mic, the row's level set there, the clipping guard over all
    mics. rev_c, rev_n [B, M, L], target [B, L]."""
    eps = cfg.eps
    snr = draws.snr.to(torch.float32)[:, None]
    snr_scalar = _rms(rev_c[:, 0]) / (10.0 ** (snr / 20.0)) / (_rms(rev_n[:, 0]) + eps)
    noisy = rev_c + rev_n * snr_scalar[:, :, None]
    scalar = 10.0 ** (draws.dbfs.to(torch.float32)[:, None] / 20.0) / (_rms(noisy[:, 0]) + eps)
    noisy, target = noisy * scalar[:, :, None], target * scalar
    peak = noisy.abs().amax(dim=(1, 2))[:, None]
    fix = torch.where(peak > cfg.clip_threshold, cfg.clip_threshold / (peak + eps), torch.ones_like(peak))
    return noisy * fix[:, :, None], target * fix


def mix_batch_mc_room(clean: torch.Tensor, noise: torch.Tensor, cfg: MixerConfig, room: RoomConfig,
                      num_mics: int, draws: McDraws):
    """The image-source mixture: clean, noise [B, L] -> (noisy [B, M, L],
    target [B, L]). Speech and noise are two sources in the row's room; the
    target is the early part (direct path + ``predelay_ms``) of the speech
    at mic 0, or with ``use_early_reverb_target`` off mic 0's reverberant
    speech; the SNR and the level are set at mic 0."""
    length, eps = clean.shape[-1], cfg.eps
    nfft = 1 << (length + int(room.rir_seconds * room.sr) - 1).bit_length()
    clean = clean / (_peak(clean) + eps)
    noise = noise / (_peak(noise) + eps)
    h_c, h_c_early = room_transfers(draws.speech_room, num_mics, nfft, room, cfg.predelay_ms)
    h_n, _ = room_transfers(draws.noise_room, num_mics, nfft, room, cfg.predelay_ms)
    spec_c = torch.fft.rfft(clean, nfft)
    rev_c = _irfft(spec_c[:, None] * h_c, nfft)[..., :length]
    rev_n = _irfft(torch.fft.rfft(noise, nfft)[:, None] * h_n, nfft)[..., :length]
    target = _irfft(spec_c * h_c_early, nfft)[..., :length] if cfg.use_early_reverb_target else rev_c[:, 0]
    return _finish_mc_mix(draws, rev_c, rev_n, target, cfg)


def mix_batch_mc_rir(clean: torch.Tensor, noise: torch.Tensor, cfg: MixerConfig, draws: McDraws,
                     rir_c: torch.Tensor, rir_n: torch.Tensor):
    """The mixture through measured array RIRs: clean, noise [B, L], rir_c,
    rir_n [B, M, R] (the speech's and the noise's, one channel a mic) ->
    (noisy [B, M, L], target [B, L]). The target is the speech through
    ``early_part`` of mic 0's RIR, or with ``use_early_reverb_target`` off
    mic 0's reverberant speech; the SNR and the level are set at mic 0."""
    length, eps = clean.shape[-1], cfg.eps
    clean = clean / (_peak(clean) + eps)
    noise = noise / (_peak(noise) + eps)
    rev_c = fft_convolve(clean[:, None], rir_c, out_len=length)
    rev_n = fft_convolve(noise[:, None], rir_n, out_len=length)
    target = (fft_convolve(clean, early_part(rir_c[:, 0], cfg.predelay_ms, cfg.sr), out_len=length)
              if cfg.use_early_reverb_target else rev_c[:, 0])
    return _finish_mc_mix(draws, rev_c, rev_n, target, cfg)
