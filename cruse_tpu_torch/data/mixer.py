"""On-card synthetic mixing: RIR reverb, SNR scaling, dBFS jitter, EQ
(counterpart of the single-channel part of ``cruse_tpu/data/mixer.py``).

The JAX package mixes one example under ``vmap`` with its randomness split
from a key. Here a batch is mixed at once with tensor ops on its device, and
the randomness is split from the arithmetic: ``draw_mix`` makes a batch's
draws from an explicit ``torch.Generator`` (on the card, the card's
generator), and ``mix_batch`` is a deterministic function of the audio and
the draws, so a test can inject the JAX package's draws. Per row the draws
are: whether the clean speech is reverberated (``use_rev``) and the noise
(``use_rev_n``), the integer SNR, the output level in dBFS, whether the EQ
chain applies (``use_eq``) and the chain's own draws (``dsp/biquad.py``).

The multi-channel mixers (free-field delays, the image-source room, measured
array RIRs) are not ported.
"""
from __future__ import annotations

import dataclasses
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


def add_reverb(clean: torch.Tensor, rir: torch.Tensor, predelay_ms: float = 50.0, sr: int = 16000):
    """Convolve clean speech with a RIR, row by row; also return the
    early-reflection target (the RIR cut ``predelay_ms`` after its direct
    path, its largest tap). clean: [..., L], rir: [..., R]. Returns
    (reverberant, early), both [..., L]."""
    direct_idx = torch.argmax(rir.abs(), dim=-1, keepdim=True)
    early_end = direct_idx + int(predelay_ms * sr / 1000.0)
    ramp = torch.arange(rir.shape[-1], device=rir.device)
    early_rir = torch.where(ramp < early_end, rir, torch.zeros((), dtype=rir.dtype, device=rir.device))
    length = clean.shape[-1]
    return fft_convolve(clean, rir, out_len=length), fft_convolve(clean, early_rir, out_len=length)


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
    snr = torch.randint(int(cfg.snr_range[0]), int(cfg.snr_range[1]) + 1, shape, generator=generator,
                        device=device)
    lo = cfg.target_db_fs - cfg.target_db_fs_floating
    dbfs = lo + 2 * cfg.target_db_fs_floating * rand()
    use_eq = rand() < cfg.eq_proportion
    eq = draw_eq(generator, shape, cfg.eq_filters) if cfg.eq_proportion > 0 else None
    return MixDraws(use_rev=use_rev, use_rev_n=use_rev_n, snr=snr, dbfs=dbfs, use_eq=use_eq, eq=eq)


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
