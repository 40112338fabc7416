"""CRUSE + deep-filter head (counterpart of ``cruse_tpu/models/cruse_df.py``):
a magnitude mask everywhere, causal complex multi-frame filtering on the
lower bins (benchmark config 3).

The CRUSE trunk (``cruse``) enhances with a sigmoid magnitude mask; a Linear
head (``df_head``) predicts causal filter coefficients from the bottleneck
features, which refine the low bins, where phase matters most. Everything is
causal, so the model streams frame by frame: the deep filter then keeps the
last ``2*t_dim`` masked low-bin frames as its history. Both paths run the
filter through ``ops.deep_filter_kernel.deep_filter`` (one kernel launch on
the card); under a gradient its backward is a kernel too (one more launch),
and the streaming form, with its history, has none.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from cruse_tpu_torch.models.cruse import CruseConfig, CruseNet, compress_mag, cruse_init_state
from cruse_tpu_torch.models.deep_filter import lecun_normal_
from cruse_tpu_torch.ops.deep_filter_kernel import deep_filter


@dataclasses.dataclass(frozen=True)
class CruseDfConfig:
    cruse: CruseConfig = CruseConfig(emit_features=True)
    df_bins: int = 96  # lower bins refined by deep filtering
    df_taps_t: int = 2  # past time taps (causal: offsets 0..2t)
    df_taps_f: int = 1

    def __post_init__(self):
        # a config file's nested [model.args.cruse] table arrives as a dict
        if isinstance(self.cruse, dict):
            args = {k: tuple(v) if isinstance(v, list) else v for k, v in self.cruse.items()}
            object.__setattr__(self, "cruse", CruseConfig(**args))
        if not self.cruse.emit_features:
            object.__setattr__(self, "cruse", dataclasses.replace(self.cruse, emit_features=True))

    @property
    def num_taps(self) -> int:
        return (2 * self.df_taps_t + 1) * (2 * self.df_taps_f + 1)


class CruseDfNet(nn.Module):
    """feat [B, T, F] -> ((mask [B, T, F], coefs [B, T, df_bins, K, 2]), state)."""

    def __init__(self, config: CruseDfConfig = CruseDfConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        generator = generator or torch.Generator().manual_seed(0)
        self.cruse = CruseNet(config.cruse, generator=generator)
        self.df_head = nn.Linear(config.cruse.bottleneck_dim, config.df_bins * config.num_taps * 2)
        lecun_normal_(self.df_head, generator)
        # the function that applies the filter (the kernel's wrapper); the plain
        # version may be put in its place to check the kernel against it
        self.filter_fn = deep_filter

    def compress(self, mag: torch.Tensor) -> torch.Tensor:
        return compress_mag(mag, self.config.cruse)

    def init_state(self, batch_size: int, device=None, dtype=torch.float32):
        return cruse_init_state(self.config.cruse, batch_size, device, dtype)

    def forward(self, feat: torch.Tensor, state=None, train: bool = False):
        c = self.config
        (mask, feats), new_state = self.cruse(feat, state, train)
        k = c.num_taps
        coefs = self.df_head(feats).reshape(*feats.shape[:-1], c.df_bins, k, 2) / k
        return (mask, coefs), new_state


def apply_cruse_df(spec: torch.Tensor, mask: torch.Tensor, coefs: torch.Tensor,
                   cfg: CruseDfConfig, filter_fn=deep_filter) -> torch.Tensor:
    """Whole-utterance enhancement: the mask everywhere, the causal deep
    filter on the low bins. spec complex [B, T, F], mask [B, T, F], coefs
    [B, T, df_bins, K, 2]; returns complex [B, T, F]. The low bins go to the
    filter as a strided view of the masked spectrum, without a copy.
    ``filter_fn`` applies the filter (``deep_filter`` or its plain version)."""
    masked = spec * mask
    refined = filter_fn(masked[:, :, : cfg.df_bins], coefs, cfg.df_taps_t, cfg.df_taps_f,
                        causal=True)
    return torch.cat([refined, masked[:, :, cfg.df_bins :]], dim=2)


class DfStreamState(NamedTuple):
    spec_history: torch.Tensor  # [B, 2*t_dim, df_bins] complex: past masked frames, oldest first


def df_stream_init(batch_size: int, cfg: CruseDfConfig, device=None) -> DfStreamState:
    return DfStreamState(spec_history=torch.zeros(
        (batch_size, 2 * cfg.df_taps_t, cfg.df_bins), dtype=torch.complex64, device=device))


def apply_cruse_df_streaming(state: DfStreamState, spec_frame: torch.Tensor,
                             mask_frame: torch.Tensor, coef_frame: torch.Tensor,
                             cfg: CruseDfConfig, filter_fn=deep_filter):
    """One frame: spec_frame complex [B, F], mask_frame [B, F], coef_frame
    [B, df_bins, K, 2]. The filter reads the carried history for the frames
    before this one, so the frames equal ``apply_cruse_df``'s. Returns
    (enhanced frame [B, F], new state)."""
    masked = spec_frame * mask_frame
    low = masked[:, None, : cfg.df_bins]  # [B, 1, bins]
    refined = filter_fn(low, coef_frame[:, None], cfg.df_taps_t, cfg.df_taps_f, causal=True,
                        history=state.spec_history)
    enhanced = torch.cat([refined[:, 0], masked[:, cfg.df_bins :]], dim=-1)
    history = torch.cat([state.spec_history, low], dim=1)[:, 1:]
    return enhanced, DfStreamState(spec_history=history)
