"""Multi-channel CRUSE (counterpart of ``cruse_tpu/models/mc_cruse.py``):
directional features -> a learned linear front end -> the CRUSE trunk ->
a mask for the reference channel.

The features (``dsp/features.py::directional_features_from_ri``: the
normalized log power of the reference mic and the cos (and sin) IPD of each
mic pair, ``[B, T, D]``) are projected to the trunk's frequency width by
``spatial_proj`` (a Linear), passed through a PReLU with one slope
(``PReLU_0``), and enhanced by the port's ``CruseNet`` under the name
``cruse``. The submodules carry the flax names, so ``utils/weights.py``'s
CRUSE mapping takes the whole tree (``spatial_proj/kernel`` -> a Linear
weight, ``PReLU_0/negative_slope``, ``cruse/…``). Everything after the
projection is the CRUSE trunk, so the streaming state is CRUSE's, and on the
card a forward or a hop launches the grouped-GRU kernel twice (one a bank).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from cruse_tpu_torch.models.cruse import CruseConfig, CruseNet, cruse_init_state
from cruse_tpu_torch.models.deep_filter import lecun_normal_
from cruse_tpu_torch.models.mtfaa import PReLUc


@dataclasses.dataclass(frozen=True)
class McCruseConfig:
    mic_pairs: Tuple[Tuple[int, int], ...] = ((0, 1), (0, 2), (0, 3))
    use_sin_ipd: bool = False
    reference_channel: int = 0
    cruse: CruseConfig = CruseConfig(in_freq=161)
    cruse_args: Optional[dict] = None  # a config file's [model.args.cruse_args] table: builds ``cruse``

    def __post_init__(self):
        object.__setattr__(self, "mic_pairs", tuple(tuple(p) for p in self.mic_pairs))
        if self.cruse_args is not None:
            args = {k: tuple(v) if isinstance(v, list) else v for k, v in self.cruse_args.items()}
            object.__setattr__(self, "cruse", CruseConfig(**args))
            object.__setattr__(self, "cruse_args", None)

    @property
    def num_mics(self) -> int:
        return max(max(p) for p in self.mic_pairs) + 1

    @property
    def feature_dim(self) -> int:
        f = self.cruse.in_freq
        return f + len(self.mic_pairs) * f * (1 + int(self.use_sin_ipd))


class McCruseNet(nn.Module):
    """Directional features ``[B, T, D]`` -> (mask ``[B, T, F]`` for the
    reference channel, state), D = ``McCruseConfig.feature_dim``. The weights
    are made from ``generator``: ``spatial_proj`` lecun-normal with a zero
    bias, the slope 0.01, the trunk as ``CruseNet`` makes it."""

    def __init__(self, config: McCruseConfig = McCruseConfig(), generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        generator = generator or torch.Generator().manual_seed(0)
        self.spatial_proj = nn.Linear(config.feature_dim, config.cruse.in_freq)
        lecun_normal_(self.spatial_proj, generator)
        self.PReLU_0 = PReLUc(0.01)
        self.cruse = CruseNet(config.cruse, generator=generator)

    def compress(self, feats: torch.Tensor) -> torch.Tensor:
        return feats  # the features are normalized already

    def forward(self, feats: torch.Tensor, state=None, train: bool = False):
        if feats.shape[-1] != self.config.feature_dim:
            raise ValueError(f"feats has {feats.shape[-1]} features, the model takes {self.config.feature_dim}")
        return self.cruse(self.PReLU_0(self.spatial_proj(feats)), state, train)

    def init_state(self, batch_size: int, device: torch.device | str | None = None):
        return cruse_init_state(self.config.cruse, batch_size, device)
