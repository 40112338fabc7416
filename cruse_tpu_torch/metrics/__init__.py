"""Objective metrics of the port: copies of ``cruse_tpu/metrics`` (SI-SDR/SDR,
STOI/ESTOI, PMOS and the native P.862 WB/NB-PESQ in numpy and scipy; the
external ``pesq`` package when it is installed), with the registry and the
composite best-model score. They score on the host."""

from cruse_tpu_torch.metrics.sisdr import si_sdr, sdr  # noqa: F401
from cruse_tpu_torch.metrics.stoi import stoi  # noqa: F401
from cruse_tpu_torch.metrics.registry import (  # noqa: F401
    REGISTERED_METRICS,
    available_metrics,
    compute_metric,
    composite_score,
)
