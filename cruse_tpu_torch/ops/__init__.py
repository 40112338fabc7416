"""Hand-written CUDA kernels for the hot ops, each beside its plain PyTorch version."""

from cruse_tpu_torch.ops.deep_filter_kernel import deep_filter, deep_filter_reference  # noqa: F401
from cruse_tpu_torch.ops.gru_kernel import gru_sequence, gru_sequence_reference  # noqa: F401
