"""cruse_tpu_torch: the PyTorch + CUDA port of cruse_tpu, for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference each module is
tested against, and mirrors its module paths:

- ``cruse_tpu_torch.dsp``    -- STFT/iSTFT (torch.stft/istft; the JAX overlap-add
  for center=False), windows, the windowed DFT bases
- ``cruse_tpu_torch.ops``    -- hand-written CUDA kernels with their plain versions
  (grouped-GRU recurrence, deep filter)
- ``cruse_tpu_torch.nn``     -- causal conv block, grouped GRU bottleneck, int8 weights
- ``cruse_tpu_torch.models`` -- CRUSE, CRUSE+DF, DFSMN, MTFAA, the deep filter
- ``cruse_tpu_torch.train``  -- the forward adapters (eval mode)
- ``cruse_tpu_torch.infer``  -- batch and streaming inference, serving, export artifacts, and their CLIs
- ``cruse_tpu_torch.data``   -- wav IO
- ``cruse_tpu_torch.utils``  -- the weight bridge from flax variables

The package imports torch and numpy, never jax or flax. From cruse_tpu it
shares only the jax-free ``cruse_tpu.utils`` (config loading, logging).
"""

__version__ = "0.1.0"
