"""cruse_tpu_torch: the PyTorch + CUDA port of cruse_tpu, for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference each module is
tested against, and mirrors its module paths:

- ``cruse_tpu_torch.dsp``    -- STFT/iSTFT (torch.stft/istft; the JAX overlap-add
  for center=False), windows, the windowed DFT bases
- ``cruse_tpu_torch.ops``    -- hand-written CUDA kernels with their plain versions
  (grouped-GRU recurrence, deep filter)
- ``cruse_tpu_torch.nn``     -- causal conv block, grouped GRU bottleneck, int8 weights
- ``cruse_tpu_torch.models`` -- CRUSE, CRUSE+DF, DFSMN, MTFAA, the deep filter
- ``cruse_tpu_torch.train``  -- the forward adapters, the train step, checkpoints, the
  trainer and its CLI
- ``cruse_tpu_torch.infer``  -- batch and streaming inference, serving, export artifacts, and their CLIs
- ``cruse_tpu_torch.data``   -- wav IO, manifests, the on-card mixer, the dataset and prefetcher
- ``cruse_tpu_torch.metrics`` -- STOI, SI-SDR, PESQ, PMOS (numpy copies of cruse_tpu's)
- ``cruse_tpu_torch.utils``  -- the weight bridge from flax variables, configs, logging

The package imports torch and numpy, never jax or flax, and nothing of
cruse_tpu: what it needs of the JAX package's jax-free modules it copies.
"""

__version__ = "0.1.0"
