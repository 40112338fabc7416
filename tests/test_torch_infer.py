"""Port parity: cruse_tpu_torch batch inference and its CLI against
cruse_tpu, on the CPU.

Both packages return enhanced utterances as int16 at 0.8 of full scale; they
are compared as waveforms in [-1, 1] (int16 / 32768) at 1e-4 max-abs, the
BASELINE contract.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig

from cruse_tpu_torch.data.wavio import read_wav, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer.__main__ import main as cli_main
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.models import CruseConfig, CruseNet
from cruse_tpu_torch.utils.weights import save_flax_npz
from tests.test_torch_cruse import SMALL, make_pair, noisy_batch

ROOT = Path(__file__).resolve().parent.parent
LENGTHS = (4000, 6543, 9100)  # ragged, not hop-aligned


def _assert_same_outputs(ours, ref):
    assert [r[0] for r in ours] == [r[0] for r in ref]
    for (name, a, _), (_, b, _) in zip(ours, ref):
        assert a.shape == b.shape, name
        err = np.abs(a.astype(np.float64) - b.astype(np.float64)).max() / 32768.0
        assert err <= 1e-4, f"{name}: enhanced max-abs {err} > 1e-4"


def _jax_inferencer(jax_model, variables, out_dir):
    return JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
        stft=JaxStftConfig(n_fft=320, hop_length=160), output_dir=str(out_dir)))


def test_run_batched_ragged_matches_jax(rng, tmp_path):
    jax_model, variables, model = make_pair(SMALL, rng)
    wavs = [noisy_batch(rng, 1, n)[0] for n in LENGTHS]
    names = [f"utt{i}" for i in range(len(wavs))]
    ref = _jax_inferencer(jax_model, variables, tmp_path / "jax").run_batched(
        wavs, names, batch_size=2, write=False)
    inf = BatchInferencer(model, InferencerConfig(stft=StftConfig(n_fft=320, hop_length=160),
                                                  output_dir=str(tmp_path / "torch")), device="cpu")
    ours = inf.run_batched(wavs, names, batch_size=2, write=False)
    _assert_same_outputs(ours, ref)
    assert len(inf.rtf_history) == 2 and not (tmp_path / "torch").exists()


def test_call_one_utterance_per_forward_matches_jax(rng, tmp_path):
    jax_model, variables, model = make_pair(SMALL, rng)
    wavs = [noisy_batch(rng, 1, n) for n in LENGTHS[:2]]
    batches = [{"noisy": w, "name": [f"utt{i}"]} for i, w in enumerate(wavs)]
    ref = _jax_inferencer(jax_model, variables, tmp_path / "jax")(batches, write=False)
    inf = BatchInferencer(model, InferencerConfig(stft=StftConfig(n_fft=320, hop_length=160),
                                                  output_dir=str(tmp_path / "torch")), device="cpu")
    ours = inf(batches, write=True)
    _assert_same_outputs(ours, ref)
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == ["utt0.wav", "utt1.wav"]


def test_cli_enhances_a_directory_with_bridged_weights(rng, tmp_path):
    """python -m cruse_tpu_torch.infer on configs/tiny_cruse.toml with a bridge
    .npz writes what cruse_tpu's run_batched computes for the same weights."""
    jax_model, variables, _ = make_pair(SMALL, rng)  # tiny_cruse.toml's model
    save_flax_npz(variables, str(tmp_path / "w.npz"))
    (tmp_path / "in").mkdir()
    wavs = []
    for i, n in enumerate(LENGTHS):
        write_wav(str(tmp_path / "in" / f"utt{i}.wav"), noisy_batch(rng, 1, n)[0], 16000)
        wavs.append(read_wav(str(tmp_path / "in" / f"utt{i}.wav"))[0])  # as int16 on disk
    cmd = [sys.executable, "-m", "cruse_tpu_torch.infer", "-C", str(ROOT / "configs/tiny_cruse.toml"),
           "-I", str(tmp_path / "in"), "-O", str(tmp_path / "out"),
           "--weights", str(tmp_path / "w.npz"), "--batch", "3", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = _jax_inferencer(jax_model, variables, tmp_path / "jax").run_batched(
        wavs, [f"utt{i}" for i in range(3)], batch_size=3, write=False)
    ours = []
    for name, _, _ in ref:
        out, sr = read_wav(str(tmp_path / "out" / f"{name}.wav"))
        assert sr == 16000
        ours.append((name, np.round(out * 32768.0).astype(np.int16), 0.0))
    _assert_same_outputs(ours, ref)


def test_auto_on_cruse_matches_jax(rng, tmp_path):
    """The ``auto`` strategy on a mask model: the forward adapter's
    sqrt(re^2 + im^2 + 1e-12) magnitude, the mask on the RI spectrum."""
    jax_model, variables, model = make_pair(SMALL, rng)
    wavs = [noisy_batch(rng, 1, n)[0] for n in LENGTHS]
    names = [f"utt{i}" for i in range(len(wavs))]
    ref = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
        type="auto", stft=JaxStftConfig(n_fft=320, hop_length=160),
        output_dir=str(tmp_path / "jax"))).run_batched(wavs, names, batch_size=2, write=False)
    inf = BatchInferencer(model, InferencerConfig(type="auto", stft=StftConfig(n_fft=320, hop_length=160),
                                                  output_dir=str(tmp_path / "torch")), device="cpu")
    _assert_same_outputs(inf.run_batched(wavs, names, batch_size=2, write=False), ref)


@pytest.mark.parametrize("device_args", [["--device", "cuda"], []], ids=["cuda", "default"])
def test_cli_cuda_without_a_card_raises(monkeypatch, tmp_path, device_args):
    """The CLI runs on the card unless asked for the CPU: without a CUDA
    device both --device cuda and the default are an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["-C", str(ROOT / "configs/tiny_cruse.toml"), "-I", str(tmp_path),
                  "-O", str(tmp_path / "out")] + device_args)


def test_inferencer_defaults_to_the_card(monkeypatch, rng):
    """BatchInferencer's device defaults to cuda and raises without one; the
    CPU is used only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CruseNet(CruseConfig(**SMALL), generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchInferencer(model, InferencerConfig())
    assert BatchInferencer(model, InferencerConfig(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("cfg,error", [
    (dict(type="auto"), NotImplementedError), (dict(type="complex_mask"), ValueError),
    (dict(type="multi_channel_directional"), ValueError), (dict(postfilter="wiener"), ValueError),
], ids=["auto", "complex_mask", "multi_channel", "postfilter"])
def test_unported_strategies_are_refused(cfg, error):
    """``auto`` is ported for CRUSE and CRUSE+DF (tests/test_torch_cruse_df.py);
    for a model family whose forward adapter is not ported it is refused.
    ``complex_mask`` is ported for FullSubNet's cIRM
    (tests/test_torch_fullsubnet_serve.py) and refused for a mask model, and
    so is ``multi_channel_directional``, which takes McCruse
    (tests/test_torch_mc_cruse.py). The post-filters ``sin`` and ``envelope`` are ported
    (tests/test_torch_infer_long.py); any other name is refused, as the JAX
    package refuses it."""
    model = CruseNet(CruseConfig(**SMALL))
    if cfg.get("type") == "auto":
        BatchInferencer(model, InferencerConfig(**cfg), device="cpu")
        model = torch.nn.Linear(2, 2)
    with pytest.raises(error):
        BatchInferencer(model, InferencerConfig(**cfg), device="cpu")
