"""Port parity: cruse_tpu_torch's frame-by-frame StreamingEnhancer against
cruse_tpu's, on the CPU, for CRUSE and CRUSE+DF (config 3's streaming path),
and against the port's own offline ``center=False`` path.

Tolerance: 1e-4 max-abs on the enhanced waveform (the BASELINE contract).
Against the offline path the comparison starts past the first ``n_fft``
samples, where the offline envelope's guard differs from the steady-state
one, as cruse_tpu's own streaming test does.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer
from cruse_tpu.infer.streaming import _steady_envelope as jax_steady_envelope

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig, istft, stft
from cruse_tpu_torch.infer.streaming import StreamingEnhancer, _steady_envelope
from cruse_tpu_torch.models import CruseConfig, CruseNet
from cruse_tpu_torch.models.cruse_df import apply_cruse_df
from cruse_tpu_torch.utils.weights import save_flax_npz
from tests.test_torch_cruse import SMALL as SMALL_CRUSE
from tests.test_torch_cruse import make_pair, noisy_batch
from tests.test_torch_cruse_df import SMALL, SMALL_TRUNK, make_df_pair

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(n_fft=320, hop_length=160, center=False)


def _pair(rng, family: str):
    if family == "cruse":
        return make_pair(SMALL_CRUSE, rng)
    if family == "cruse_df":
        return make_df_pair(rng, SMALL_TRUNK, SMALL)
    return make_df_pair(rng)  # config 3's full width


@pytest.mark.parametrize("family,batch,samples", [
    ("cruse", 2, 8000), ("cruse_df", 2, 8000), ("cruse_df_config3", 1, 4000)])
def test_run_matches_jax(rng, family, batch, samples):
    jax_model, variables, model = _pair(rng, family)
    wav = noisy_batch(rng, batch, samples)
    ref = np.asarray(JaxStreamingEnhancer(jax_model, variables, JaxStftConfig(**CFG))
                     .run(jnp.asarray(wav)))
    ours = StreamingEnhancer(model, StftConfig(**CFG)).run(torch.from_numpy(wav)).numpy()
    assert ours.shape == ref.shape == (batch, (samples - 160) // 160 * 160)
    err = np.abs(ours - ref).max()
    assert err < 1e-4, f"streamed waveform max-abs {err} >= 1e-4"


@pytest.mark.parametrize("family", ["cruse", "cruse_df"])
def test_stream_matches_offline_uncentred(rng, family):
    """Primed streaming equals the port's offline center=False path (model
    over the whole utterance, then iSTFT) past the overlap-add warm-up."""
    _, _, model = _pair(rng, family)
    cfg = StftConfig(**CFG)
    wav = torch.from_numpy(noisy_batch(rng, 2, 8000))
    streamed = StreamingEnhancer(model, cfg).run(wav)
    with torch.no_grad():
        spec = stft(wav, cfg)
        out, _ = model(model.compress(spec.abs()))
        if family == "cruse":
            offline = istft(spec * out, cfg)
        else:
            mask, coefs = out
            offline = istft(apply_cruse_df(spec, mask, coefs, model.config), cfg)
    n, m = cfg.n_fft, min(streamed.shape[-1], offline.shape[-1])
    np.testing.assert_allclose(streamed[:, n : m - n].numpy(), offline[:, n : m - n].numpy(),
                               atol=1e-4)


def test_step_multi_and_prime_agree_with_steps(rng):
    _, _, model = _pair(rng, "cruse_df")
    enh = StreamingEnhancer(model, StftConfig(**CFG))
    wav = torch.from_numpy(noisy_batch(rng, 2, 160 * 9))
    head, rest = wav[:, :160], wav[:, 160:]
    state = enh.prime(enh.init_state(2), head)
    singles = []
    for i in range(8):
        out, state = enh.step(state, rest[:, i * 160 : (i + 1) * 160])
        singles.append(out)
    multi_state = enh.prime(enh.init_state(2), head)
    first, multi_state = enh.step_multi(multi_state, rest[:, : 4 * 160])
    second, multi_state = enh.step_multi(multi_state, rest[:, 4 * 160 :])
    torch.testing.assert_close(torch.cat([first, second], -1), torch.cat(singles, -1),
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(singles, -1), enh.run(wav), rtol=0, atol=0)
    torch.testing.assert_close(multi_state.model_state[1].spec_history,
                               state.model_state[1].spec_history, rtol=0, atol=0)
    # unprimed, the stream starts from a zero buffer: the same model, other samples
    unprimed, _ = enh.step_multi(enh.init_state(2), rest)
    assert unprimed.shape == first.shape[:1] + (8 * 160,)
    assert not torch.allclose(unprimed, torch.cat(singles, -1))
    with pytest.raises(ValueError):
        enh.prime(enh.init_state(2), head[:, :100])
    with pytest.raises(ValueError):
        enh.step_multi(enh.init_state(2), rest[:, :100])


def test_steady_envelope_and_rtf(rng):
    for window in ("hann", "sqrt_hann"):
        cfg = dict(CFG, window=window)
        np.testing.assert_array_equal(_steady_envelope(StftConfig(**cfg)),
                                      jax_steady_envelope(JaxStftConfig(**cfg)))
    _, _, model = _pair(rng, "cruse")
    rtf = StreamingEnhancer(model, StftConfig(**CFG)).measure_rtf(noisy_batch(rng, 1, 4000),
                                                                 num_frames=5)
    assert rtf > 0


def test_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="center=False"):
        StreamingEnhancer(CruseNet(CruseConfig(**SMALL_CRUSE)), StftConfig(320, 160))
    with pytest.raises(NotImplementedError, match="not ported"):
        StreamingEnhancer(torch.nn.Linear(2, 2), StftConfig(**CFG))


def test_cli_streaming_writes_the_stream(rng, tmp_path):
    """python -m cruse_tpu_torch.infer --streaming on configs/tiny_cruse_df.toml
    with a bridge .npz writes, per file, what cruse_tpu's StreamingEnhancer
    computes for the same weights; --hops_per_step 3 changes nothing."""
    jax_model, variables, _ = make_df_pair(rng, SMALL_TRUNK, SMALL)  # tiny_cruse_df.toml's model
    save_flax_npz(variables, str(tmp_path / "w.npz"))
    (tmp_path / "in").mkdir()
    for i, n in enumerate((4000, 5123)):
        write_wav(str(tmp_path / "in" / f"utt{i}.wav"), noisy_batch(rng, 1, n)[0], 16000)
    jax_enh = JaxStreamingEnhancer(jax_model, variables, JaxStftConfig(**CFG))
    for k in (1, 3):
        out_dir = tmp_path / f"out{k}"
        cmd = [sys.executable, "-m", "cruse_tpu_torch.infer", "-C",
               str(ROOT / "configs/tiny_cruse_df.toml"), "-I", str(tmp_path / "in"),
               "-O", str(out_dir), "--weights", str(tmp_path / "w.npz"), "--streaming",
               "--hops_per_step", str(k)]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "streaming rtf" in proc.stdout + proc.stderr
        for i in range(2):
            noisy = read_wav(str(tmp_path / "in" / f"utt{i}.wav"))[0]
            ref = to_int16_scaled(np.asarray(jax_enh.run(jnp.asarray(noisy[None])))[0])
            out, sr = read_wav(str(out_dir / f"utt{i}.wav"))
            out = np.round(out * 32768.0)
            assert sr == 16000 and out.shape == ref.shape
            assert np.abs(out - ref.astype(np.float64)).max() / 32768.0 <= 1e-4
    proc = subprocess.run([*cmd[:-2], "--batch", "2"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "--batch" in proc.stderr
