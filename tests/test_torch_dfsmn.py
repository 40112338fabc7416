"""Port parity: cruse_tpu_torch's DFSMN (benchmark config 4) against
cruse_tpu, on the CPU, with weights carried across by the bridge: the block,
the net offline and streamed at T = 1, ``StreamingEnhancer``, the offline
inferencer and the CLI.

The JAX package initialises the skip weights to zero, which would hide the
skip chain; they are moved off zero on the JAX side first. Tolerances: block,
net and stream 1e-5 (float32 nets of the same layers, as
``tests/test_dfsmn.py``); enhanced waveforms 1e-4 max-abs, the BASELINE
contract.
"""
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer
from cruse_tpu.models import dfsmn as jd
from cruse_tpu.utils.config import load_config as jax_load_config

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer.__main__ import main as cli_main
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import DfsmnBlock, DfsmnConfig, DfsmnNet, build_from_config
from cruse_tpu_torch.utils.config import load_config
from cruse_tpu_torch.utils.weights import dense_state_dict_from_flax, save_flax_npz, state_dict_from_flax
from tests.test_torch_cruse import noisy_batch

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(in_freq=161, hidden_dim=32, num_blocks=3, left_frames=2)
TINY_TOML = dict(in_freq=161, hidden_dim=32, num_blocks=2, left_frames=2)  # configs/tiny_dfsmn.toml
STREAM_CFG = dict(n_fft=320, hop_length=160, center=False)


def with_skips(variables, rng):
    """The JAX variables as numpy, every skip weight moved off its zero init."""
    def bump(path, a):
        if path[-1].key == "skip_weight":
            return a + np.float32(rng.uniform(0.3, 0.8))
        return a
    return jax.tree_util.tree_map_with_path(bump, jax.tree_util.tree_map(np.asarray, variables))


def make_dfsmn_pair(rng, args: dict, seed: int = 0):
    """A cruse_tpu DfsmnNet with seeded variables and the port's DfsmnNet carrying them."""
    jax_model = jd.DfsmnNet(**args)
    variables = with_skips(jax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, args["in_freq"]))), rng)
    model = DfsmnNet(DfsmnConfig(**args)).eval()
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return jax_model, variables, model


def features(rng, b, t, f=161):
    return np.abs(rng.standard_normal((b, t, f))).astype(np.float32) ** 0.3


@pytest.mark.parametrize("hidden", [False, True], ids=["no_hidden", "hidden"])
@pytest.mark.parametrize("left_dilation,right_frames", [(1, 0), (2, 0), (2, 2)],
                         ids=["dil1", "dil2", "dil2_lookahead"])
def test_block_matches_jax(rng, hidden, left_dilation, right_frames):
    b, t, i, h, o = 2, 13, 12, 20, 10
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    hid = rng.standard_normal((b, t, h)).astype(np.float32) if hidden else None
    jax_block = jd.DfsmnBlock(hidden_dim=h, output_dim=o, left_frames=2, left_dilation=left_dilation,
                              right_frames=right_frames, right_dilation=2)
    args = (jnp.asarray(x),) + ((jnp.asarray(hid),) if hidden else ())
    variables = with_skips(jax_block.init(jax.random.PRNGKey(0), *args), rng)
    block = DfsmnBlock(i, h, o, left_frames=2, left_dilation=left_dilation, right_frames=right_frames,
                       right_dilation=2, skip=hidden).eval()
    block.load_state_dict(dense_state_dict_from_flax(variables), strict=True)
    ref_y, ref_p, ref_ctx = jax_block.apply(variables, *args)
    with torch.no_grad():
        y, out_p, ctx = block(torch.from_numpy(x), None if hid is None else torch.from_numpy(hid))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-5)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(ref_p), atol=1e-5)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ref_ctx), atol=1e-5)
    assert ctx.shape == (b, 2 * left_dilation, h)


@pytest.mark.parametrize("args", [SMALL, dict(SMALL, left_dilation=2), dict(SMALL, right_frames=2),
                                  dict(SMALL, left_frames=0)],
                         ids=["causal", "dilation2", "lookahead", "no_left_memory"])
def test_net_offline_matches_jax(rng, args):
    """The mask and the state a state=None call returns (each block's left context)."""
    jax_model, variables, model = make_dfsmn_pair(rng, args)
    feat = features(rng, 2, 17)
    ref_mask, ref_state = jax_model.apply(variables, jnp.asarray(feat))
    with torch.no_grad():
        mask, state = model(torch.from_numpy(feat))
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref_mask), atol=1e-5)
    assert len(state) == len(ref_state) == args["num_blocks"]
    for ours, ref in zip(state, ref_state):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("left_dilation", [1, 2])
def test_net_stream_matches_jax_and_offline(rng, left_dilation):
    """T = 1 steps from init_state against the JAX steps and the port's own
    offline call; then a chunk carried from a state=None call."""
    args = dict(SMALL, left_dilation=left_dilation)
    jax_model, variables, model = make_dfsmn_pair(rng, args)
    feat = features(rng, 2, 12)
    with torch.no_grad():
        offline, _ = model(torch.from_numpy(feat))
        state = model.init_state(2)
        jax_state = jax_model.init_state(2)
        assert [s.shape for s in state] == [s.shape for s in jax_state]
        step = jax.jit(jax_model.apply)
        for t in range(12):
            mask, state = model(torch.from_numpy(feat[:, t : t + 1]), state)
            ref, jax_state = step(variables, jnp.asarray(feat[:, t : t + 1]), jax_state)
            np.testing.assert_allclose(mask.numpy(), np.asarray(ref), atol=1e-5)
            np.testing.assert_allclose(mask[:, 0].numpy(), offline[:, t].numpy(), atol=1e-5)
        first, carried = model(torch.from_numpy(feat[:, :5]))
        second, _ = model(torch.from_numpy(feat[:, 5:]), carried)
    np.testing.assert_allclose(torch.cat([first, second], 1).numpy(), offline.numpy(), atol=1e-5)


def test_lookahead_net_refuses_a_state(rng):
    model = DfsmnNet(DfsmnConfig(in_freq=17, hidden_dim=8, num_blocks=1, right_frames=2)).eval()
    feat = torch.zeros(1, 6, 17)
    with pytest.raises(ValueError, match="look-ahead"):
        model(feat, model.init_state(1))
    with pytest.raises(ValueError, match="right_frames=0"):
        StreamingEnhancer(model, StftConfig(n_fft=32, hop_length=16, center=False))
    with pytest.raises(ValueError, match="left contexts"):
        DfsmnNet(DfsmnConfig(in_freq=17, hidden_dim=8)).eval()(feat, ())
    with pytest.raises(ValueError, match="skip weight"):
        DfsmnBlock(8, 8, 8)(torch.zeros(1, 3, 8), torch.zeros(1, 3, 8))


@pytest.mark.parametrize("batch,samples", [(2, 8000), (1, 4321)])
def test_streaming_enhancer_matches_jax(rng, batch, samples):
    jax_model, variables, model = make_dfsmn_pair(rng, SMALL)
    wav = noisy_batch(rng, batch, samples)
    ref = np.asarray(JaxStreamingEnhancer(jax_model, variables, JaxStftConfig(**STREAM_CFG))
                     .run(jnp.asarray(wav)))
    ours = StreamingEnhancer(model, StftConfig(**STREAM_CFG)).run(torch.from_numpy(wav)).numpy()
    assert ours.shape == ref.shape == (batch, (samples - 160) // 160 * 160)
    err = np.abs(ours - ref).max()
    assert err < 1e-4, f"streamed waveform max-abs {err} >= 1e-4"


def test_step_multi_agrees_with_steps(rng):
    _, _, model = make_dfsmn_pair(rng, SMALL)
    enh = StreamingEnhancer(model, StftConfig(**STREAM_CFG))
    wav = torch.from_numpy(noisy_batch(rng, 2, 160 * 9))
    state = enh.prime(enh.init_state(2), wav[:, :160])
    singles = []
    single_state = state
    for i in range(8):
        out, single_state = enh.step(single_state, wav[:, 160 * (i + 1) : 160 * (i + 2)])
        singles.append(out)
    first, state = enh.step_multi(state, wav[:, 160 : 160 * 5])
    second, state = enh.step_multi(state, wav[:, 160 * 5 :])
    torch.testing.assert_close(torch.cat([first, second], -1), torch.cat(singles, -1), rtol=0, atol=0)
    for a, b in zip(state.model_state, single_state.model_state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("strategy", ["mag_to_mag", "auto"])
def test_inferencer_matches_jax(rng, tmp_path, strategy):
    jax_model, variables, model = make_dfsmn_pair(rng, SMALL)
    noisy = noisy_batch(rng, 2, 8000)
    jax_inf = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
        type=strategy, stft=JaxStftConfig(320, 160), output_dir=str(tmp_path / "jax")))
    inf = BatchInferencer(model, InferencerConfig(type=strategy, stft=StftConfig(320, 160),
                                                  output_dir=str(tmp_path / "torch")), device="cpu")
    ref = np.asarray(jax_inf._strategy(jnp.asarray(noisy)))
    ours = inf._strategy(torch.from_numpy(noisy)).numpy()
    assert ours.shape == ref.shape == noisy.shape
    err = np.abs(ours - ref).max()
    assert err < 1e-4, f"enhanced waveform max-abs {err} >= 1e-4"


def test_build_from_config():
    config = load_config(str(ROOT / "configs" / "tiny_dfsmn.toml"))
    assert config == jax_load_config(str(ROOT / "configs" / "tiny_dfsmn.toml"))
    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(1))
    assert isinstance(model, DfsmnNet) and model.config == DfsmnConfig(**TINY_TOML)
    again = build_from_config(config["model"], generator=torch.Generator().manual_seed(1))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cli_streams_and_enhances_tiny_dfsmn(rng, tmp_path):
    """The CLI (``python -m cruse_tpu_torch.infer``'s main, in this process)
    on configs/tiny_dfsmn.toml with a bridge .npz: --streaming writes what
    cruse_tpu's StreamingEnhancer computes, and the offline run (the config's
    mag_to_mag) what its BatchInferencer does."""
    jax_model, variables, _ = make_dfsmn_pair(rng, TINY_TOML)
    save_flax_npz(variables, str(tmp_path / "w.npz"))
    (tmp_path / "in").mkdir()
    for i, n in enumerate((4000, 5123)):
        write_wav(str(tmp_path / "in" / f"utt{i}.wav"), noisy_batch(rng, 1, n)[0], 16000)
    jax_stream = JaxStreamingEnhancer(jax_model, variables, JaxStftConfig(**STREAM_CFG))
    jax_inf = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
        type="mag_to_mag", stft=JaxStftConfig(320, 160), output_dir=str(tmp_path / "jax")))
    for mode, extra in (("stream", ["--streaming", "--hops_per_step", "2"]), ("offline", [])):
        out_dir = tmp_path / mode
        cli_main(["-C", str(ROOT / "configs/tiny_dfsmn.toml"), "-I", str(tmp_path / "in"), "-O", str(out_dir),
                  "--weights", str(tmp_path / "w.npz"), "--device", "cpu", *extra])
        for i in range(2):
            noisy = read_wav(str(tmp_path / "in" / f"utt{i}.wav"))[0]
            run = jax_stream.run if mode == "stream" else jax_inf._strategy
            ref = to_int16_scaled(np.asarray(run(jnp.asarray(noisy[None])))[0])
            out, sr = read_wav(str(out_dir / f"utt{i}.wav"))
            out = np.round(out * 32768.0)
            assert sr == 16000 and out.shape == ref.shape
            assert np.abs(out - ref.astype(np.float64)).max() / 32768.0 <= 1e-4, (mode, i)
