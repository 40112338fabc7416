"""Port parity: streaming a windowed MTFAA (benchmark config 5b's deployable
form) in cruse_tpu_torch against cruse_tpu, on the CPU, with weights carried
across by the bridge: the attention's rolling caches, the state a
``state=None`` call returns, chunks carried through it, the net hop by hop,
``StreamingEnhancer`` and the CLI.

BatchNorm statistics and PReLU slopes are perturbed on the JAX side
(``make_mtfaa_pair``). Tolerances: the attention 1e-5
(``tests/test_mtfaa_bsrnn.py``'s own); the net's stream and chunk carry
2e-4, the JAX package's bound for the same comparison; enhanced waveforms
1e-4 max-abs, the BASELINE contract.
"""
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer
from cruse_tpu.models import mtfaa as jm

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig, istft, stft
from cruse_tpu_torch.infer.__main__ import main as cli_main
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models.mtfaa import AxialSelfAttention
from cruse_tpu_torch.utils.weights import mtfaa_state_dict_from_flax, save_flax_npz
from tests.test_torch_cruse import noisy_batch
from tests.test_torch_mtfaa import DEMO, TINY_WINDOWED, make_mtfaa_pair

ROOT = Path(__file__).resolve().parent.parent
STREAM_CFG = dict(n_fft=512, hop_length=256, center=False)
CARRY = dict(n_bands=64, channels=(8, 12, 16), tfcm_layers=1, attention_window=4)  # the JAX test's net
NETS = {"tiny_windowed": TINY_WINDOWED, "jax_test_net": CARRY,
        "no_deep_filter": dict(TINY_WINDOWED, use_deep_filter=False)}


def leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree,
                                  is_leaf=lambda x: isinstance(x, torch.Tensor))


def assert_states_close(ours, ref, atol):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        a, b = leaves(ours[key]), jax.tree_util.tree_leaves(ref[key])
        assert len(a) == len(b), key
        for x, y in zip(a, b):
            assert tuple(x.shape) == tuple(y.shape), key
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def nets():
    """NETS by name in both packages with the JAX net's jitted apply, each
    made once for the module."""
    made = {}

    def get(name):
        if name not in made:
            jax_model, variables, model = make_mtfaa_pair(np.random.default_rng(7), NETS[name])
            made[name] = dict(jax_model=jax_model, variables=variables, model=model,
                              apply=jax.jit(jax_model.apply))
        return made[name]
    return get


@pytest.fixture(scope="module")
def tiny(nets):
    """TINY_WINDOWED (window 7, deep filter) in both packages, and one
    utterance's spectrum through the JAX net hop by hop."""
    net = nets("tiny_windowed")
    cspec = (np.random.default_rng(8).standard_normal((2, 16, 257, 2)) * 0.3).astype(np.float32)
    state, outs = net["jax_model"].init_state(2), []
    for t in range(cspec.shape[1]):
        (o, _), state = net["apply"](net["variables"], jnp.asarray(cspec[:, t : t + 1]), state)
        outs.append(np.asarray(o))
    return dict(net, cspec=cspec, jax_stream=np.concatenate(outs, axis=1), jax_final=state)


def make_asa(rng, channels=8, window=5):
    x0 = jnp.zeros((1, 3, channels, 4), jnp.float32)
    jax_asa = jm.AxialSelfAttention(channels, causal=True, window=window)
    variables = jax.tree_util.tree_map(np.asarray, jax_asa.init(jax.random.PRNGKey(0), x0))
    asa = AxialSelfAttention(channels, window=window).eval()
    asa.load_state_dict(mtfaa_state_dict_from_flax(variables), strict=True)
    return jax_asa, variables, asa


def test_asa_stream_matches_jax_and_batch(rng):
    """T = 1 steps over the rolling caches from init_stream_state against the
    JAX ASA's steps and the port's windowed batch (the kernel's CPU version)."""
    jax_asa, variables, asa = make_asa(rng)
    x = rng.standard_normal((2, 3, 8, 12)).astype(np.float32)
    with torch.no_grad():
        full = asa(torch.from_numpy(x))
        state = asa.init_stream_state(2, 3)
        jax_state = jax_asa.init_stream_state(2, 3)
        step = jax.jit(jax_asa.apply)
        assert [tuple(s.shape) for s in state] == [s.shape for s in jax_state]
        assert state[2].dtype == torch.int32 and jax_state[2].dtype == jnp.int32
        for t in range(12):
            y, state = asa.carry(torch.from_numpy(x[..., t : t + 1]), state)
            ref, jax_state = step(variables, jnp.asarray(x[..., t : t + 1]), jax_state)
            np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-5)
            np.testing.assert_allclose(y[..., 0].numpy(), full[..., t].numpy(), atol=1e-5)
            assert state[2].tolist() == np.asarray(jax_state[2]).tolist() == [min(t + 1, 4)] * 2


def test_asa_streams_at_different_counts(rng):
    """One batch of three streams that have seen 0, 2 and 9 frames (count 0,
    between, and window - 1): each row's next frames equal its own windowed
    batch over all its frames, and the JAX ASA's step on the same caches."""
    jax_asa, variables, asa = make_asa(rng, window=5)
    seen, more = (0, 2, 9), 4
    xs = [rng.standard_normal((1, 3, 8, n + more)).astype(np.float32) for n in seen]
    with torch.no_grad():
        rows = []
        for x, n in zip(xs, seen):
            state = asa.init_stream_state(1, 3)
            if n:
                _, state = asa.carry(torch.from_numpy(x[..., :n]))  # a state=None call's caches
            rows.append(state)
        state = tuple(torch.cat(parts) for parts in zip(*rows))
        assert state[2].tolist() == [0, 2, 4]
        jax_state, step = to_jax(state), jax.jit(jax_asa.apply)
        for t in range(more):
            frame = np.concatenate([x[..., n + t : n + t + 1] for x, n in zip(xs, seen)])
            y, state = asa.carry(torch.from_numpy(frame), state)
            ref, jax_state = step(variables, jnp.asarray(frame), jax_state)
            np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-5)
            for i, (x, n) in enumerate(zip(xs, seen)):
                whole = asa(torch.from_numpy(x[..., : n + t + 1]))
                np.testing.assert_allclose(y[i, ..., 0].numpy(), whole[0, ..., -1].numpy(), atol=1e-5)


def test_init_state_matches_jax(tiny):
    ours, ref = tiny["model"].init_state(3), tiny["jax_model"].init_state(3)
    assert_states_close(ours, ref, atol=0)
    assert ours["enc_asa_0"][2].dtype == torch.int32


@pytest.mark.parametrize("name,split", [("tiny_windowed", 5), ("jax_test_net", 5), ("no_deep_filter", 9)],
                         ids=["tiny_windowed", "jax_test_net", "no_deep_filter"])
def test_chunk_carry_and_state_match_jax(rng, nets, name, split):
    """A windowed state=None call runs the offline kernels (their CPU
    versions) and returns the JAX package's state, at 5 frames (below the
    TFCM histories' reach, 2 (2^L - 1) = 6 frames at L = 2, and the
    window) and at 9; two chunks carried through it equal one whole call, and
    the JAX package's chunked call."""
    net = nets(name)
    model, apply, variables = net["model"], net["apply"], net["variables"]
    cspec = (rng.standard_normal((1, 12, 257, 2)) * 0.3).astype(np.float32)
    with torch.no_grad():
        (full, _), _ = model(torch.from_numpy(cspec))
        (same, _), no_state = model(torch.from_numpy(cspec), with_state=False)  # the offline adapters' call
        (first, _), state = model(torch.from_numpy(cspec[:, :split]))
        (second, _), _ = model(torch.from_numpy(cspec[:, split:]), state)
    assert no_state is None
    torch.testing.assert_close(same, full, rtol=0, atol=0)
    stitched = torch.cat([first, second], dim=1).numpy()
    np.testing.assert_allclose(stitched, full.numpy(), atol=2e-4)
    (o1, _), jax_state = apply(variables, jnp.asarray(cspec[:, :split]))
    assert_states_close(state, jax_state, atol=2e-5)
    (o2, _), _ = apply(variables, jnp.asarray(cspec[:, split:]), jax_state)
    np.testing.assert_allclose(stitched, np.concatenate([np.asarray(o1), np.asarray(o2)], axis=1), atol=2e-4)


def test_net_stream_matches_jax_and_offline(tiny):
    """Hop by hop from init_state against the JAX net's hops and the port's
    own offline call; the final states agree too."""
    model, cspec = tiny["model"], tiny["cspec"]
    with torch.no_grad():
        (offline, _), _ = model(torch.from_numpy(cspec))
        state, outs = model.init_state(2), []
        for t in range(cspec.shape[1]):
            (o, _), state = model(torch.from_numpy(cspec[:, t : t + 1]), state)
            outs.append(o)
    stream = torch.cat(outs, dim=1).numpy()
    np.testing.assert_allclose(stream, tiny["jax_stream"], atol=2e-4)
    np.testing.assert_allclose(stream, offline.numpy(), atol=2e-4)
    assert_states_close(state, tiny["jax_final"], atol=2e-4)


def test_streaming_enhancer_matches_jax_and_offline(tiny):
    """Waveforms through StreamingEnhancer against the JAX StreamingEnhancer
    and the port's offline center=False path past the first n_fft samples;
    step_multi (k = 3) against steps."""
    rng = np.random.default_rng(3)
    wav = noisy_batch(rng, 2, 256 * 14 + 256)
    cfg = StftConfig(**STREAM_CFG)
    enh = StreamingEnhancer(tiny["model"], cfg)
    ours = enh.run(torch.from_numpy(wav))
    ref = np.asarray(JaxStreamingEnhancer(tiny["jax_model"], tiny["variables"], JaxStftConfig(**STREAM_CFG))
                     .run(jnp.asarray(wav)))
    assert ours.shape == ref.shape == (2, 256 * 14)
    err = np.abs(ours.numpy() - ref).max()
    assert err < 1e-4, f"streamed waveform max-abs {err} >= 1e-4"
    with torch.no_grad():
        spec = stft(torch.from_numpy(wav), cfg)
        (enhanced, _), _ = tiny["model"](torch.stack([spec.real, spec.imag], dim=-1))
        offline = istft(enhanced, cfg)
    n, m = cfg.n_fft, min(ours.shape[-1], offline.shape[-1])
    np.testing.assert_allclose(ours[:, n : m - n].numpy(), offline[:, n : m - n].numpy(), atol=1e-4)
    x = torch.from_numpy(wav)
    state = enh.prime(enh.init_state(2), x[:, :256])
    singles, single_state = [], state
    for i in range(6):
        out, single_state = enh.step(single_state, x[:, 256 * (i + 1) : 256 * (i + 2)])
        singles.append(out)
    first, state = enh.step_multi(state, x[:, 256 : 256 * 4])
    second, state = enh.step_multi(state, x[:, 256 * 4 : 256 * 7])
    torch.testing.assert_close(torch.cat([first, second], -1), torch.cat(singles, -1), rtol=0, atol=0)
    for a, b in zip(leaves(state.model_state), leaves(single_state.model_state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cli_streams_a_windowed_mtfaa(rng, tmp_path, capsys):
    """The CLI (``python -m cruse_tpu_torch.infer``'s main, in this process)
    with --streaming on configs/demo_mtfaa_windowed.toml and a bridge .npz
    writes what cruse_tpu's StreamingEnhancer computes for the same weights."""
    jax_model, variables, _ = make_mtfaa_pair(rng, DEMO)
    save_flax_npz(variables, str(tmp_path / "w.npz"))
    (tmp_path / "in").mkdir()
    noisy = noisy_batch(rng, 1, 256 * 12 + 100)[0]
    write_wav(str(tmp_path / "in" / "utt.wav"), noisy, 16000)
    cli_main(["-C", str(ROOT / "configs/demo_mtfaa_windowed.toml"), "-I", str(tmp_path / "in"),
              "-O", str(tmp_path / "out"), "--weights", str(tmp_path / "w.npz"),
              "--streaming", "--hops_per_step", "2", "--device", "cpu"])
    assert "streaming rtf" in capsys.readouterr().out
    noisy = read_wav(str(tmp_path / "in" / "utt.wav"))[0]
    ref = JaxStreamingEnhancer(jax_model, variables, JaxStftConfig(**STREAM_CFG)).run(jnp.asarray(noisy[None]))
    ref = to_int16_scaled(np.asarray(ref)[0])
    out, sr = read_wav(str(tmp_path / "out" / "utt.wav"))
    out = np.round(out * 32768.0)
    assert sr == 16000 and out.shape == ref.shape
    assert np.abs(out - ref.astype(np.float64)).max() / 32768.0 <= 1e-4
