"""Port parity: serving cruse_tpu_torch's FullSubNet against cruse_tpu, on the
CPU: the offline ``complex_mask`` and ``auto`` strategies, streaming hop by
hop, the concurrent-stream server, and the infer CLI offline and
``--streaming``; the export CLI's round trip, offline and streamed; and the
refusals (``mag_to_mag``, the streaming guards).

Weights are made by flax and carried across by the bridge. Tolerances:
enhanced waveforms 1e-4 max-abs against JAX (the BASELINE contract); the
stream against the port's own offline ``center=False`` call 1e-4 past the
first ``n_fft`` samples, as tests/test_torch_streaming.py holds CRUSE; a
server session against its own single stream 1e-6; idle slots' state bit
for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig
from cruse_tpu.infer.server import StreamingServer as JaxStreamingServer
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig, istft, stft
from cruse_tpu_torch.infer.__main__ import main as cli_main
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer import artifact as artifact_lib
from cruse_tpu_torch.infer.export import build as export_build
from cruse_tpu_torch.infer.export import main as export_main
from cruse_tpu_torch.infer.server import StreamingServer, tree_leaves
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import CruseConfig, CruseNet, FullSubNet, FullSubNetConfig
from cruse_tpu_torch.train.step import forward_for_model
from cruse_tpu_torch.utils.config import load_config
from cruse_tpu_torch.utils.weights import save_flax_npz
from tests.test_torch_cruse import noisy_batch
from tests.test_torch_fullsubnet import make_fullsubnet_pair
from tests.test_torch_server import SESSIONS, drive, session_wavs, single_stream

STFT = dict(n_fft=64, hop_length=32)  # F = 33
SMALL = dict(num_freqs=33, num_neighbors=2, fb_hidden=16, fb_layers=1, sb_hidden=8, sb_layers=2)
STREAMED = dict(SMALL, norm="cumulative_laplace_norm")
SLOTS = 3
# configs/tiny_fullsubnet.toml's model, served through complex_mask with the streaming norm
TOML = """[meta]
seed = 0
[acoustics]
n_fft = 128
hop_length = 64
sr = 16000
[model]
path = "cruse_tpu.models.fullsubnet.FullSubNetConfig"
[model.args]
num_freqs = 65
num_neighbors = 2
fb_hidden = 32
fb_layers = 1
sb_hidden = 16
sb_layers = 1
norm = "cumulative_laplace_norm"
[inferencer]
type = "complex_mask"
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pairs():
    """The offline-norm and the cumulative-norm pair, made once."""
    rng = np.random.default_rng(7)
    return {"offline": make_fullsubnet_pair(rng, SMALL), "streamed": make_fullsubnet_pair(rng, STREAMED, seed=1)}


@pytest.mark.parametrize("norm", ["offline", "streamed"])
@pytest.mark.parametrize("strategy", ["complex_mask", "auto"])
def test_strategies_match_jax(pairs, tmp_path, rng, strategy, norm):
    """complex_mask feeds |X| (no 1e-12), auto the adapter's sqrt(|X|^2 +
    1e-12): each against the JAX strategy of the same name."""
    jax_model, variables, model = pairs[norm]
    noisy = noisy_batch(rng, 2, 3000)
    jax_inf = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
        type=strategy, stft=JaxStftConfig(**STFT), output_dir=str(tmp_path / "jax")))
    inf = BatchInferencer(model, InferencerConfig(type=strategy, stft=StftConfig(**STFT),
                                                  output_dir=str(tmp_path / "torch")), device="cpu")
    ref = np.asarray(jax_inf._strategy(jnp.asarray(noisy)))
    ours = inf._strategy(torch.from_numpy(noisy)).numpy()
    assert ours.shape == ref.shape == noisy.shape
    err = np.abs(ours - ref).max()
    assert err < 1e-4, f"{strategy} waveform max-abs {err} >= 1e-4"


def test_mask_strategies_refuse_the_other_family(pairs):
    """mag_to_mag would multiply |X| [B, T, F] by the [B, T, F, 2] cIRM;
    complex_mask takes no magnitude mask."""
    model = pairs["offline"][2]
    with pytest.raises(ValueError, match="complex_mask"):
        BatchInferencer(model, InferencerConfig(type="mag_to_mag", stft=StftConfig(**STFT)), device="cpu")
    with pytest.raises(ValueError, match="cIRM model"):
        BatchInferencer(CruseNet(CruseConfig(in_freq=33, channels=(2, 4, 4, 8), rnn_groups=2)),
                        InferencerConfig(type="complex_mask", stft=StftConfig(**STFT)), device="cpu")


@pytest.mark.parametrize("batch,samples", [(2, 3000), (1, 1777)])
def test_stream_matches_jax_and_the_offline_call(pairs, rng, batch, samples):
    """Hop by hop against JAX's StreamingEnhancer, and against the port's
    offline center=False call of the same model (the auto adapter's math)."""
    jax_model, variables, model = pairs["streamed"]
    cfg = StftConfig(**STFT, center=False)
    wav = noisy_batch(rng, batch, samples)
    ref = np.asarray(JaxStreamingEnhancer(jax_model, variables, JaxStftConfig(**STFT, center=False))
                     .run(jnp.asarray(wav)))
    streamed = StreamingEnhancer(model, cfg).run(torch.from_numpy(wav))
    assert streamed.shape == ref.shape == (batch, (samples - 32) // 32 * 32)
    err = np.abs(streamed.numpy() - ref).max()
    assert err < 1e-4, f"streamed waveform max-abs {err} >= 1e-4"
    with torch.no_grad():
        spec = stft(torch.from_numpy(wav), cfg)
        out = forward_for_model(model)(torch.stack([spec.real, spec.imag], dim=-1))
        offline = istft((out[..., 0], out[..., 1]), cfg)
    n, m = cfg.n_fft, min(streamed.shape[-1], offline.shape[-1])
    np.testing.assert_allclose(streamed[:, n : m - n].numpy(), offline[:, n : m - n].numpy(), atol=1e-4)


def test_streaming_guards(pairs):
    cfg = StftConfig(**STFT, center=False)
    with pytest.raises(ValueError, match="cumulative_laplace_norm"):
        StreamingEnhancer(pairs["offline"][2], cfg)
    with pytest.raises(ValueError, match="look_ahead=0"):
        StreamingEnhancer(FullSubNet(FullSubNetConfig(**dict(STREAMED, look_ahead=2))), cfg)


def test_server_sessions_match_jax_and_single_streams(pairs):
    """Ragged feeds, the capacity error, a reused slot and drains of partial
    hops, with the sub-band states at SLOTS x F rows: each session against
    the JAX server and against its own single stream."""
    jax_model, variables, model = pairs["streamed"]
    cfg, hop = StftConfig(**STFT, center=False), STFT["hop_length"]
    wavs = session_wavs(hop)
    server = StreamingServer(model, cfg, SLOTS, device="cpu")
    assert server._state.model_state["sb_0"].shape == (SLOTS * SMALL["num_freqs"], SMALL["sb_hidden"])
    ours, slots = drive(server, wavs, hop)
    ref, jax_slots = drive(JaxStreamingServer(jax_model, variables, JaxStftConfig(**STFT, center=False), SLOTS),
                           wavs, hop)
    assert slots == jax_slots and sorted(ours) == sorted(SESSIONS)
    for k, wav in wavs.items():
        assert ours[k].shape == ref[k].shape == wav.shape, k
        assert np.abs(ours[k] - ref[k]).max() <= 1e-4, k
        assert np.abs(ours[k] - single_stream(model, cfg, wav)).max() <= 1e-6, k


def _slot_rows(server, sid):
    """Each state leaf's rows of slot ``sid``: rep = rows / slots of them."""
    return [leaf[sid * (leaf.shape[0] // SLOTS) : (sid + 1) * (leaf.shape[0] // SLOTS)].clone()
            for leaf in tree_leaves(server._state)]


def test_server_idle_slots_keep_their_state_and_reopened_slots_start_fresh(pairs):
    model = pairs["streamed"][2]
    cfg, hop = StftConfig(**STFT, center=False), STFT["hop_length"]
    server = StreamingServer(model, cfg, SLOTS, device="cpu")
    busy, idle = server.open(), server.open()
    wav = session_wavs(hop)["b"]
    server.feed(busy, wav[: 3 * hop])
    server.feed(idle, wav[:hop])
    assert set(server.step()) == {busy, idle}
    before = {sid: _slot_rows(server, sid) for sid in range(SLOTS)}
    for _ in range(2):
        assert set(server.step()) == {busy}
    for sid in (idle, 2):
        for a, b in zip(_slot_rows(server, sid), before[sid]):
            assert torch.equal(a, b), f"slot {sid} changed while idle"
    assert all(not torch.equal(a, b) for a, b in zip(_slot_rows(server, busy), before[busy]))
    server.close(busy)
    assert server.open() == busy
    fresh = StreamingEnhancer(model, cfg).init_state(1)
    for a, b in zip(_slot_rows(server, busy), tree_leaves(fresh)):
        assert torch.equal(a, b), "a reopened slot is not fresh"
    for a, b in zip(_slot_rows(server, idle), before[idle]):
        assert torch.equal(a, b), "a reset touched another slot's rows"


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """The TOML, a bridge .npz of its model and two wavs, made once."""
    root = tmp_path_factory.mktemp("fsn_cli")
    (root / "fsn.toml").write_text(TOML)
    args = dict(num_freqs=65, num_neighbors=2, fb_hidden=32, fb_layers=1, sb_hidden=16, sb_layers=1,
                norm="cumulative_laplace_norm")
    jax_model, variables, _ = make_fullsubnet_pair(np.random.default_rng(3), args)
    save_flax_npz(variables, str(root / "w.npz"))
    (root / "in").mkdir()
    rng = np.random.default_rng(4)
    for i, n in enumerate((4000, 5123)):
        write_wav(str(root / "in" / f"utt{i}.wav"), noisy_batch(rng, 1, n)[0], 16000)
    return root, jax_model, variables


@pytest.mark.parametrize("mode", ["offline", "streaming"])
def test_cli_matches_jax(cli_inputs, mode):
    """``python -m cruse_tpu_torch.infer``'s main, in this process, on the
    TOML's complex_mask (offline) and --streaming: each wav within one int16
    step of 1e-4 of the JAX strategy or stream on the same weights."""
    root, jax_model, variables = cli_inputs
    out_dir = root / mode
    cli_main(["-C", str(root / "fsn.toml"), "-I", str(root / "in"), "-O", str(out_dir),
              "--weights", str(root / "w.npz"), "--device", "cpu"] + (["--streaming"] if mode == "streaming" else []))
    if mode == "streaming":
        run = JaxStreamingEnhancer(jax_model, variables, JaxStftConfig(n_fft=128, hop_length=64, center=False)).run
    else:
        run = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
            type="complex_mask", stft=JaxStftConfig(n_fft=128, hop_length=64),
            output_dir=str(root / "jax")))._strategy
    for i in range(2):
        noisy = read_wav(str(root / "in" / f"utt{i}.wav"))[0]
        ref = to_int16_scaled(np.asarray(run(jnp.asarray(noisy[None])))[0])
        out, sr = read_wav(str(out_dir / f"utt{i}.wav"))
        out = np.round(out * 32768.0)
        assert sr == 16000 and out.shape == ref.shape
        assert np.abs(out - ref.astype(np.float64)).max() / 32768.0 <= 1e-4, (mode, i)


@pytest.mark.parametrize("streaming", [False, True], ids=["offline", "streaming"])
def test_export_refuses_fullsubnet_by_name(cli_inputs, streaming):
    """The export CLI on the TOML's FullSubNet, which it once refused by name:
    now a round trip. Offline, the program (B=2, 0.5 s, the ``auto`` body)
    against JAX's ``auto`` and within 1e-4 of the port's eager
    ``complex_mask``; streamed, 6 hops against JAX's StreamingEnhancer."""
    root, jax_model, variables = cli_inputs
    path = root / f"fsn_{'stream' if streaming else 'offline'}.zip"
    export_main(["-C", str(root / "fsn.toml"), "-O", str(path), "--weights", str(root / "w.npz"), "--batch", "2",
                 "--device", "cpu", "--seconds", "0.5"] + (["--streaming"] if streaming else []))
    art = artifact_lib.load(str(path), "cpu")
    rng = np.random.default_rng(9)
    if not streaming:
        assert art.input_shape == (2, 8000) and art.meta["strategy"] == "complex_mask"
        noisy = noisy_batch(rng, 2, 8000)
        got = art.enhance(torch.from_numpy(noisy)).numpy()
        ref = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
            type="auto", stft=JaxStftConfig(n_fft=128, hop_length=64), output_dir=str(root / "jax")))._strategy(
            jnp.asarray(noisy))
        assert np.abs(got - np.asarray(ref)).max() < 1e-4
        model = export_build(load_config(str(root / "fsn.toml")), str(root / "w.npz"), 0, None)
        eager = BatchInferencer(model, InferencerConfig(type="complex_mask", stft=StftConfig(n_fft=128, hop_length=64)),
                                device="cpu").complex_mask(torch.from_numpy(noisy)).numpy()
        assert np.abs(got - eager).max() < 1e-4
        return
    assert art.hop_shape == (2, 64) and art.meta["num_mics"] is None
    jax_enh = JaxStreamingEnhancer(jax_model, variables, JaxStftConfig(n_fft=128, hop_length=64, center=False))
    state, j_state = art.init_state(), jax_enh.init_state(2)
    for _ in range(6):
        hop = noisy_batch(rng, 2, 64)
        out, state = art.step(state, torch.from_numpy(hop))
        j_out, j_state = jax_enh.step(j_state, jnp.asarray(hop))
        assert np.abs(out.numpy() - np.asarray(j_out)).max() < 1e-4
