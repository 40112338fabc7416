"""Port parity: serving cruse_tpu_torch's BSRNN against cruse_tpu, on the CPU
at ``configs/tiny_bsrnn*.toml``'s widths (16 kHz, n_fft 512, hop 256,
``num_channel = 8``, ``num_layer = 1``): the ``auto`` strategy offline and
causal, ``enhance_long``, the causal stream hop by hop, the server (alone
and beside a CRUSE+DF pool in a ``MultiModelServer``), the infer and serve
CLIs (``--quantize int8`` too), and the refusals (the mask strategies, the
streaming guards). Its export is tests/test_torch_bsrnn_artifact.py's.

The port's seeded weights cross the bridge to JAX. Tolerances: waveforms
1e-4 max-abs against JAX (the BASELINE contract); the stream against the
port's own offline causal ``center=False`` call 1e-4 past the first
``n_fft`` samples; a server session against its own single stream 1e-6;
the CLIs' wavs within one int16 step of the same model run in this process.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig, istft, stft
from cruse_tpu_torch.infer.__main__ import main as infer_main
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.serve import build_model
from cruse_tpu_torch.infer.serve import main as serve_main
from cruse_tpu_torch.infer.server import MultiModelServer, StreamingServer, tree_leaves
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import BSRNN, BsrnnConfig, CruseConfig, CruseDfConfig, CruseDfNet
from cruse_tpu_torch.train.step import forward_for_model
from cruse_tpu_torch.utils.weights import save_flax_npz
from tests.test_torch_bsrnn import ROOT, N, make_pair
from tests.test_torch_cruse import noisy_batch
from tests.test_torch_server import SESSIONS, drive, session_wavs, single_stream

STFT = dict(n_fft=512, hop_length=256)
CHUNK_SECONDS = 0.5  # 8,000 samples: 32 hops of 256 (enhance_long keeps chunks hop-aligned)
SLOTS = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The offline and the causal pair, and the JAX outputs the tests hold
    the port to, each JAX program compiled once: ``auto`` on [2, 4000] for
    both, ``enhance_long`` of [1, 20000] in 0.5 s chunks, the causal stream
    of [2, 6000]."""
    out_dir = str(tmp_path_factory.mktemp("bsrnn_jax"))
    rng = np.random.default_rng(21)
    made = {"offline": make_pair(False, 1, seed=5), "causal": make_pair(True, 1, seed=6)}
    noisy, long_wav, stream_wav = noisy_batch(rng, 2, 4000), noisy_batch(rng, 1, 20000), noisy_batch(rng, 2, 6000)
    auto = {}
    for name, (jax_model, variables, _) in made.items():
        inf = JaxBatchInferencer(jax_model, {"params": variables["params"]}, JaxInferencerConfig(
            type="auto", stft=JaxStftConfig(**STFT), output_dir=out_dir))
        auto[name] = np.asarray(inf._strategy(jnp.asarray(noisy)))
        if name == "offline":
            long_ref = np.asarray(inf.enhance_long(jnp.asarray(long_wav), chunk_seconds=CHUNK_SECONDS))
    jax_model, variables, _ = made["causal"]
    stream_ref = np.asarray(JaxStreamingEnhancer(jax_model, {"params": variables["params"]},
                                                 JaxStftConfig(**STFT, center=False)).run(jnp.asarray(stream_wav)))
    return dict(made=made, noisy=noisy, auto=auto, long_wav=long_wav, long_ref=long_ref, stream_wav=stream_wav,
                stream_ref=stream_ref)


@pytest.mark.parametrize("variant", ["offline", "causal"])
def test_auto_matches_jax(refs, variant):
    model = refs["made"][variant][2]
    inf = BatchInferencer(model, InferencerConfig(type="auto", stft=StftConfig(**STFT)), device="cpu")
    ours = inf.auto(torch.from_numpy(refs["noisy"])).numpy()
    assert ours.shape == refs["auto"][variant].shape == refs["noisy"].shape
    err = np.abs(ours - refs["auto"][variant]).max()
    assert err < 1e-4, f"auto waveform max-abs {err} >= 1e-4"


def test_enhance_long_matches_jax(refs):
    """Each 0.5 s chunk through ``auto`` (the offline GroupNorm reads only its
    chunk), stitched by ``overlap_cat``, against JAX's ``enhance_long``."""
    inf = BatchInferencer(refs["made"]["offline"][2], InferencerConfig(type="auto", stft=StftConfig(**STFT)),
                          device="cpu")
    ours = inf.enhance_long(torch.from_numpy(refs["long_wav"]), chunk_seconds=CHUNK_SECONDS).numpy()
    assert ours.shape == refs["long_ref"].shape == refs["long_wav"].shape
    err = np.abs(ours - refs["long_ref"]).max()
    assert err < 1e-4, f"enhance_long max-abs {err} >= 1e-4"


def test_mask_strategies_refuse_bsrnn(refs):
    model = refs["made"]["offline"][2]
    with pytest.raises(ValueError, match="type='auto'"):
        BatchInferencer(model, InferencerConfig(type="mag_to_mag", stft=StftConfig(**STFT)), device="cpu")
    with pytest.raises(ValueError, match="cIRM model"):
        BatchInferencer(model, InferencerConfig(type="complex_mask", stft=StftConfig(**STFT)), device="cpu")


def test_stream_matches_jax_and_the_offline_causal_call(refs):
    """Hop by hop against JAX's StreamingEnhancer, and against the port's own
    offline center=False call of the causal model through the auto adapter."""
    model = refs["made"]["causal"][2]
    cfg = StftConfig(**STFT, center=False)
    wav = refs["stream_wav"]
    streamed = StreamingEnhancer(model, cfg).run(torch.from_numpy(wav))
    assert streamed.shape == refs["stream_ref"].shape == (2, (6000 - 256) // 256 * 256)
    err = np.abs(streamed.numpy() - refs["stream_ref"]).max()
    assert err < 1e-4, f"streamed waveform max-abs {err} >= 1e-4"
    with torch.no_grad():
        spec = stft(torch.from_numpy(wav), cfg)
        out = forward_for_model(model)(torch.stack([spec.real, spec.imag], dim=-1))
        offline = istft((out[..., 0], out[..., 1]), cfg)
    n, m = cfg.n_fft, min(streamed.shape[-1], offline.shape[-1])
    np.testing.assert_allclose(streamed[:, n : m - n].numpy(), offline[:, n : m - n].numpy(), atol=1e-4)


def test_streaming_guards(refs):
    with pytest.raises(ValueError, match="causal=True"):
        StreamingEnhancer(refs["made"]["offline"][2], StftConfig(**STFT, center=False))
    with pytest.raises(ValueError, match="n_fft=512"):
        StreamingEnhancer(refs["made"]["causal"][2], StftConfig(n_fft=320, hop_length=160, center=False))


def test_server_sessions_match_single_streams(refs):
    """Ragged feeds, the capacity error, a reused slot and drains of partial
    hops, the time LSTMs' state at SLOTS x 31 rows and the norms' at SLOTS:
    each session against its own single stream."""
    model = refs["made"]["causal"][2]
    cfg, hop = StftConfig(**STFT, center=False), STFT["hop_length"]
    wavs = session_wavs(hop)
    server = StreamingServer(model, cfg, SLOTS, device="cpu")
    assert server._state.model_state["time_lstm"][0][0].shape == (SLOTS * 31, 1, 2 * N)
    assert server._state.model_state["split"][0][0].shape == (SLOTS,)
    ours, _ = drive(server, wavs, hop)
    assert sorted(ours) == sorted(SESSIONS)
    for k, wav in wavs.items():
        assert ours[k].shape == wav.shape, k
        assert np.abs(ours[k] - single_stream(model, cfg, wav)).max() <= 1e-6, k


def test_server_idle_slots_keep_their_state_and_reopened_slots_start_fresh(refs):
    """An idle slot's norm carries and LSTM rows stay bit for bit while
    another slot steps; a reopened slot's rows are a fresh state's."""
    model = refs["made"]["causal"][2]
    cfg, hop = StftConfig(**STFT, center=False), STFT["hop_length"]
    server = StreamingServer(model, cfg, SLOTS, device="cpu")

    def rows(sid):
        return [leaf[sid * (leaf.shape[0] // SLOTS) : (sid + 1) * (leaf.shape[0] // SLOTS)].clone()
                for leaf in tree_leaves(server._state)]

    busy, idle = server.open(), server.open()
    wav = session_wavs(hop)["b"]
    server.feed(busy, wav[: 3 * hop])
    server.feed(idle, wav[:hop])
    assert set(server.step()) == {busy, idle}
    before = {sid: rows(sid) for sid in range(SLOTS)}
    for _ in range(2):
        assert set(server.step()) == {busy}
    for sid in (idle, 2):
        assert all(torch.equal(a, b) for a, b in zip(rows(sid), before[sid])), f"slot {sid} changed while idle"
    assert not all(torch.equal(a, b) for a, b in zip(rows(busy), before[busy]))
    server.close(busy)
    assert server.open() == busy
    fresh = StreamingEnhancer(model, cfg).init_state(1)
    assert all(torch.equal(a, b) for a, b in zip(rows(busy), tree_leaves(fresh))), "a reopened slot is not fresh"


def test_bsrnn_pool_beside_a_cruse_df_pool(refs):
    """A MultiModelServer with a BSRNN pool (n_fft 512, hop 256) beside a
    CRUSE+DF pool (n_fft 320, hop 160): each session against its own single
    stream."""
    bsrnn = refs["made"]["causal"][2]
    df = CruseDfNet(CruseDfConfig(cruse=CruseConfig(in_freq=161, channels=(4, 4, 8, 8), rnn_groups=2), df_bins=16),
                    generator=torch.Generator().manual_seed(3)).eval()
    cfgs = {"bsrnn": StftConfig(**STFT, center=False), "df": StftConfig(n_fft=320, hop_length=160, center=False)}
    server = MultiModelServer()
    server.add_model("bsrnn", bsrnn, cfgs["bsrnn"], max_streams=2, device="cpu")
    server.add_model("df", df, cfgs["df"], max_streams=2, device="cpu")
    wavs = session_wavs(256, seed=3)
    inputs = {"bsrnn": wavs["b"][: 5 * 256], "df": wavs["c"][: 6 * 160]}
    handles = {"bsrnn": server.open("bsrnn"), "df": server.open("df", priority=1)}
    for name, handle in handles.items():
        server.feed(handle, inputs[name])
    outs = {name: [] for name in handles}
    while any(server.ready(h) for h in handles.values()):
        for (name, _), hop in server.step().items():
            outs[name].append(hop)
    for name, model in (("bsrnn", bsrnn), ("df", df)):
        alone = single_stream(model, cfgs[name], inputs[name])
        assert np.abs(np.concatenate(outs[name]) - alone).max() <= 1e-6, name


TOML = """[meta]
seed = 0
[acoustics]
n_fft = 512
hop_length = 256
sr = 16000
[model]
path = "cruse_tpu.models.bsrnn.BSRNN"
[model.args]
num_channel = 8
num_layer = 1
causal = true
[inferencer]
type = "auto"
"""


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory, refs):
    """configs/tiny_bsrnn_causal.toml's model section, a bridge .npz of the
    causal pair's weights and two wavs, made once."""
    root = tmp_path_factory.mktemp("bsrnn_cli")
    (root / "bsrnn.toml").write_text(TOML)
    save_flax_npz(refs["made"]["causal"][1], str(root / "w.npz"))
    (root / "in").mkdir()
    rng = np.random.default_rng(4)
    for i, n in enumerate((4000, 5123)):
        write_wav(str(root / "in" / f"utt{i}.wav"), noisy_batch(rng, 1, n)[0], 16000)
    return root


def _int16(y: np.ndarray) -> np.ndarray:
    return to_int16_scaled(y).astype(np.float64) / 32768.0


@pytest.mark.parametrize("mode", ["offline", "streaming"])
def test_infer_cli(refs, cli_inputs, mode):
    """``python -m cruse_tpu_torch.infer``'s main on the causal TOML with the
    bridged weights: ``auto`` offline and ``--streaming``, each wav within one
    int16 step of the same model's call in this process."""
    root, model = cli_inputs, refs["made"]["causal"][2]
    out_dir = root / mode
    infer_main(["-C", str(root / "bsrnn.toml"), "-I", str(root / "in"), "-O", str(out_dir),
                "--weights", str(root / "w.npz"), "--device", "cpu"] + (["--streaming"] if mode == "streaming" else []))
    if mode == "streaming":
        run = StreamingEnhancer(model, StftConfig(**STFT, center=False)).run
    else:
        run = BatchInferencer(model, InferencerConfig(type="auto", stft=StftConfig(**STFT)), device="cpu").auto
    for i in range(2):
        noisy = read_wav(str(root / "in" / f"utt{i}.wav"))[0]
        want = _int16(run(torch.from_numpy(noisy[None]))[0].numpy())
        out = read_wav(str(out_dir / f"utt{i}.wav"))[0]
        assert out.shape == want.shape
        assert np.abs(out - want).max() <= 1.5 / 32768.0, (mode, i)


def test_serve_cli_int8(cli_inputs):
    """The serve CLI on the causal TOML with ``--quantize int8``: each wav
    is the session ``run_session`` gives on the int8-loaded model."""
    root = cli_inputs
    serve_main(["-M", f"bsrnn={root / 'bsrnn.toml'}:{root / 'w.npz'}", "-I", str(root / "in"),
                "-O", str(root / "served"), "--max_streams", "2", "--quantize", "int8", "--device", "cpu"])
    model, cfg, _ = build_model(str(root / "bsrnn.toml"), str(root / "w.npz"), 0, "int8")
    for i in range(2):
        noisy = read_wav(str(root / "in" / f"utt{i}.wav"))[0]
        padded = np.pad(noisy, (0, (-len(noisy)) % cfg.hop_length))
        want = _int16(StreamingServer(model, cfg, 1, device="cpu").run_session(padded)[: len(noisy)])
        out = read_wav(str(root / "served" / f"utt{i}.wav"))[0]
        assert out.shape == want.shape and np.abs(out - want).max() <= 1.5 / 32768.0, i


def test_offline_bsrnn_config_streams_nothing(tmp_path):
    """configs/tiny_bsrnn.toml (offline) through the infer CLI's --streaming
    is refused by the streaming guard."""
    write_wav(str(tmp_path / "a.wav"), np.zeros(2000, np.float32), 16000)
    with pytest.raises(ValueError, match="causal=True"):
        infer_main(["-C", str(ROOT / "configs" / "tiny_bsrnn.toml"), "-I", str(tmp_path), "-O", str(tmp_path / "o"),
                    "--streaming", "--device", "cpu"])


def test_int8_stream_is_close_to_fp32(cli_inputs, refs):
    """The int8-loaded causal model streams within a few percent of the
    float32 one (weight-only int8 moves the output, it does not break it)."""
    model, cfg, _ = build_model(str(cli_inputs / "bsrnn.toml"), str(cli_inputs / "w.npz"), 0, "int8")
    wav = torch.from_numpy(refs["stream_wav"])
    q = StreamingEnhancer(model, cfg).run(wav)
    f = StreamingEnhancer(refs["made"]["causal"][2], cfg).run(wav)
    assert isinstance(model, BSRNN) and model.config == BsrnnConfig(8, 1, True)
    rel = float((q - f).norm() / f.norm())
    assert 0 < rel < 0.1, rel
