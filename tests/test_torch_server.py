"""Port parity: cruse_tpu_torch's concurrent-stream server, its multi-model
priority scheduler and the serve CLI against cruse_tpu's, on the CPU.

The same calls (interleaved sessions fed in ragged chunks, the capacity
error, a reused slot, ``drain`` of a partial hop) go to the JAX package's
``StreamingServer`` and the port's, for CRUSE, CRUSE+DF, DFSMN and a windowed
MTFAA, each pair carrying the same weights through the bridge. Tolerances:
1e-4 max-abs against the JAX server (the streaming tests' bound); 1e-6
against the port's own unprimed single stream at B=1 (the JAX server tests'
bound); the scheduler's dispatch order exactly; idle and reset slots' state
bit for bit.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.server import MultiModelServer as JaxMultiModelServer
from cruse_tpu.infer.server import StreamingServer as JaxStreamingServer
from cruse_tpu.models import mtfaa as jm

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer.serve import build_model
from cruse_tpu_torch.infer.serve import main as serve_main
from cruse_tpu_torch.infer.server import MultiModelServer, StreamingServer, tree_leaves
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import MtfaaConfig, MtfaaNet
from cruse_tpu_torch.utils.weights import save_flax_npz, state_dict_from_flax
from tests.test_torch_cruse import SMALL as SMALL_CRUSE
from tests.test_torch_cruse import make_pair
from tests.test_torch_cruse_df import SMALL as SMALL_HEAD
from tests.test_torch_cruse_df import SMALL_TRUNK, make_df_pair
from tests.test_torch_dfsmn import SMALL as SMALL_DFSMN
from tests.test_torch_dfsmn import make_dfsmn_pair
from tests.test_torch_tfcm import perturbed

ROOT = Path(__file__).resolve().parent.parent
SLOTS = 3
JAX_TOL = 1e-4
SINGLE_TOL = 1e-6
TINY_MTFAA = dict(n_fft=256, n_bands=32, channels=(4, 6, 8), tfcm_layers=1, attention_window=4)


def make_mtfaa_pair(rng, args: dict):
    """tests/test_torch_mtfaa.py's pair (perturbed BatchNorm statistics and
    PReLU slopes), its JAX variables made by one jitted init."""
    jax_model = jm.MtfaaNet(jm.MtfaaConfig(**args))
    cspec = jnp.zeros((1, 4, jax_model.config.num_bins, 2), jnp.float32)
    variables = perturbed(jax.jit(jax_model.init)(jax.random.PRNGKey(0), cspec), rng)
    model = MtfaaNet(MtfaaConfig(**args)).eval()
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return jax_model, variables, model


FAMILIES = {  # name -> (pair maker, n_fft, hop)
    "cruse": (lambda rng: make_pair(SMALL_CRUSE, rng), 320, 160),
    "cruse_df": (lambda rng: make_df_pair(rng, SMALL_TRUNK, SMALL_HEAD), 320, 160),
    "dfsmn": (lambda rng: make_dfsmn_pair(rng, SMALL_DFSMN), 320, 160),
    "mtfaa": (lambda rng: make_mtfaa_pair(rng, TINY_MTFAA), 256, 128),
}
# (length in hops, extra samples, feed sizes in hops, cycled); "a" ends first, so "d" reuses its slot
SESSIONS = {"a": (3, 37, (0.5, 2.25, 1.1)), "b": (6, 11, (2.3, 0.08, 1.6, 0.9)),
            "c": (4, 90, (0.0, 1.4, 0.7, 2.0)), "d": (4, 5, (1.25, 0.6))}


@pytest.fixture(scope="module")
def families():
    """Each family's JAX pair, port model and server of SLOTS slots, made once."""
    made = {}

    def get(name):
        if name not in made:
            maker, n_fft, hop = FAMILIES[name]
            jax_model, variables, model = maker(np.random.default_rng(5))
            cfg = StftConfig(n_fft=n_fft, hop_length=hop, center=False)
            made[name] = dict(jax_model=jax_model, variables=variables, model=model, cfg=cfg, hop=hop,
                              jcfg=JaxStftConfig(n_fft=n_fft, hop_length=hop, center=False))
        return made[name]
    return get


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU ops in one thread: the suite runs several workers at
    once, and tiny ops on many threads each only wait for the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def session_wavs(hop: int, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(n * hop + extra) * 0.1).astype(np.float32)
            for k, (n, extra, _) in SESSIONS.items()}


def single_stream(model, cfg: StftConfig, wav: np.ndarray) -> np.ndarray:
    """The port's unprimed B=1 stream of wav zero-padded to whole hops,
    trimmed to wav's length: what a server session returns."""
    enh = StreamingEnhancer(model, cfg)
    padded = np.pad(wav, (0, (-len(wav)) % cfg.hop_length))
    out, _ = enh.step_multi(enh.init_state(1), torch.from_numpy(padded[None]))
    return out[0, : len(wav)].numpy()


def drive(server, wavs: dict, hop: int) -> tuple[dict, dict]:
    """Sessions a, b, c opened at once (a fourth open must fail), fed ragged
    chunks an iteration, stepped together; each drained and closed when its
    input is in, and d opened in the first freed slot. Returns ({session:
    output}, {session: slot})."""
    slots, outs, pos, turn = {}, {k: [] for k in wavs}, {k: 0 for k in wavs}, {k: 0 for k in wavs}
    for k in "abc":
        slots[k] = server.open()
    with pytest.raises(RuntimeError, match="busy"):
        server.open()
    live, waiting = ["a", "b", "c"], ["d"]
    while live:
        for k in live:
            sizes = SESSIONS[k][2]
            n = int(sizes[turn[k] % len(sizes)] * hop)
            turn[k] += 1
            server.feed(slots[k], wavs[k][pos[k] : pos[k] + n])
            pos[k] = min(pos[k] + n, len(wavs[k]))
        label = {slots[k]: k for k in live}
        for sid, out in server.step().items():
            outs[label[sid]].append(np.asarray(out))
        for k in list(live):
            if pos[k] == len(wavs[k]) and not server.ready(slots[k]):
                outs[k].append(np.asarray(server.drain(slots[k])))
                assert server.drain(slots[k]).shape == (0,)
                server.close(slots[k])
                live.remove(k)
                if waiting:
                    nxt = waiting.pop()
                    slots[nxt] = server.open()
                    live.append(nxt)
    return {k: np.concatenate(v) for k, v in outs.items()}, slots


@pytest.mark.parametrize("family", list(FAMILIES))
def test_interleaved_sessions_match_jax_and_single_streams(families, family):
    """Ragged feeds, the capacity error, a reused slot and drains of partial
    hops give, session by session, the JAX server's output and the port's
    own single stream."""
    f = families(family)
    wavs = session_wavs(f["hop"])
    ours, slots = drive(StreamingServer(f["model"], f["cfg"], SLOTS, device="cpu"), wavs, f["hop"])
    ref, jax_slots = drive(JaxStreamingServer(f["jax_model"], f["variables"], f["jcfg"], SLOTS), wavs, f["hop"])
    assert slots == jax_slots and slots["d"] == slots["a"] == 0
    for k, wav in wavs.items():
        assert ours[k].shape == ref[k].shape == wav.shape, k
        err = np.abs(ours[k] - ref[k]).max()
        assert err <= JAX_TOL, f"{family} session {k}: port vs JAX server max-abs {err}"
        err = np.abs(ours[k] - single_stream(f["model"], f["cfg"], wav)).max()
        assert err <= SINGLE_TOL, f"{family} session {k}: server vs single stream max-abs {err}"


def _slot_rows(server, sid):
    return [leaf[sid].clone() for leaf in tree_leaves(server._state)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_idle_slots_keep_their_state_and_reopened_slots_start_fresh(families, family):
    f = families(family)
    hop = f["hop"]
    server = StreamingServer(f["model"], f["cfg"], SLOTS, device="cpu")
    busy, idle = server.open(), server.open()  # the third slot stays free
    wav = session_wavs(hop)["b"]
    server.feed(busy, wav[: 3 * hop])
    server.feed(idle, wav[: hop])
    assert set(server.step()) == {busy, idle}
    before = {sid: _slot_rows(server, sid) for sid in range(SLOTS)}
    for _ in range(2):
        assert set(server.step()) == {busy}
    for sid in (idle, 2):
        for a, b in zip(_slot_rows(server, sid), before[sid]):
            assert torch.equal(a, b), f"slot {sid} changed while idle"
    assert any(not torch.equal(a, b) for a, b in zip(_slot_rows(server, busy), before[busy]))
    server.close(busy)
    assert server.open() == busy
    fresh = StreamingEnhancer(f["model"], f["cfg"]).init_state(1)
    for a, b in zip(_slot_rows(server, busy), tree_leaves(fresh)):
        assert a.dtype == b[0].dtype and torch.equal(a, b[0]), "a reopened slot is not fresh"
    assert server.step() == {}  # nothing buffered for the reopened slot, the idle one is empty too
    assert server.steps == 3


def _schedule(server, hop: int, wav: np.ndarray) -> list:
    """Strict priority, then round robin on a tie, then a mixed load with
    some rationed steps. Returns [(sorted handles, outputs)] of every step."""
    log = []

    def step(max_dispatches):
        res = server.step(max_dispatches=max_dispatches)
        log.append((sorted(res), {h: np.asarray(v) for h, v in res.items()}))
        return sorted(res)

    low, high = server.open("big", priority=0), server.open("small", priority=5)
    server.feed(low, wav[: 2 * hop])
    server.feed(high, wav[:hop])
    assert [step(1) for _ in range(4)] == [[high], [low], [low], []]
    server.close(low), server.close(high)
    s1, s2 = server.open("big", priority=1), server.open("small", priority=1)
    server.feed(s1, wav[: 3 * hop])
    server.feed(s2, wav[: 3 * hop])
    served = [step(1) for _ in range(6)]
    assert [h[0][0] for h in served] == ["small", "big"] * 3 or [h[0][0] for h in served] == ["big", "small"] * 3
    server.close(s1), server.close(s2)
    handles = [server.open("big", 0), server.open("big", 2), server.open("small", 1), server.open("small", 1)]
    for i, h in enumerate(handles):
        server.feed(h, wav[: (2 + i) * hop + 7 * i])
    for i in range(8):
        step(1 if i % 3 else None)
    return log


def test_multi_model_dispatch_order_matches_jax(families):
    """Two CRUSE pools: every step(max_dispatches=...) serves the same
    handles as the JAX package's scheduler, with the same outputs."""
    big = families("cruse")
    jax_small, small_variables, small = make_pair(dict(in_freq=161, channels=(2, 4, 4, 8), rnn_groups=2),
                                                  np.random.default_rng(6), seed=1)
    ours, ref = MultiModelServer(), JaxMultiModelServer()
    for name, (jm, v, m) in {"big": (big["jax_model"], big["variables"], big["model"]),
                             "small": (jax_small, small_variables, small)}.items():
        ours.add_model(name, m, big["cfg"], max_streams=2, device="cpu")
        ref.add_model(name, jm, v, big["jcfg"], max_streams=2)
    assert ours.models == ref.models == ["big", "small"]
    wav = session_wavs(160)["b"]
    got, want = _schedule(ours, 160, wav), _schedule(ref, 160, wav)
    assert [handles for handles, _ in got] == [handles for handles, _ in want]
    for (_, a), (_, b) in zip(got, want):
        for h in a:
            assert np.abs(a[h] - b[h]).max() <= JAX_TOL, h


def test_unported_options_are_refused(families, monkeypatch, tmp_path):
    f = families("cruse")
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        StreamingServer(f["model"], f["cfg"], SLOTS, device="cpu", mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingServer(f["model"], f["cfg"], SLOTS)  # the card by default
    base = ["-M", f"m={ROOT / 'configs/tiny_cruse.toml'}", "-I", str(tmp_path), "-O", str(tmp_path / "out")]
    with pytest.raises(SystemExit, match="torch.distributed"):
        serve_main([*base, "-N", "2", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(base)


def test_serve_cli_writes_each_session(families, rng, tmp_path, capsys):
    """The serve CLI on two tiny configs (CRUSE with bridged weights, DFSMN
    from the seed), sessions from a manifest and a directory with
    @model:priority, two slots a pool so slots are reused, rationed steps and
    bursty feeds: each wav it writes is that session's ``run_session`` output
    (zero-padded to whole hops, trimmed to the input) after int16 scaling."""
    save_flax_npz(families("cruse")["variables"], str(tmp_path / "w.npz"))  # configs/tiny_cruse.toml's model
    lengths = {"m0": 4000, "m1": 3333, "m2": 2561, "d0": 3900, "d1": 1777}
    for name, n in lengths.items():
        sub = tmp_path / ("dir" if name.startswith("d") else "wavs")
        write_wav(str(sub / f"{name}.wav"), (rng.standard_normal(n) * 0.1).astype(np.float32), 16000)
    manifest = tmp_path / "list.txt"
    manifest.write_text("".join(f"{tmp_path / 'wavs' / n}.wav\n" for n in ("m0", "m1", "m2")))
    cruse_toml, dfsmn_toml = ROOT / "configs/tiny_cruse.toml", ROOT / "configs/tiny_dfsmn.toml"
    serve_main(["-M", f"base={cruse_toml}:{tmp_path / 'w.npz'}", "-M", f"fsmn={dfsmn_toml}",
                "-I", f"{manifest}@base:0", "-I", f"{tmp_path / 'dir'}@fsmn:2", "-O", str(tmp_path / "out"),
                "--max_streams", "2", "--max_dispatches", "1", "--feed_chunk", "3", "--seed", "4",
                "--device", "cpu"])
    log = capsys.readouterr().out
    assert "5 sessions queued over 2 model(s)" in log and "realtime aggregate" in log
    models = {"m": build_model(str(cruse_toml), str(tmp_path / "w.npz"), 4),
              "d": build_model(str(dfsmn_toml), None, 4)}
    for name, n in lengths.items():
        model, cfg, sr = models[name[0]]
        noisy = read_wav(str(tmp_path / ("dir" if name[0] == "d" else "wavs") / f"{name}.wav"))[0]
        padded = np.pad(noisy, (0, (-n) % cfg.hop_length))
        ref = to_int16_scaled(StreamingServer(model, cfg, 1, device="cpu").run_session(padded)[:n])
        out, out_sr = read_wav(str(tmp_path / "out" / f"{name}.wav"))
        assert out_sr == sr and out.shape == (n,), name
        err = np.abs(np.round(out * 32768.0) - ref.astype(np.float64)).max() / 32768.0
        assert err <= 1e-4, f"{name}: served wav vs run_session max-abs {err}"


def test_serve_cli_realtime_reports_its_qos(rng, tmp_path, capsys):
    write_wav(str(tmp_path / "in" / "a.wav"), (rng.standard_normal(1700) * 0.1).astype(np.float32), 16000)
    serve_main(["-M", f"m={ROOT / 'configs/tiny_cruse.toml'}", "-I", str(tmp_path / "in"),
                "-O", str(tmp_path / "out"), "--realtime", "--device", "cpu"])
    log = capsys.readouterr().out
    assert "realtime QoS: iteration p50" in log and "deadlines missed" in log
    assert read_wav(str(tmp_path / "out" / "a.wav"))[0].shape == (1700,)
