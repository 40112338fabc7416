"""Port parity: cruse_tpu_torch's deployment artifacts (``infer/artifact.py``,
``infer/export.py``, ``infer/run_exported.py``) and the two kernel ops they
trace, on the CPU, against cruse_tpu and against the port's eager path.

Tolerances: an artifact's output within 1e-4 max-abs of the JAX package's
``mag_to_mag`` / ``auto`` / ``StreamingEnhancer`` on the same weights (the
BASELINE contract; for int8 the JAX package's run on its own int8
variables), and within 1e-6 of the port's eager path on the same weights;
the primed streaming artifact within 1e-6 of ``StreamingEnhancer.run`` and
1e-4 of the offline ``center=False`` path past the overlap-add warm-up (as
``tests/test_torch_streaming.py``); the int8 artifact's parameter bytes
under 0.35x the float32 artifact's.
"""
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer
from cruse_tpu.nn import quantize as jq

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig, istft, stft
from cruse_tpu_torch.infer import artifact as artifact_lib
from cruse_tpu_torch.infer import export as export_lib
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.nn import quantize as tq
from cruse_tpu_torch.utils.weights import save_flax_npz
from tests.test_torch_cruse import SMALL as SMALL_CRUSE
from tests.test_torch_cruse import make_pair, noisy_batch
from tests.test_torch_cruse_df import SMALL, SMALL_TRUNK, make_df_pair
from tests.test_torch_dfsmn import SMALL as SMALL_DFSMN
from tests.test_torch_dfsmn import make_dfsmn_pair
from tests.test_torch_streaming import ROOT

JAX_TOL, EAGER_TOL = 1e-4, 1e-6
STFT = dict(n_fft=320, hop_length=160)
BATCH, SAMPLES = 2, 4800
STRATEGY = {"cruse": "mag_to_mag", "cruse_df": "auto"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops in one thread (module fixtures included): the suite
    runs several workers at once, and tiny ops on many threads each only wait
    for the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _copy(model, state=None):
    copy = type(model)(model.config).eval()
    copy.load_state_dict(model.state_dict())
    if state is not None:
        tq.attach_int8(copy, state)
    return copy


def _eager(model, state=None):
    """The port's eager model on the same weights: float32, or int8 loaded dequantized."""
    copy = _copy(model)
    if state is not None:
        tq.load_dequantized(copy, state)
    return copy


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Tiny CRUSE and CRUSE+DF, each exported offline (fp32 and int8) and
    streaming (fp32), saved and loaded once."""
    rng = np.random.default_rng(11)
    out = tmp_path_factory.mktemp("artifacts")
    made = {}
    for family, pair in (("cruse", make_pair(SMALL_CRUSE, rng)), ("cruse_df", make_df_pair(rng, SMALL_TRUNK, SMALL))):
        jax_model, variables, model = pair
        state, _ = tq.int8_state_dict(model, variables)
        icfg = InferencerConfig(type=STRATEGY[family], stft=StftConfig(**STFT))
        arts = {}
        for quant in (None, "int8"):
            program = export_lib.export_offline(_copy(model, state if quant else None), icfg, BATCH, SAMPLES, "cpu")
            path = str(out / f"{family}_{quant}.zip")
            artifact_lib.save_offline(path, program, {"device": "cpu", "quantized": quant})
            arts[quant] = artifact_lib.load(path, "cpu")
        program, init = export_lib.export_streaming(_copy(model), StftConfig(**STFT, center=False), BATCH, "cpu")
        path = str(out / f"{family}_stream.zip")
        artifact_lib.save_streaming(path, program, init, {"device": "cpu", "n_fft": 320, "hop_length": 160})
        made[family] = dict(jax_model=jax_model, variables=variables, model=model, state=state, icfg=icfg,
                            offline=arts, stream=artifact_lib.load(path), stream_path=path)
    return made


def test_opcheck_both_ops(rng):
    g = torch.Generator().manual_seed(0)
    x, h0 = torch.randn(2, 3, 2, 12, generator=g), torch.randn(2, 2, 4, generator=g)
    w, b = torch.randn(2, 12, 4, generator=g), torch.randn(2, 12, generator=g)
    for weight_dtype in (None, torch.bfloat16):
        torch.library.opcheck(torch.ops.cruse_tpu_torch.gru_sequence.default, (x, h0, w, b, weight_dtype))
    spec = torch.randn(2, 5, 12, dtype=torch.complex64, generator=g)
    coefs = torch.randn(2, 5, 8, 9, 2, generator=g)
    history = torch.randn(2, 2, 8, dtype=torch.complex64, generator=g)
    for args in ((spec[:, :, :8], coefs, 1, 1, True, None), (spec[:, :, :8], coefs, 1, 1, True, history),
                 (spec[:, :, :8].contiguous(), coefs, 1, 1, False, None)):
        torch.library.opcheck(torch.ops.cruse_tpu_torch.deep_filter.default, args)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("family", ["cruse", "cruse_df"])
def test_offline_artifact_matches_jax_and_eager(exported, rng, family, quant):
    f = exported[family]
    art = f["offline"][quant]
    assert art.kind == "offline" and art.input_shape == (BATCH, SAMPLES)
    assert art.meta["format"] == artifact_lib.FORMAT and art.meta["quantized"] == quant
    wav = noisy_batch(rng, BATCH, SAMPLES)
    got = art.enhance(torch.from_numpy(wav)).numpy()
    strategy = STRATEGY[family]
    eager = BatchInferencer(_eager(f["model"], f["state"] if quant else None), f["icfg"], "cpu")
    want = getattr(eager, strategy)(torch.from_numpy(wav)).numpy()
    assert np.abs(got - want).max() < EAGER_TOL
    variables = jq.quantize_variables(f["variables"]) if quant else f["variables"]
    jcfg = JaxInferencerConfig(type=strategy, stft=JaxStftConfig(**STFT))
    ref = np.asarray(getattr(JaxBatchInferencer(f["jax_model"], variables, jcfg), strategy)(jnp.asarray(wav)))
    assert np.abs(got - ref).max() < JAX_TOL


@pytest.mark.parametrize("family", ["cruse", "cruse_df"])
def test_int8_artifact_holds_int8_bytes(exported, family):
    def parameter_bytes(art):
        return sum(t.numel() * t.element_size() for t in art.program.state_dict.values())

    fp32, int8 = (exported[family]["offline"][q] for q in (None, "int8"))
    assert any(t.dtype == torch.int8 for t in int8.program.state_dict.values())
    assert parameter_bytes(int8) < 0.35 * parameter_bytes(fp32)


@pytest.mark.parametrize("family", ["cruse", "cruse_df"])
def test_streaming_artifact_matches_jax_and_eager(exported, rng, family):
    f = exported[family]
    art = f["stream"]
    assert art.kind == "streaming" and art.hop_shape == (BATCH, 160)
    state = art.init_state()
    assert isinstance(state, artifact_lib.StreamState) and all(torch.is_tensor(t) for t in state.model_state)
    cfg = dict(STFT, center=False)
    enh = StreamingEnhancer(f["model"], StftConfig(**cfg))
    jax_enh = JaxStreamingEnhancer(f["jax_model"], f["variables"], JaxStftConfig(**cfg))
    e_state, j_state = enh.init_state(BATCH), jax_enh.init_state(BATCH)
    for _ in range(6):
        hop = noisy_batch(rng, BATCH, 160)
        out, state = art.step(state, torch.from_numpy(hop))
        e_out, e_state = enh.step(e_state, torch.from_numpy(hop))
        j_out, j_state = jax_enh.step(j_state, jnp.asarray(hop))
        assert np.abs(out.numpy() - e_out.numpy()).max() < EAGER_TOL
        assert np.abs(out.numpy() - np.asarray(j_out)).max() < JAX_TOL


def test_primed_streaming_artifact_lines_up_with_offline(exported, rng):
    """The consumer's recipe (prime with the first n_fft - hop samples, ceil
    the hop count) gives StreamingEnhancer.run's time-aligned output, which
    is the offline center=False path past the warm-up, and covers the input."""
    f = exported["cruse_df"]
    art = f["stream"]
    wav = noisy_batch(rng, BATCH, 3930)  # not hop-aligned past the prime
    prime, hop = 160, 160
    n_hops = -(-(wav.shape[-1] - prime) // hop)
    feed = np.zeros((BATCH, prime + n_hops * hop), np.float32)
    feed[:, : wav.shape[-1]] = wav
    state = art.prime(art.init_state(), torch.from_numpy(feed[:, :prime]))
    outs = []
    for h in range(n_hops):
        out, state = art.step(state, torch.from_numpy(feed[:, prime + h * hop : prime + (h + 1) * hop]))
        outs.append(out)
    got = torch.cat(outs, dim=-1)
    cfg = StftConfig(**STFT, center=False)
    want = StreamingEnhancer(f["model"], cfg).run(torch.from_numpy(feed))
    assert got.shape == want.shape == (BATCH, n_hops * hop) and prime + n_hops * hop >= wav.shape[-1]
    assert (got - want).abs().max() < EAGER_TOL
    with torch.no_grad():
        spec = stft(torch.from_numpy(feed), cfg)
        enhanced = BatchInferencer(f["model"], f["icfg"], "cpu")._forward(torch.stack([spec.real, spec.imag], dim=-1))
        offline = istft((enhanced[..., 0], enhanced[..., 1]), cfg)
    n, m = cfg.n_fft, min(got.shape[-1], offline.shape[-1])
    assert (got[:, n : m - n] - offline[:, n : m - n]).abs().max() < JAX_TOL
    with pytest.raises(ValueError, match="prime takes"):
        art.prime(art.init_state(), torch.zeros(BATCH, 100))


def test_consumer_needs_no_model_code(exported):
    """A fresh process with jax, cruse_tpu and cruse_tpu_torch.models blocked
    loads the CRUSE+DF streaming artifact (whose model carries a NamedTuple
    of its own) through artifact.py alone and steps it."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'cruse_tpu') or name.startswith('cruse_tpu_torch.models'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from cruse_tpu_torch.infer import artifact\n"
        f"art = artifact.load({exported['cruse_df']['stream_path']!r}, 'cpu')\n"
        "state = art.prime(art.init_state(), torch.zeros(2, 160))\n"
        "for _ in range(3):\n"
        "    out, state = art.step(state, torch.randn(2, 160) * 0.1)\n"
        "assert out.shape == (2, 160) and torch.isfinite(out).all()\n"
        "for name in ('cruse_tpu_torch.models', 'cruse_tpu_torch.infer.streaming', 'cruse_tpu_torch.utils.config'):\n"
        "    assert name not in sys.modules, name\n"
        "print('CONSUMER_OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "CONSUMER_OK" in res.stdout


def test_export_then_run_exported_clis(rng, tmp_path):
    """Both CLIs as subprocesses on the CPU: configs/tiny_cruse_df.toml with
    a bridge .npz, an int8 offline artifact and a streaming one, and
    run_exported writes each wav as the artifact enhances it in the test."""
    _, variables, _ = make_df_pair(rng, SMALL_TRUNK, SMALL)  # tiny_cruse_df.toml's model
    save_flax_npz(variables, str(tmp_path / "w.npz"))
    (tmp_path / "in").mkdir()
    lengths = {"a": 4000, "b": 5123}
    for name, n in lengths.items():
        write_wav(str(tmp_path / "in" / f"{name}.wav"), noisy_batch(rng, 1, n)[0], 16000)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")  # one thread a process, as in this one
    common = ["-C", str(ROOT / "configs/tiny_cruse_df.toml"), "--weights", str(tmp_path / "w.npz"),
              "--batch", "2", "--device", "cpu"]
    runs = {"offline": ["--seconds", "0.4", "--quantize", "int8"], "stream": ["--streaming"]}

    def start(args):
        return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    procs = {k: start(["cruse_tpu_torch.infer.export", *common, "-O", str(tmp_path / f"{k}.zip"), *extra])
             for k, extra in runs.items()}
    logs = {}
    for k, p in procs.items():
        logs[k], err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        assert "reload check OK" in logs[k]
    assert "int8-quantized" in logs["offline"]
    procs = {k: start(["cruse_tpu_torch.infer.run_exported", "-A", str(tmp_path / f"{k}.zip"),
                       "-I", str(tmp_path / "in"), "-O", str(tmp_path / k), "--device", "cpu"]) for k in runs}
    for k, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    wavs = {n: read_wav(str(tmp_path / "in" / f"{n}.wav"))[0] for n in lengths}
    offline = artifact_lib.load(str(tmp_path / "offline.zip"), "cpu")
    assert offline.meta["quantized"] == "int8" and offline.input_shape == (2, 6400)
    x = np.zeros((2, 6400), np.float32)
    for i, n in enumerate(lengths):
        x[i, : lengths[n]] = wavs[n]
    want = offline.enhance(torch.from_numpy(x)).numpy()
    stream = artifact_lib.load(str(tmp_path / "stream.zip"), "cpu")
    n_hops = -(-(max(lengths.values()) - 160) // 160)  # the runner's ceil over the prime
    feed = np.pad(x[:, : lengths["b"]], ((0, 0), (0, 160 + n_hops * 160 - lengths["b"])))
    state = stream.prime(stream.init_state(), torch.from_numpy(feed[:, :160]))
    outs = []
    for h in range(n_hops):
        out, state = stream.step(state, torch.from_numpy(feed[:, 160 + h * 160 : 320 + h * 160]))
        outs.append(out)
    streamed = torch.cat(outs, dim=-1).numpy()
    for i, n in enumerate(lengths):
        got = read_wav(str(tmp_path / "offline" / f"{n}.wav"))[0]
        np.testing.assert_array_equal(got, to_int16_scaled(want[i, : lengths[n]]).astype(np.float32) / 32768.0)
        got = read_wav(str(tmp_path / "stream" / f"{n}.wav"))[0]
        keep = min(lengths[n], n_hops * 160)  # the stream's last hop ends n_hops hops past the prime
        np.testing.assert_array_equal(got, to_int16_scaled(streamed[i, :keep]).astype(np.float32) / 32768.0)


def test_dfsmn_exports_offline_and_streaming(rng):
    _, _, model = make_dfsmn_pair(rng, SMALL_DFSMN)
    icfg = InferencerConfig(type="mag_to_mag", stft=StftConfig(**STFT))
    program = export_lib.export_offline(model, icfg, 1, 3200, "cpu")
    wav = torch.from_numpy(noisy_batch(rng, 1, 3200))
    want = BatchInferencer(model, icfg, "cpu").mag_to_mag(wav)
    with torch.no_grad():
        assert (program.module()(wav) - want).abs().max() < EAGER_TOL
    cfg = StftConfig(**STFT, center=False)
    program, state = export_lib.export_streaming(model, cfg, 1, "cpu")
    enh = StreamingEnhancer(model, cfg)
    e_state = enh.init_state(1)
    step = program.module()
    for _ in range(4):
        hop = torch.from_numpy(noisy_batch(rng, 1, 160))
        with torch.no_grad():
            out, state = step(state, hop)
        e_out, e_state = enh.step(e_state, hop)
        assert (out - e_out).abs().max() < EAGER_TOL


def test_load_refuses_another_device(exported, tmp_path):
    path = exported["cruse"]["stream_path"]
    with pytest.raises(ValueError, match="exported on cpu"):
        artifact_lib.load(path, "cuda")
    moved = str(tmp_path / "moved.zip")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(moved, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename == "meta.json":
                data = json.dumps(dict(json.loads(data), device="cuda:0")).encode()
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="exported on cuda:0"):
        artifact_lib.load(moved, "cpu")
    assert artifact_lib.load(path, "cpu").kind == "streaming"
