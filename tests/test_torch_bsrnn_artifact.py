"""Port parity: BSRNN's deployment artifacts (``infer/export.py`` on a
``BSRNN``, ``infer/artifact.py``, ``infer/run_exported.py``), on the CPU,
at ``configs/tiny_bsrnn.toml``'s widths (``num_channel = 8``, ``num_layer =
1``; n_fft 512, hop 256), against the port's eager path and cruse_tpu.

Offline the program is the ``auto`` body of the offline model
(``tiny_bsrnn.toml``); streamed it is the hop of the causal one
(``tiny_bsrnn_causal.toml``), whose flat state carries the 64 cumulative
norms' running sums and float32 counts and the time LSTM's ``(h, c)``. The
float32 artifacts come from the export CLI (``--seed 3``), saved and loaded
through ``artifact.load`` by its reload check, which it returns; the int8
ones from ``export_offline`` / ``export_streaming`` on the model with
``attach_int8`` at a 64-element threshold, so that both LSTMs'
``weight_ih_l0`` / ``weight_hh_l0`` (and the band LSTM's ``_reverse`` pair)
and the band Linears hold int8 codes, saved, and loaded by ``run_exported``
(the other comparisons run their programs as exported). So each container
is loaded once: a load of a BSRNN container takes seconds on a CPU.

Tolerances: an artifact within 1e-5 of the port's eager path on the same
weights (int8: loaded dequantized), and within 1e-4 max-abs of the JAX
package's ``auto`` / streaming step on the same bridged weights (int8: the
JAX rule's codes and scales, dequantized); the streamed state after the hops
against eager's leaf for leaf within 1e-5, the norms' counts exactly. The
JAX references run one jitted function each whose weights are an argument,
so that float32 and int8 share one compilation.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer
from cruse_tpu.models import bsrnn as jb
from cruse_tpu.nn import quantize as jq

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer import artifact as artifact_lib
from cruse_tpu_torch.infer import export as export_lib
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.export import main as export_main
from cruse_tpu_torch.infer.run_exported import main as run_exported_main
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import BSRNN, build_from_config
from cruse_tpu_torch.nn import quantize as tq
from cruse_tpu_torch.utils.config import load_config
from cruse_tpu_torch.utils.weights import flax_from_state_dict
from tests.test_torch_artifact import one_torch_thread  # noqa: F401  (autouse, module scope)
from tests.test_torch_bsrnn import ROOT
from tests.test_torch_cruse import noisy_batch

JAX_TOL, EAGER_TOL = 1e-4, 1e-5
STFT = dict(n_fft=512, hop_length=256)
SEED, BATCH, SECONDS, HOPS = 3, 2, 0.25, 6
SAMPLES = int(SECONDS * 16000)
INT8_MIN_SIZE = 64
CONFIGS = {"offline": "tiny_bsrnn.toml", "streamed": "tiny_bsrnn_causal.toml"}
LSTMS = 2  # num_layer = 1: one time LSTM, one band LSTM


def seeded_model(kind: str) -> BSRNN:
    """The model the export CLI builds from the config with ``--seed``."""
    config = load_config(str(ROOT / "configs" / CONFIGS[kind]))
    return build_from_config(config["model"], generator=torch.Generator().manual_seed(SEED)).eval()


def _copy(model, state=None, dequantized=False):
    copy_ = BSRNN(model.config).eval()
    copy_.load_state_dict(model.state_dict())
    if state is not None:
        (tq.load_dequantized if dequantized else tq.attach_int8)(copy_, state)
    return copy_


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Per kind: the seeded model, its int8 state, the float32 artifact from
    the export CLI (saved, loaded by its reload check) and the int8 one from
    the library (saved; its program as exported)."""
    out = tmp_path_factory.mktemp("bsrnn_artifacts")
    made = {}
    for kind, name in CONFIGS.items():
        model = seeded_model(kind)
        state, report = tq.int8_state_dict(model, min_size=INT8_MIN_SIZE)
        path = out / f"{kind}_fp32.zip"
        arts = {None: export_main(["-C", str(ROOT / "configs" / name), "-O", str(path), "--seed", str(SEED),
                                   "--batch", str(BATCH), "--seconds", str(SECONDS), "--device", "cpu"]
                                  + (["--streaming"] if kind == "streamed" else []))}
        paths = {None: path, "int8": out / f"{kind}_int8.zip"}
        meta = {"device": "cpu", "quantized": "int8", "sr": 16000, "batch": BATCH, **STFT}
        if kind == "offline":
            icfg = InferencerConfig(type="auto", stft=StftConfig(**STFT))
            program = export_lib.export_offline(_copy(model, state), icfg, BATCH, SAMPLES, "cpu")
            artifact_lib.save_offline(str(paths["int8"]), program, {**meta, "length": SAMPLES})
            arts["int8"] = artifact_lib.OfflineArtifact(program, meta)
        else:
            program, init = export_lib.export_streaming(_copy(model, state), StftConfig(**STFT, center=False),
                                                        BATCH, "cpu")
            artifact_lib.save_streaming(str(paths["int8"]), program, init, meta)
            arts["int8"] = artifact_lib.StreamingArtifact(program, list(pytree.tree_leaves(init)), meta)
        made[kind] = dict(model=model, state=state, report=report, arts=arts, paths=paths)
    return made


def jax_variables(f, quant):
    """The bridged flax variables; int8: the JAX rule's codes and scales,
    dequantized (what its inferencers compute in their programs)."""
    variables = flax_from_state_dict(f["model"])
    if quant:
        variables = jq.dequantize_tree(jq.quantize_variables(variables, min_size=INT8_MIN_SIZE))
    return jax.tree_util.tree_map(jnp.asarray, variables)


@functools.lru_cache(maxsize=None)
def jax_auto():
    """JAX's ``BatchInferencer.auto`` on the offline BSRNN, the variables an argument."""
    base = JaxBatchInferencer(jb.BSRNN(num_channel=8, num_layer=1),
                              {"params": {}}, JaxInferencerConfig(type="auto", stft=JaxStftConfig(**STFT)))

    def run(variables, noisy):
        inferencer = copy.copy(base)
        inferencer.variables = variables
        return JaxBatchInferencer.auto(inferencer, noisy)

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def jax_stream():
    """JAX's ``StreamingEnhancer`` on the causal BSRNN and its step, the
    variables an argument."""
    enh = JaxStreamingEnhancer(jb.BSRNN(num_channel=8, num_layer=1, causal=True), {"params": {}},
                               JaxStftConfig(**STFT, center=False))

    def step(variables, state, hop):
        mine = copy.copy(enh)
        mine.variables = variables
        return JaxStreamingEnhancer._step_impl(mine, state, hop)

    return enh, jax.jit(step)


def lstm_nodes(program) -> list:
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function" and "lstm" in str(n.target)]


@pytest.mark.parametrize("kind", list(CONFIGS))
@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_each_program_keeps_one_aten_lstm_per_lstm(exported, kind, quant):
    """No decomposition: one ``aten.lstm.input`` node a LSTM, fed its
    parameters (int8: the dequantized weights), and no kernel op."""
    program = exported[kind]["arts"][quant].program
    assert lstm_nodes(program) == ["aten.lstm.input"] * LSTMS
    assert not [n for n in program.graph.nodes if str(n.target).startswith("cruse_tpu_torch.")]
    weights = [len(n.args[2]) for n in program.graph.nodes if str(n.target) == "aten.lstm.input"]
    assert sorted(weights) == [4, 8]  # the time LSTM's four tensors, the bidirectional band LSTM's eight


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_offline_artifact_matches_eager_and_jax(exported, rng, quant):
    f = exported["offline"]
    art = f["arts"][quant]
    assert art.kind == "offline" and art.input_shape == (BATCH, SAMPLES)
    wav = noisy_batch(rng, BATCH, SAMPLES)
    got = art.enhance(torch.from_numpy(wav)).numpy()
    eager = BatchInferencer(_copy(f["model"], f["state"] if quant else None, dequantized=True),
                            InferencerConfig(type="auto", stft=StftConfig(**STFT)), "cpu")
    assert np.abs(got - eager.auto(torch.from_numpy(wav)).numpy()).max() < EAGER_TOL
    ref = np.asarray(jax_auto()(jax_variables(f, quant), jnp.asarray(wav)))
    assert np.abs(got - ref).max() < JAX_TOL
    assert np.abs(got).max() > 1e-3


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_streaming_artifact_matches_eager_and_jax(exported, rng, quant):
    """HOPS hops against the eager step and JAX's, then the carried state
    against eager's leaf for leaf: the norms' sums and the LSTM's (h, c)
    within 1e-5, the norms' float32 counts exactly."""
    f = exported["streamed"]
    art = f["arts"][quant]
    assert art.kind == "streaming" and art.hop_shape == (BATCH, STFT["hop_length"])
    enh = StreamingEnhancer(_copy(f["model"], f["state"] if quant else None, dequantized=True),
                            StftConfig(**STFT, center=False))
    jax_enh, jax_step = jax_stream()
    variables = jax_variables(f, quant)
    state, e_state, j_state = art.init_state(), enh.init_state(BATCH), jax_enh.init_state(BATCH)
    for _ in range(HOPS):
        hop = noisy_batch(rng, BATCH, STFT["hop_length"])
        out, state = art.step(state, torch.from_numpy(hop))
        e_out, e_state = enh.step(e_state, torch.from_numpy(hop))
        j_out, j_state = jax_step(variables, j_state, jnp.asarray(hop))
        assert np.abs(out.numpy() - e_out.numpy()).max() < EAGER_TOL
        assert np.abs(out.numpy() - np.asarray(j_out)).max() < JAX_TOL
    leaves = pytree.tree_leaves(e_state.model_state)
    assert len(state.model_state) == len(leaves) == 3 * (31 + 1 + 1 + 31) + 2
    for got, want in zip(state.model_state, leaves):
        assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
        assert (got - want).abs().max() < EAGER_TOL
    counts = [t for t in state.model_state if t.dim() == 1][2::3]  # each norm's (sum, power, count)
    assert len(counts) == 64 and all(float(c.max()) > 0 for c in counts)
    for got, want in zip(counts, [t for t in leaves if t.dim() == 1][2::3]):
        assert torch.equal(got, want)


def test_int8_artifacts_hold_int8_lstm_weights(exported):
    def parameter_bytes(program):
        return sum(t.numel() * t.element_size() for t in program.state_dict.values())

    for kind, f in exported.items():
        fp32, int8 = (f["arts"][q].program for q in (None, "int8"))
        int8_names = [k for k, t in int8.state_dict.items() if t.dtype == torch.int8]
        for weight in ("weight_ih_l0", "weight_hh_l0", "weight_ih_l0_reverse", "weight_hh_l0_reverse"):
            assert any(f"lstm_k_0.rnn.parametrizations.{weight}.original0" in k for k in int8_names), (kind, weight)
        assert any("band_split.fc_" in k for k in int8_names), kind
        assert parameter_bytes(int8) < 0.5 * parameter_bytes(fp32), kind


def test_streaming_export_of_an_offline_bsrnn_raises(tmp_path):
    """``--streaming`` on the offline config: StreamingEnhancer's guard,
    before any file is written."""
    with pytest.raises(ValueError, match="causal=True"):
        export_main(["-C", str(ROOT / "configs" / CONFIGS["offline"]), "-O", str(tmp_path / "x.zip"),
                     "--streaming", "--device", "cpu"])
    assert not (tmp_path / "x.zip").exists()


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_run_exported_on_bsrnn_artifacts(exported, rng, tmp_path, capsys, kind):
    """run_exported (its ``main``, which loads the container through
    ``artifact.load``) on each kind's int8 container, the one container the
    fixture has not loaded: each wav as the int8 program, as exported,
    enhances or streams it here (offline: zero-padded to the [2, 4000]
    window; streamed: primed with the first n_fft - hop samples)."""
    f = exported[kind]
    quant = "int8"
    art = f["arts"][quant]
    lengths = {"a": 2000, "b": 3999}
    (tmp_path / "in").mkdir()
    for name, n in lengths.items():
        write_wav(str(tmp_path / "in" / f"{name}.wav"), noisy_batch(rng, 1, n)[0], 16000)
    run_exported_main(["-A", str(f["paths"][quant]), "-I", str(tmp_path / "in"), "-O", str(tmp_path / "out"),
                       "--device", "cpu"])
    assert ("enhanced 2 files" if kind == "offline" else "streamed 2 files") in capsys.readouterr().out
    wavs = [read_wav(str(tmp_path / "in" / f"{n}.wav"))[0] for n in lengths]
    hop, keep = STFT["hop_length"], STFT["n_fft"] - STFT["hop_length"]
    if kind == "offline":
        x = np.zeros((BATCH, SAMPLES), np.float32)
        for i, w in enumerate(wavs):
            x[i, : w.shape[-1]] = w
        want = art.enhance(torch.from_numpy(x)).numpy()
    else:
        n_hops = -(-(max(lengths.values()) - keep) // hop)
        feed = np.zeros((BATCH, keep + n_hops * hop), np.float32)
        for i, w in enumerate(wavs):
            feed[i, : w.shape[-1]] = w
        feed = torch.from_numpy(feed)
        state, outs = art.prime(art.init_state(), feed[:, :keep]), []
        for h in range(n_hops):
            out, state = art.step(state, feed[:, keep + hop * h : keep + hop * (h + 1)])
            outs.append(out)
        want = torch.cat(outs, -1).numpy()
    for i, (name, n) in enumerate(lengths.items()):
        got = read_wav(str(tmp_path / "out" / f"{name}.wav"))[0]
        np.testing.assert_array_equal(got, to_int16_scaled(want[i, :n]).astype(np.float32) / 32768.0)
