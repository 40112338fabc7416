"""Port parity: FullSubNet's deployment artifacts (``infer/export.py`` on a
``FullSubNet``, ``infer/artifact.py``, ``infer/run_exported.py``), on the
CPU, at ``configs/tiny_fullsubnet.toml``'s widths (65 bins, 2 neighbours, a
full band of 32 units, a sub band of 16, one GRU layer each; n_fft 128, hop
64), against cruse_tpu and against the port's eager path.

Offline the program is the ``auto`` body (``BatchInferencer._auto_impl``,
the cIRM from ``sqrt(|X|² + 1e-12)``), as the JAX exporter exports it, with
the offline Laplace norm; streamed it is the hop of the cumulative-norm
model, whose state carries the GRU states (the sub band's at B·F rows) and
the norms' running sums and float32 counts. Each in float32 and int8 (the
int8 rule at a 64-element threshold, so that both GRUs' ``w_hh`` are int8).

Tolerances: an artifact within 1e-6 of the port's eager path on the same
weights (int8: loaded dequantized), the offline one within 1e-4 of eager
``complex_mask``, and both within 1e-4 max-abs of the JAX package's ``auto``
/ ``StreamingEnhancer`` on the same bridged weights (int8: the JAX rule's
variables); the streamed state after the hops equals eager's leaf for leaf
(the counts exactly).
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer
from cruse_tpu.nn import quantize as jq

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer import artifact as artifact_lib
from cruse_tpu_torch.infer import export as export_lib
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.run_exported import main as run_exported_main
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import FullSubNet
from cruse_tpu_torch.nn import quantize as tq
from tests.test_torch_artifact import one_torch_thread  # noqa: F401  (autouse, module scope)
from tests.test_torch_cruse import noisy_batch
from tests.test_torch_fullsubnet import make_fullsubnet_pair
from tests.test_torch_streaming import ROOT

JAX_TOL, EAGER_TOL = 1e-4, 1e-6
STFT = dict(n_fft=128, hop_length=64)
TINY = dict(num_freqs=65, num_neighbors=2, fb_hidden=32, fb_layers=1, sb_hidden=16, sb_layers=1)
NETS = {"offline": dict(TINY, norm="offline_laplace_norm"), "streamed": dict(TINY, norm="cumulative_laplace_norm")}
BATCH, SAMPLES, HOPS = 2, 4000, 8
INT8_MIN_SIZE = 64


def _copy(model, state=None, dequantized=False):
    """A copy of ``model``: float32, with ``state``'s int8 leaves kept in it
    (export), or loaded dequantized (eager)."""
    copy = FullSubNet(model.config).eval()
    copy.load_state_dict(model.state_dict())
    if state is not None:
        (tq.load_dequantized if dequantized else tq.attach_int8)(copy, state)
    return copy


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The offline-norm net exported offline and the cumulative-norm net
    streamed, float32 and int8, each once; the float32 offline program and
    the int8 stream through a saved container and ``artifact.load``."""
    rng = np.random.default_rng(31)
    out = tmp_path_factory.mktemp("fsn_artifacts")
    icfg = InferencerConfig(type="complex_mask", stft=StftConfig(**STFT))
    made = {}
    for name, args in NETS.items():
        jax_model, variables, model = make_fullsubnet_pair(rng, args)
        state, report = tq.int8_state_dict(model, variables, min_size=INT8_MIN_SIZE)
        arts, paths = {}, {}
        for quant in (None, "int8"):
            meta = {"device": "cpu", "quantized": quant, "n_fft": 128, "hop_length": 64}
            exporting = _copy(model, state) if quant else model
            path = out / f"{name}_{quant or 'fp32'}.zip"
            if name == "offline":
                program = export_lib.export_offline(exporting, icfg, BATCH, SAMPLES, "cpu")
                if quant is None:
                    artifact_lib.save_offline(str(path), program, meta)
                    arts[quant], paths[quant] = artifact_lib.load(str(path), "cpu"), path
                else:
                    arts[quant] = artifact_lib.OfflineArtifact(program, meta)
            else:
                program, init = export_lib.export_streaming(exporting, StftConfig(**STFT, center=False), BATCH, "cpu")
                if quant == "int8":
                    artifact_lib.save_streaming(str(path), program, init, meta)
                    arts[quant], paths[quant] = artifact_lib.load(str(path), "cpu"), path
                else:
                    arts[quant] = artifact_lib.StreamingArtifact(program, list(pytree.tree_leaves(init)), meta)
        made[name] = dict(jax_model=jax_model, variables=variables, model=model, state=state, report=report,
                          icfg=icfg, arts=arts, paths=paths)
    return made


def _jax_variables(f, quant):
    return jq.quantize_variables(f["variables"], min_size=INT8_MIN_SIZE) if quant else f["variables"]


def test_programs_call_the_gru_op_once_a_layer(exported):
    """Each program holds one ``gru_sequence`` op a GRU layer (the full
    band's and the sub band's) and no other kernel op."""
    for name, f in exported.items():
        for quant, art in f["arts"].items():
            ops = [str(n.target) for n in art.program.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("cruse_tpu_torch.")]
            assert ops == ["cruse_tpu_torch.gru_sequence.default"] * 2, (name, quant, ops)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_offline_artifact_matches_jax_and_eager(exported, rng, quant):
    f = exported["offline"]
    art = f["arts"][quant]
    assert art.kind == "offline" and art.input_shape == (BATCH, SAMPLES)
    wav = noisy_batch(rng, BATCH, SAMPLES)
    got = art.enhance(torch.from_numpy(wav)).numpy()
    eager_model = _copy(f["model"], f["state"] if quant else None, dequantized=True)
    auto = BatchInferencer(eager_model, InferencerConfig(type="auto", stft=StftConfig(**STFT)), "cpu")
    assert np.abs(got - auto.auto(torch.from_numpy(wav)).numpy()).max() < EAGER_TOL
    complex_mask = BatchInferencer(eager_model, f["icfg"], "cpu").complex_mask(torch.from_numpy(wav)).numpy()
    assert np.abs(got - complex_mask).max() < JAX_TOL
    jcfg = JaxInferencerConfig(type="auto", stft=JaxStftConfig(**STFT))
    ref = np.asarray(JaxBatchInferencer(f["jax_model"], _jax_variables(f, quant), jcfg).auto(jnp.asarray(wav)))
    assert np.abs(got - ref).max() < JAX_TOL


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_streaming_artifact_matches_jax_and_eager(exported, rng, quant):
    """HOPS hops against the eager step and JAX's, then the carried state
    against eager's leaf for leaf: the GRU states (the sub band's at B·F
    rows) and the norms' sums within 1e-6, their float32 counts exactly."""
    f = exported["streamed"]
    art = f["arts"][quant]
    assert art.kind == "streaming" and art.hop_shape == (BATCH, 64)
    cfg = dict(STFT, center=False)
    enh = StreamingEnhancer(_copy(f["model"], f["state"] if quant else None, dequantized=True), StftConfig(**cfg))
    jax_enh = JaxStreamingEnhancer(f["jax_model"], _jax_variables(f, quant), JaxStftConfig(**cfg))
    state, e_state, j_state = art.init_state(), enh.init_state(BATCH), jax_enh.init_state(BATCH)
    for _ in range(HOPS):
        hop = noisy_batch(rng, BATCH, 64)
        out, state = art.step(state, torch.from_numpy(hop))
        e_out, e_state = enh.step(e_state, torch.from_numpy(hop))
        j_out, j_state = jax_enh.step(j_state, jnp.asarray(hop))
        assert np.abs(out.numpy() - e_out.numpy()).max() < EAGER_TOL
        assert np.abs(out.numpy() - np.asarray(j_out)).max() < JAX_TOL
    leaves = pytree.tree_leaves(e_state.model_state)
    assert len(state.model_state) == len(leaves) == 6
    for got, want in zip(state.model_state, leaves):
        assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
        assert (got - want).abs().max() < EAGER_TOL
    counts = [t for t in state.model_state if t.dim() == 1]
    # entries a frame: F bins; a unit's 2n + 1 taps and the full band's output
    assert [float(c.max()) for c in counts[1::2]] == [HOPS * 65.0, HOPS * 6.0]
    for got, want in zip(counts, [t for t in leaves if t.dim() == 1]):
        assert torch.equal(got, want)


def test_int8_artifacts_hold_int8_bytes(exported):
    def parameter_bytes(program):
        return sum(t.numel() * t.element_size() for t in program.state_dict.values())

    for name, f in exported.items():
        fp32, int8 = (f["arts"][q].program for q in (None, "int8"))
        assert any(t.dtype == torch.int8 for t in int8.state_dict.values()), name
        assert parameter_bytes(int8) < 0.6 * parameter_bytes(fp32), name
        assert f["report"]["leaves_quantized"] >= 4, name  # both GRUs' w_ih and w_hh at least


def test_export_then_eager_in_a_fresh_process(exported, rng, tmp_path):
    """A fresh process whose first sub-band unfold runs inside ``torch.export``
    (offline and streamed) then enhances eagerly: the same bits as this
    process's eager call, so no traced tensor was left in the unfold's
    cache."""
    f = exported["streamed"]
    wav = noisy_batch(rng, BATCH, SAMPLES)
    np.save(tmp_path / "wav.npy", wav)
    torch.save(f["model"].state_dict(), tmp_path / "weights.pt")
    eager = BatchInferencer(f["model"], f["icfg"], "cpu").complex_mask(torch.from_numpy(wav)).numpy()
    np.save(tmp_path / "eager.npy", eager)
    code = (
        "import numpy as np, torch\n"
        "from cruse_tpu_torch.dsp.stft import StftConfig\n"
        "from cruse_tpu_torch.infer import export\n"
        "from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig\n"
        "from cruse_tpu_torch.models import FullSubNet, FullSubNetConfig\n"
        "from cruse_tpu_torch.nn import subband\n"
        f"model = FullSubNet(FullSubNetConfig(**{NETS['streamed']!r})).eval()\n"
        f"model.load_state_dict(torch.load({str(tmp_path / 'weights.pt')!r}))\n"
        "icfg = InferencerConfig(type='complex_mask', stft=StftConfig(n_fft=128, hop_length=64))\n"
        "export.export_offline(model, icfg, 2, 4000, 'cpu')\n"
        "export.export_streaming(model, StftConfig(n_fft=128, hop_length=64, center=False), 2, 'cpu')\n"
        "assert subband._index_tensor.cache_info().currsize == 0, 'a trace wrote the eager cache'\n"
        f"wav = torch.from_numpy(np.load({str(tmp_path / 'wav.npy')!r}))\n"
        "out = BatchInferencer(model, icfg, 'cpu').complex_mask(wav).numpy()\n"
        f"np.testing.assert_array_equal(out, np.load({str(tmp_path / 'eager.npy')!r}))\n"
        "print('EAGER_OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "EAGER_OK" in res.stdout


@pytest.mark.parametrize("kind", ["offline", "streamed"])
def test_run_exported_on_fullsubnet_artifacts(exported, rng, tmp_path, capsys, kind):
    """run_exported (its ``main``) on the saved float32 offline and int8
    streamed containers: each wav as the artifact enhances or streams it
    here (offline: zero-padded to the [2, 4000] window; streamed: primed
    with the first n_fft - hop samples)."""
    f = exported[kind]
    quant = None if kind == "offline" else "int8"
    art = f["arts"][quant]
    lengths = {"a": 2000, "b": 3999}
    (tmp_path / "in").mkdir()
    for name, n in lengths.items():
        write_wav(str(tmp_path / "in" / f"{name}.wav"), noisy_batch(rng, 1, n)[0], 16000)
    run_exported_main(["-A", str(f["paths"][quant]), "-I", str(tmp_path / "in"), "-O", str(tmp_path / "out"),
                       "--device", "cpu"])
    assert ("enhanced 2 files" if kind == "offline" else "streamed 2 files") in capsys.readouterr().out
    wavs = [read_wav(str(tmp_path / "in" / f"{n}.wav"))[0] for n in lengths]
    if kind == "offline":
        x = np.zeros((BATCH, SAMPLES), np.float32)
        for i, w in enumerate(wavs):
            x[i, : w.shape[-1]] = w
        want = art.enhance(torch.from_numpy(x)).numpy()
    else:
        n_hops = -(-(max(lengths.values()) - 64) // 64)
        feed = np.zeros((BATCH, 64 + n_hops * 64), np.float32)
        for i, w in enumerate(wavs):
            feed[i, : w.shape[-1]] = w
        feed = torch.from_numpy(feed)
        state, outs = art.prime(art.init_state(), feed[:, :64]), []
        for h in range(n_hops):
            out, state = art.step(state, feed[:, 64 * (h + 1) : 64 * (h + 2)])
            outs.append(out)
        want = torch.cat(outs, -1).numpy()
    for i, (name, n) in enumerate(lengths.items()):
        got = read_wav(str(tmp_path / "out" / f"{name}.wav"))[0]
        np.testing.assert_array_equal(got, to_int16_scaled(want[i, :n]).astype(np.float32) / 32768.0)
