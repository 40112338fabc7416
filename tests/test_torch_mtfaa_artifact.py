"""Port parity: MTFAA's deployment artifacts (``infer/export.py`` on an
``MtfaaNet``, ``infer/artifact.py``, ``infer/run_exported.py``) and the three
kernel ops they trace (``torch.ops.cruse_tpu_torch.tfcm_eval``,
``tattn_fwd``, ``dw_fwd``), on the CPU, against cruse_tpu and against the
port's eager path.

Nets: ``TINY_WINDOWED`` (config 5b's form: windowed attention, deep filter)
offline and streamed, and ``TINY`` (config 5's form: full-causal attention)
offline, each in float32 and int8. The int8 rule runs with a threshold of 64
elements, so that the TFCM blocks' 1x1 kernels are int8 as config 5b's stage
of 48 channels is at the default threshold, and the program folds them after
its dequantize.

Tolerances: an artifact within 1e-6 of the port's eager path on the same
weights (int8: loaded dequantized), and within 1e-4 max-abs of the JAX
package's ``auto`` / ``StreamingEnhancer`` on the same bridged weights (int8:
the JAX rule's variables, which the JAX package dequantizes); the int8
artifact's parameter bytes under 0.6x the float32 artifact's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.utils._pytree as pytree

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer
from cruse_tpu.models import mtfaa as jm
from cruse_tpu.nn import quantize as jq

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer import artifact as artifact_lib
from cruse_tpu_torch.infer import export as export_lib
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.run_exported import main as run_exported_main
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import MtfaaConfig, MtfaaNet
from cruse_tpu_torch.nn import quantize as tq
from cruse_tpu_torch.ops.tfcm_kernel import params_per_layer
from cruse_tpu_torch.utils.config import load_config
from cruse_tpu_torch.utils.weights import flax_from_state_dict, state_dict_from_flax
from tests.test_torch_artifact import one_torch_thread  # noqa: F401  (autouse, module scope)
from tests.test_torch_cruse import noisy_batch
from tests.test_torch_mtfaa import TINY, TINY_WINDOWED
from tests.test_torch_streaming import ROOT
from tests.test_torch_tfcm import perturbed

JAX_TOL, EAGER_TOL = 1e-4, 1e-6
STFT = dict(n_fft=512, hop_length=256)
BATCH, SAMPLES, HOPS = 2, 4000, 8
INT8_MIN_SIZE = 64
NETS = {"windowed": TINY_WINDOWED, "causal": TINY}


def _copy(model, state=None, dequantized=False):
    """A copy of ``model``: float32, with ``state``'s int8 leaves kept in it
    (export), or loaded dequantized (eager)."""
    copy = MtfaaNet(model.config).eval()
    copy.load_state_dict(model.state_dict())
    if state is not None:
        (tq.load_dequantized if dequantized else tq.attach_int8)(copy, state)
    return copy


def _pair(rng, args: dict):
    """The port's MtfaaNet with seeded weights and perturbed BatchNorm
    statistics and PReLU slopes, the cruse_tpu variables the bridge maps onto
    it, and the cruse_tpu MtfaaNet (as ``make_mtfaa_pair``, without a flax
    init)."""
    model = MtfaaNet(MtfaaConfig(**args), generator=torch.Generator().manual_seed(5)).eval()
    variables = perturbed(flax_from_state_dict(model), rng)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return jm.MtfaaNet(jm.MtfaaConfig(**args)), variables, model


def _int8_variables(variables):
    return jq.quantize_variables(variables, min_size=INT8_MIN_SIZE)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Both nets exported offline (float32 and int8), the windowed one also
    streamed (float32 and int8), each once. The windowed net's float32
    offline program and int8 stream go through a saved container and
    ``artifact.load``; the others are wrapped as loaded, from memory."""
    rng = np.random.default_rng(21)
    out = tmp_path_factory.mktemp("mtfaa_artifacts")
    icfg = InferencerConfig(type="auto", stft=StftConfig(**STFT))
    saved = {("windowed", None, "offline"), ("windowed", "int8", "stream")}
    made = {}
    for name, args in NETS.items():
        jax_model, variables, model = _pair(rng, args)
        state, _ = tq.int8_state_dict(model, variables, min_size=INT8_MIN_SIZE)
        wav = torch.from_numpy(noisy_batch(rng, 1, 2048))
        before = BatchInferencer(model, icfg, "cpu").auto(wav)  # the float32 programs trace ``model`` itself
        offline, stream, offline_path = {}, {}, None
        for quant in (None, "int8"):
            meta = {"device": "cpu", "quantized": quant, "n_fft": 512, "hop_length": 256}
            exporting = _copy(model, state) if quant else model
            program = export_lib.export_offline(exporting, icfg, BATCH, SAMPLES, "cpu")
            path = str(out / f"{name}_{quant}.zip")
            if (name, quant, "offline") in saved:
                artifact_lib.save_offline(path, program, meta)
                offline[quant] = artifact_lib.load(path, "cpu")
                offline_path = path
            else:
                offline[quant] = artifact_lib.OfflineArtifact(program, meta)
            if args.get("attention_window") is None:
                continue
            program, init = export_lib.export_streaming(exporting, StftConfig(**STFT, center=False), BATCH, "cpu")
            path = str(out / f"{name}_{quant}_stream.zip")
            if (name, quant, "stream") in saved:
                artifact_lib.save_streaming(path, program, init, meta)
                art = artifact_lib.load(path, "cpu")
            else:
                art = artifact_lib.StreamingArtifact(program, list(pytree.tree_leaves(init)), meta)
            stream[quant] = dict(artifact=art, path=path)
        made[name] = dict(jax_model=jax_model, variables=variables, model=model, state=state, icfg=icfg,
                          offline=offline, offline_path=offline_path, stream=stream, eager_before=(wav, before))
    return made


def test_opcheck_mtfaa_ops():
    g = torch.Generator().manual_seed(0)
    c = 8
    x = torch.randn(2, 5, c, 9, generator=g)
    params = torch.randn(2, params_per_layer(c), generator=g) * 0.3
    for args in ((x, params, [1, 2], None, None, False), (x, params[:1], [4], None, None, True),
                 (x, params, [1, 2], 32, 4, False)):
        torch.library.opcheck(torch.ops.cruse_tpu_torch.tfcm_eval.default, args)
    q, k = torch.randn(6, 2, 11, generator=g), torch.randn(6, 2, 11, generator=g)
    v = torch.randn(6, 8, 11, generator=g)
    for window, causal in ((None, True), (4, True), (None, False)):
        torch.library.opcheck(torch.ops.cruse_tpu_torch.tattn_fwd.default, (q, k, v, window, causal))
    x_ext, wd = torch.randn(2, 5, c, 13, generator=g), torch.randn(3, 3, c, generator=g)
    for d in (1, 2):
        torch.library.opcheck(torch.ops.cruse_tpu_torch.dw_fwd.default, (x_ext[..., : 9 + 2 * d], wd, d))


def test_programs_call_the_ops(exported):
    """The offline programs hold a TFCM stack op a stack (six), an attention
    op a stage (three) and the deep filter; the stream holds a stencil op a
    TFCM block (twelve) and the deep filter, and no fold in float32."""
    def ops(program):
        found = {}
        for node in program.graph.nodes:
            if node.op == "call_function" and str(node.target).startswith("cruse_tpu_torch."):
                found[str(node.target).split(".")[1]] = found.get(str(node.target).split(".")[1], 0) + 1
        return found

    assert ops(exported["windowed"]["offline"][None].program) == {"tfcm_eval": 6, "tattn_fwd": 3, "deep_filter": 1}
    assert ops(exported["causal"]["offline"]["int8"].program) == {"tfcm_eval": 6, "tattn_fwd": 3}
    for quant in (None, "int8"):
        assert ops(exported["windowed"]["stream"][quant]["artifact"].program) == {"dw_fwd": 12, "deep_filter": 1}

    def folds(program):  # the BatchNorm fold's rsqrt, beyond the 6 stage BatchNorms' own
        return sum(1 for n in program.graph.nodes if n.op == "call_function" and "rsqrt" in str(n.target)) - 6

    assert folds(exported["windowed"]["offline"][None].program) == 0
    assert folds(exported["windowed"]["stream"][None]["artifact"].program) == 0
    assert folds(exported["windowed"]["offline"]["int8"].program) > 0  # int8 leaves fold after the dequantize


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", list(NETS))
def test_offline_artifact_matches_jax_and_eager(exported, rng, name, quant):
    f = exported[name]
    art = f["offline"][quant]
    assert art.kind == "offline" and art.input_shape == (BATCH, SAMPLES)
    wav = noisy_batch(rng, BATCH, SAMPLES)
    got = art.enhance(torch.from_numpy(wav)).numpy()
    eager = BatchInferencer(_copy(f["model"], f["state"] if quant else None, dequantized=True), f["icfg"], "cpu")
    assert np.abs(got - eager.auto(torch.from_numpy(wav)).numpy()).max() < EAGER_TOL
    variables = _int8_variables(f["variables"]) if quant else f["variables"]
    jcfg = JaxInferencerConfig(type="auto", stft=JaxStftConfig(**STFT))
    ref = np.asarray(JaxBatchInferencer(f["jax_model"], variables, jcfg).auto(jnp.asarray(wav)))
    assert np.abs(got - ref).max() < JAX_TOL


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_streaming_artifact_matches_jax_and_eager(exported, rng, quant):
    f = exported["windowed"]
    art = f["stream"][quant]["artifact"]
    assert art.kind == "streaming" and art.hop_shape == (BATCH, 256)
    state = art.init_state()
    assert all(torch.is_tensor(t) for t in state.model_state)
    assert any(t.dtype == torch.int32 for t in state.model_state)  # the attention caches' counts
    cfg = dict(STFT, center=False)
    enh = StreamingEnhancer(_copy(f["model"], f["state"] if quant else None, dequantized=True), StftConfig(**cfg))
    variables = _int8_variables(f["variables"]) if quant else f["variables"]
    jax_enh = JaxStreamingEnhancer(f["jax_model"], variables, JaxStftConfig(**cfg))
    e_state, j_state = enh.init_state(BATCH), jax_enh.init_state(BATCH)
    for _ in range(HOPS):
        hop = noisy_batch(rng, BATCH, 256)
        out, state = art.step(state, torch.from_numpy(hop))
        e_out, e_state = enh.step(e_state, torch.from_numpy(hop))
        j_out, j_state = jax_enh.step(j_state, jnp.asarray(hop))
        assert np.abs(out.numpy() - e_out.numpy()).max() < EAGER_TOL
        assert np.abs(out.numpy() - np.asarray(j_out)).max() < JAX_TOL


def test_int8_artifacts_hold_int8_bytes(exported):
    def parameter_bytes(program):
        return sum(t.numel() * t.element_size() for t in program.state_dict.values())

    for name in NETS:
        fp32, int8 = (exported[name]["offline"][q].program for q in (None, "int8"))
        assert any(t.dtype == torch.int8 for t in int8.state_dict.values())
        assert parameter_bytes(int8) < 0.6 * parameter_bytes(fp32)
    stream = exported["windowed"]["stream"]["int8"]["artifact"].program
    assert any(t.dtype == torch.int8 for t in stream.state_dict.values())


def test_streaming_a_full_causal_mtfaa_raises():
    model = MtfaaNet(MtfaaConfig(**TINY)).eval()
    with pytest.raises(ValueError, match="finite attention_window"):
        export_lib.export_streaming(model, StftConfig(**STFT, center=False), 1, "cpu")


@pytest.mark.parametrize("name", list(NETS))
def test_eager_forward_unchanged_by_an_export(exported, name):
    """An export neither leaves its frozen folds on the model nor writes a
    traced tensor into the eager fold cache: the eager forward gives the same
    bits after the float32 exports of the fixture as before them, and after
    a statistic changes it folds the new one."""
    f = exported[name]
    model, (wav, before) = f["model"], f["eager_before"]
    assert not any("_frozen_fold" in vars(m) for m in model.modules())
    inferencer = BatchInferencer(model, f["icfg"], "cpu")
    torch.testing.assert_close(inferencer.auto(wav), before, rtol=0, atol=0)
    mean = model.enc_tfcm_0.block_0.bn1.mean
    kept = mean.clone()
    with torch.no_grad():
        mean.add_(0.5)
    try:
        assert (inferencer.auto(wav) - before).abs().max() > 1e-6
    finally:
        with torch.no_grad():
            mean.copy_(kept)
    torch.testing.assert_close(inferencer.auto(wav), before, rtol=0, atol=0)


def test_consumer_needs_no_model_code(exported):
    """A fresh process with jax, cruse_tpu and cruse_tpu_torch.models blocked
    loads the windowed MTFAA's int8 stream and its offline program through
    artifact.py alone and runs them."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'cruse_tpu') or name.startswith('cruse_tpu_torch.models'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from cruse_tpu_torch.infer import artifact\n"
        f"art = artifact.load({exported['windowed']['stream']['int8']['path']!r}, 'cpu')\n"
        "state = art.prime(art.init_state(), torch.zeros(2, 256))\n"
        "for _ in range(3):\n"
        "    out, state = art.step(state, torch.randn(2, 256) * 0.1)\n"
        "assert out.shape == (2, 256) and torch.isfinite(out).all()\n"
        "for name in ('cruse_tpu_torch.models', 'cruse_tpu_torch.infer.streaming', 'cruse_tpu_torch.utils.config'):\n"
        "    assert name not in sys.modules, name\n"
        "print('CONSUMER_OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "CONSUMER_OK" in res.stdout


def test_run_exported_on_an_offline_mtfaa_artifact(exported, rng, tmp_path, capsys):
    """run_exported (its ``main``) on the windowed net's saved float32
    offline artifact: each wav zero-padded to the exported [2, 4000] window,
    enhanced in groups of two, trimmed, as the artifact enhances it here."""
    art = exported["windowed"]["offline"][None]
    lengths = {"a": 2000, "b": 3999, "c": 4000}
    wavs = {}
    for name, n in lengths.items():
        write_wav(str(tmp_path / "in" / f"{name}.wav"), noisy_batch(rng, 1, n)[0], 16000)
        wavs[name] = read_wav(str(tmp_path / "in" / f"{name}.wav"))[0]
    run_exported_main(["-A", exported["windowed"]["offline_path"], "-I", str(tmp_path / "in"),
                       "-O", str(tmp_path / "out"), "--device", "cpu"])
    assert "enhanced 1 files" in capsys.readouterr().out
    for group in (["a", "b"], ["c"]):
        x = np.zeros((BATCH, SAMPLES), np.float32)
        for i, name in enumerate(group):
            x[i, : lengths[name]] = wavs[name]
        want = art.enhance(torch.from_numpy(x)).numpy()
        for i, name in enumerate(group):
            got = read_wav(str(tmp_path / "out" / f"{name}.wav"))[0]
            np.testing.assert_array_equal(got, to_int16_scaled(want[i, : lengths[name]]).astype(np.float32) / 32768.0)


def test_export_streaming_then_run_exported_clis(rng, tmp_path, capsys):
    """Both CLIs (their ``main``, in this process) on the CPU:
    configs/demo_mtfaa_windowed.toml with seeded weights exported
    --streaming in int8, and run_exported writes each wav as the artifact
    streams it in the test, which is the eager StreamingEnhancer on the same
    int8 weights loaded dequantized."""
    lengths = {"a": 3000, "b": 4321}
    (tmp_path / "in").mkdir()
    for name, n in lengths.items():
        write_wav(str(tmp_path / "in" / f"{name}.wav"), noisy_batch(rng, 1, n)[0], 16000)
    config = str(ROOT / "configs/demo_mtfaa_windowed.toml")
    export_lib.main(["-C", config, "-O", str(tmp_path / "s.zip"), "--seed", "3", "--batch", "2", "--streaming",
                     "--quantize", "int8", "--device", "cpu"])
    assert "reload check OK" in capsys.readouterr().out
    run_exported_main(["-A", str(tmp_path / "s.zip"), "-I", str(tmp_path / "in"), "-O", str(tmp_path / "out"),
                       "--device", "cpu"])
    assert "streamed 2 files" in capsys.readouterr().out
    stream = artifact_lib.load(str(tmp_path / "s.zip"), "cpu")
    assert stream.meta["quantized"] == "int8" and stream.meta["hop_length"] == 256
    wavs = {n: read_wav(str(tmp_path / "in" / f"{n}.wav"))[0] for n in lengths}
    n_hops = -(-(max(lengths.values()) - 256) // 256)  # the runner's ceil over the prime
    feed = np.zeros((2, 256 + n_hops * 256), np.float32)
    for i, n in enumerate(lengths):
        feed[i, : lengths[n]] = wavs[n]
    feed = torch.from_numpy(feed)
    model = export_lib.build(load_config(config), None, 3, None)
    tq.load_dequantized(model, tq.int8_state_dict(model)[0])
    enh = StreamingEnhancer(model, StftConfig(**STFT, center=False))
    state, e_state = stream.prime(stream.init_state(), feed[:, :256]), enh.prime(enh.init_state(2), feed[:, :256])
    outs, eager = [], []
    for h in range(n_hops):
        hop = feed[:, 256 * (h + 1) : 256 * (h + 2)]
        out, state = stream.step(state, hop)
        e_out, e_state = enh.step(e_state, hop)
        outs.append(out)
        eager.append(e_out)
    streamed = torch.cat(outs, dim=-1)
    assert (streamed - torch.cat(eager, dim=-1)).abs().max() < EAGER_TOL
    for i, n in enumerate(lengths):
        got = read_wav(str(tmp_path / "out" / f"{n}.wav"))[0]
        keep = min(lengths[n], n_hops * 256)
        np.testing.assert_array_equal(got, to_int16_scaled(streamed[i, :keep].numpy()).astype(np.float32) / 32768.0)
