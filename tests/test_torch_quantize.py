"""Port parity: cruse_tpu_torch's weight-only int8 (``nn/quantize.py``, the
bridge's int8 leaves, ``--quantize int8`` of both CLIs) against cruse_tpu's
``nn/quantize.py``, on the CPU.

Tolerances: codes and scales equal bit for bit, the quantization report
equal, and the port's dequantized state dict equal to the bridge of the JAX
package's ``dequantize_tree`` (max-abs 0), for CRUSE, CRUSE+DF, DFSMN and
MTFAA trees, also with ``min_size`` low enough that every conv, transposed
conv and Dense layout carries int8; int8 enhanced waveforms within 1e-4
max-abs of the JAX package's int8 outputs (the BASELINE contract); against
float32, the JAX tests' own bounds (``tests/test_quantize.py``): mask SNR >
30 dB, waveform SNR > 25 dB.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig
from cruse_tpu.infer.streaming import StreamingEnhancer as JaxStreamingEnhancer
from cruse_tpu.nn import quantize as jq

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer.__main__ import main as infer_main
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.serve import build_model
from cruse_tpu_torch.infer.serve import main as serve_main
from cruse_tpu_torch.infer.server import StreamingServer
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.nn import quantize as tq
from cruse_tpu_torch.utils.weights import (
    flatten_tree, flax_from_state_dict, save_flax_npz, state_dict_from_flax)
from tests.test_torch_cruse import SMALL as SMALL_CRUSE
from tests.test_torch_cruse import make_pair, noisy_batch
from tests.test_torch_cruse_df import SMALL, SMALL_TRUNK, make_df_pair
from tests.test_torch_dfsmn import SMALL as SMALL_DFSMN
from tests.test_torch_dfsmn import make_dfsmn_pair
from tests.test_torch_mtfaa import TINY_WINDOWED, make_mtfaa_pair
from tests.test_torch_streaming import ROOT

FAMILIES = ("cruse", "cruse_df", "dfsmn", "mtfaa")
JAX_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops in one thread (module fixtures included): the suite
    runs several workers at once, and tiny ops on many threads each only wait
    for the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pairs():
    """Each family's (JAX model, variables, port model), made once."""
    made = {}

    def get(family):
        if family not in made:
            rng = np.random.default_rng(7)
            made[family] = {"cruse": lambda: make_pair(SMALL_CRUSE, rng),
                            "cruse_df": lambda: make_df_pair(rng, SMALL_TRUNK, SMALL),
                            "dfsmn": lambda: make_dfsmn_pair(rng, SMALL_DFSMN),
                            "mtfaa": lambda: make_mtfaa_pair(rng, TINY_WINDOWED)}[family]()
        return made[family]

    return get


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _snr_db(ref, test):
    ref, test = np.asarray(ref, np.float64), np.asarray(test, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - test) ** 2), 1e-300))


def _int8_copy(model, variables=None):
    """A copy of ``model`` with int8 weights loaded dequantized."""
    copy = type(model)(model.config).eval()
    copy.load_state_dict(model.state_dict())
    tq.load_int8_for_serving(copy, variables)
    return copy


@pytest.mark.parametrize("min_size", [tq.DEFAULT_MIN_SIZE, 64])
@pytest.mark.parametrize("family", FAMILIES)
def test_codes_scales_and_report_equal_jax(pairs, family, min_size):
    _, variables, _ = pairs(family)
    ref = _np_tree(jq.quantize_variables(variables, min_size=min_size))
    ours = tq.quantize_variables(variables, min_size=min_size)
    flat_ref, flat_ours = flatten_tree(ref), flatten_tree(ours)
    assert flat_ref.keys() == flat_ours.keys()
    assert any(k.endswith(tq.Q_KEY) for k in flat_ours)
    for key, want in flat_ref.items():
        got = flat_ours[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert tq.quantization_report(ours["params"]) == jq.quantization_report(ref["params"])


@pytest.mark.parametrize("min_size", [tq.DEFAULT_MIN_SIZE, 64])
@pytest.mark.parametrize("family", FAMILIES)
def test_dequantized_state_dict_is_the_bridge_of_jax_dequantize(pairs, family, min_size):
    """Codes and scales cross the bridge in the leaf's layout (conv regrouping,
    transposed-conv flip, Dense transpose): multiplied out they are the
    bridge of the JAX package's dequantized tree, bit for bit; the seeded
    path (the model's own weights mapped back to flax) gives the same
    entries as the bridged one."""
    _, variables, model = pairs(family)
    state, report = tq.int8_state_dict(model, variables, min_size=min_size)
    assert report["leaves_quantized"] == sum(tq.is_quantized_leaf(v) for v in state.values()) > 0
    for key, leaf in state.items():
        if tq.is_quantized_leaf(leaf):
            assert leaf[tq.Q_KEY].dtype == torch.int8 and leaf[tq.Q_KEY].shape == model.state_dict()[key].shape
            assert sum(n > 1 for n in leaf[tq.SCALE_KEY].shape) <= 1, key  # one channel axis
    want = state_dict_from_flax(_np_tree(jq.dequantize_tree(jq.quantize_variables(variables, min_size=min_size))),
                                model)
    got = tq.dequantize_state_dict(state)
    assert got.keys() == want.keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)
    seeded, _ = tq.int8_state_dict(model, min_size=min_size)
    for key, leaf in state.items():
        for a, b in ((leaf[tq.Q_KEY], seeded[key][tq.Q_KEY]), (leaf[tq.SCALE_KEY], seeded[key][tq.SCALE_KEY])) \
                if tq.is_quantized_leaf(leaf) else ((leaf, seeded[key]),):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("family", FAMILIES)
def test_flax_from_state_dict_inverts_the_bridge(pairs, family):
    _, variables, model = pairs(family)
    want, got = flatten_tree(variables), flatten_tree(flax_from_state_dict(model))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_numpy_rules_match_jax_tests(rng):
    """tests/test_quantize.py's unit rules on the port's numpy copy."""
    w = rng.standard_normal((64, 96)).astype(np.float32)
    q = tq.quantize_tree({"kernel": w}, min_size=1024)["kernel"]
    assert tq.is_quantized_leaf(q) and q[tq.Q_KEY].dtype == np.int8
    assert (np.abs(tq.dequantize_tree(q) - w) <= np.abs(w).max(axis=0, keepdims=True) / 254.0 + 1e-7).all()
    tree = {"bias": rng.standard_normal(4096).astype(np.float32), "tiny": rng.standard_normal((8, 8)).astype(np.float32),
            "big": rng.standard_normal((64, 64)).astype(np.float32), "step": np.int32(7)}
    out = tq.quantize_tree(tree, min_size=2048)
    assert out["bias"] is tree["bias"] and out["tiny"] is tree["tiny"] and out["step"] is tree["step"]
    assert tq.quantize_tree(out, min_size=2048)["big"][tq.Q_KEY] is out["big"][tq.Q_KEY]  # idempotent
    assert tq.dequantize_tree(tree)["tiny"] is tree["tiny"]
    rep = tq.quantization_report(tq.quantize_tree({"w": rng.standard_normal((128, 128)).astype(np.float32),
                                                   "b": rng.standard_normal(128).astype(np.float32)}, min_size=1024))
    assert rep["leaves_quantized"] == 1 and rep["leaves_kept"] == 1
    assert rep["bytes_quantized"] < 0.35 * rep["bytes_fp32"]


def test_attach_int8_keeps_codes_and_matches_dequantized(pairs, rng):
    """The export path's module: int8 codes and float32 scales as its state,
    the same outputs as the weights loaded dequantized."""
    _, variables, model = pairs("cruse_df")
    state, _ = tq.int8_state_dict(model, variables, min_size=64)
    held = type(model)(model.config).eval()
    tq.attach_int8(held, state)
    eager = type(model)(model.config).eval()
    tq.load_dequantized(eager, state)
    dtypes = {v.dtype for k, v in held.state_dict().items() if "parametrizations" in k}
    assert dtypes == {torch.int8, torch.float32}
    assert not any(v.dtype == torch.float32 and "original0" in k for k, v in held.state_dict().items())
    feat = torch.from_numpy(np.abs(rng.standard_normal((2, 12, 161))).astype(np.float32))
    with torch.no_grad():
        (m1, c1), _ = held(feat)
        (m2, c2), _ = eager(feat)
    torch.testing.assert_close(m1, m2, rtol=0, atol=0)
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)


def test_int8_outputs_match_jax_int8_and_bound_fp32(pairs, rng, tmp_path):
    """Int8 mag_to_mag (CRUSE), auto (CRUSE+DF) and streaming (CRUSE+DF)
    against the JAX package run on its own int8 variables (1e-4 max-abs), and
    against float32 (the JAX tests' bounds)."""
    wav = noisy_batch(rng, 2, 4800)
    stft_cfg = dict(n_fft=320, hop_length=160)
    for family, strategy in (("cruse", "mag_to_mag"), ("cruse_df", "auto")):
        jax_model, variables, model = pairs(family)
        qvars = jq.quantize_variables(variables)
        jcfg = JaxInferencerConfig(type=strategy, stft=JaxStftConfig(**stft_cfg), output_dir=str(tmp_path))
        ref_q = np.asarray(getattr(JaxBatchInferencer(jax_model, qvars, jcfg), strategy)(jnp.asarray(wav)))
        icfg = InferencerConfig(type=strategy, stft=StftConfig(**stft_cfg), output_dir=str(tmp_path))
        fp = getattr(BatchInferencer(model, icfg, "cpu"), strategy)(torch.from_numpy(wav)).numpy()
        q = getattr(BatchInferencer(_int8_copy(model, variables), icfg, "cpu"), strategy)(torch.from_numpy(wav)).numpy()
        assert np.abs(q - ref_q).max() < JAX_TOL, family
        assert _snr_db(fp, q) > 25.0, family
    jax_model, variables, model = pairs("cruse_df")
    qvars = jq.quantize_variables(variables)
    scfg = dict(stft_cfg, center=False)
    ref_q = np.asarray(JaxStreamingEnhancer(jax_model, qvars, JaxStftConfig(**scfg)).run(jnp.asarray(wav)))
    fp = StreamingEnhancer(model, StftConfig(**scfg)).run(torch.from_numpy(wav)).numpy()
    q = StreamingEnhancer(_int8_copy(model, variables), StftConfig(**scfg)).run(torch.from_numpy(wav)).numpy()
    assert np.abs(q - ref_q).max() < JAX_TOL
    assert _snr_db(fp, q) > 25.0
    # the mask bound (tests/test_quantize.py): int8 moves the mask by < -30 dB
    jax_model, variables, model = pairs("cruse")
    feat = np.abs(rng.standard_normal((2, 16, 161))).astype(np.float32)
    with torch.no_grad():
        mask_fp, _ = model(torch.from_numpy(feat))
        mask_q, _ = _int8_copy(model, variables)(torch.from_numpy(feat))
    assert np.isfinite(mask_q.numpy()).all() and _snr_db(mask_fp.numpy(), mask_q.numpy()) > 30.0


def test_cli_quantize_int8(pairs, rng, tmp_path):
    """``--quantize int8`` in the infer CLI (bridged weights) and the serve
    CLI (seeded weights): each wav is the same run on the weights quantized
    and loaded dequantized in the test."""
    _, variables, model = pairs("cruse")  # configs/tiny_cruse.toml's model
    save_flax_npz(variables, str(tmp_path / "w.npz"))
    (tmp_path / "in").mkdir()
    wav = noisy_batch(rng, 1, 4000)[0]
    write_wav(str(tmp_path / "in" / "utt.wav"), wav, 16000)
    x = torch.from_numpy(read_wav(str(tmp_path / "in" / "utt.wav"), sr=16000)[0][None])
    config = str(ROOT / "configs/tiny_cruse.toml")
    infer_main(["-C", config, "-I", str(tmp_path / "in"), "-O", str(tmp_path / "infer"),
                "--weights", str(tmp_path / "w.npz"), "--quantize", "int8", "--device", "cpu"])
    icfg = InferencerConfig(type="mag_to_mag", stft=StftConfig(n_fft=320, hop_length=160))
    want = BatchInferencer(_int8_copy(model, variables), icfg, "cpu").mag_to_mag(x)[0].numpy()
    got = read_wav(str(tmp_path / "infer" / "utt.wav"), sr=16000)[0]
    np.testing.assert_array_equal(got, to_int16_scaled(want).astype(np.float32) / 32768.0)

    serve_main(["-M", f"m={config}", "-I", str(tmp_path / "in"), "-O", str(tmp_path / "serve"),
                "--quantize", "int8", "--max_streams", "2", "--seed", "3", "--device", "cpu"])
    seeded, cfg, _ = build_model(config, None, 3, "int8")
    n = x.shape[-1]
    padded = np.pad(x[0].numpy(), (0, (-n) % cfg.hop_length))
    want = to_int16_scaled(StreamingServer(seeded, cfg, 1, device="cpu").run_session(padded)[:n])
    got = read_wav(str(tmp_path / "serve" / "utt.wav"), sr=16000)[0]
    assert got.shape == (n,)
    assert np.abs(np.round(got * 32768.0) - want.astype(np.float64)).max() / 32768.0 <= 1e-4  # as test_torch_server
