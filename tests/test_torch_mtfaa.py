"""Port parity: cruse_tpu_torch's MTFAA (config 5 and its windowed variant
5b) and the offline ``auto`` path against cruse_tpu, on the CPU, with
weights carried across by the bridge.

BatchNorm statistics and PReLU slopes are perturbed on the JAX side, so a
bridge or a fold that ignored them fails. Tolerances: module outputs, the
mask and the enhanced spectrum at 1e-5 (float32 nets of the same layers);
the enhanced waveform at 1e-4 max-abs, the BASELINE contract.
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
from cruse_tpu.models import mtfaa as jm
from cruse_tpu.utils.config import load_config as jax_load_config

from cruse_tpu_torch.data.wavio import read_wav, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer.__main__ import main as cli_main
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import MtfaaConfig, MtfaaNet, build_from_config
from cruse_tpu_torch.models.mtfaa import Banks, BandDownConv, BandUpConv, PhaseEncoder
from cruse_tpu_torch.utils.config import load_config
from cruse_tpu_torch.utils.weights import (
    load_flax_npz, mtfaa_flax_from_named, save_flax_npz, state_dict_from_flax)
from tests.test_torch_cruse import noisy_batch
from tests.test_torch_tfcm import perturbed

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
TINY = dict(n_bands=64, channels=(8, 12, 16), tfcm_layers=2, use_deep_filter=False)  # tiny_mtfaa.toml
TINY_WINDOWED = dict(n_bands=64, channels=(8, 12, 16), tfcm_layers=2, attention_window=7)
DEMO = dict(n_bands=64, channels=(8, 12, 16), tfcm_layers=2, attention_window=62)  # demo_mtfaa_windowed
CONFIG_5B = dict(n_bands=128, channels=(24, 32, 48), tfcm_layers=4, attention_window=126)
STFT = dict(n_fft=512, hop_length=256)


def make_mtfaa_pair(rng, args: dict, seed: int = 0):
    """A cruse_tpu MtfaaNet with seeded variables, perturbed BatchNorm
    statistics and PReLU slopes, and the port's MtfaaNet carrying them."""
    jax_model = jm.MtfaaNet(jm.MtfaaConfig(**args))
    cspec = jnp.zeros((1, 4, jax_model.config.num_bins, 2), jnp.float32)
    variables = perturbed(jax_model.init(jax.random.PRNGKey(seed), cspec), rng)
    model = MtfaaNet(MtfaaConfig(**args)).eval()
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return jax_model, variables, model


def _module_pair(rng, jax_module, module, x):
    variables = perturbed(jax_module.init(jax.random.PRNGKey(0), *x), rng)
    module.load_state_dict(state_dict_from_flax(variables, MtfaaNet.__new__(MtfaaNet)), strict=True)
    return variables, module.eval()


def test_banks_match_jax(rng):
    jax_banks, banks = jm.Banks(128, 512, 16000), Banks(128, 512, 16000)
    np.testing.assert_array_equal(banks.filter.numpy(), np.asarray(jax_banks.filter))
    np.testing.assert_array_equal(banks.filter_inv.numpy(), np.asarray(jax_banks.filter_inv))
    amp = rng.standard_normal((2, 257, 3, 11)).astype(np.float32)
    bands = rng.standard_normal((2, 128, 11)).astype(np.float32)
    np.testing.assert_allclose(banks.amp2bank_tm(torch.from_numpy(amp)).numpy(),
                               np.asarray(jax_banks.amp2bank_tm(jnp.asarray(amp))), atol=1e-5)
    np.testing.assert_allclose(banks.bank2amp_tm(torch.from_numpy(bands)).numpy(),
                               np.asarray(jax_banks.bank2amp_tm(jnp.asarray(bands))), atol=1e-5)


def test_phase_encoder_matches_jax(rng):
    x = rng.standard_normal((2, 33, 2, 15)).astype(np.float32)
    jax_pe = jm.PhaseEncoder(cout=4)
    variables, pe = _module_pair(rng, jax_pe, PhaseEncoder(cout=4), ([jnp.asarray(x)],))
    ref, _ = jax_pe.apply(variables, [jnp.asarray(x)])
    np.testing.assert_allclose(pe(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("k_in,stride", [(16, 2), (9, 2), (10, 3)],
                         ids=["stride2_even_fast_path", "stride2_odd_K", "stride3_general"])
def test_band_down_conv_matches_jax(rng, k_in, stride):
    x = rng.standard_normal((2, k_in, 4, 13)).astype(np.float32)
    jax_conv = jm.BandDownConv(6, stride)
    variables, conv = _module_pair(rng, jax_conv, BandDownConv(4, 6, stride), (jnp.asarray(x),))
    ref, _ = jax_conv.apply(variables, jnp.asarray(x))
    got = conv(torch.from_numpy(x)).detach()
    assert got.shape[1] == (k_in - 1) // stride + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_band_up_conv_matches_jax(rng):
    x = rng.standard_normal((2, 8, 6, 13)).astype(np.float32)
    jax_conv = jm.BandUpConv(4)
    variables, conv = _module_pair(rng, jax_conv, BandUpConv(6, 4), (jnp.asarray(x),))
    ref, _ = jax_conv.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(conv(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("args", [TINY, TINY_WINDOWED, DEMO], ids=["tiny", "windowed_df", "demo_windowed"])
def test_mask_and_enhanced_match_jax(rng, args):
    jax_model, variables, model = make_mtfaa_pair(rng, args)
    cspec = (rng.standard_normal((2, 20, 257, 2)) * 0.3).astype(np.float32)
    (ref_enh, ref_mask), _ = jax_model.apply(variables, jnp.asarray(cspec))
    with torch.no_grad():
        (enhanced, mask), state = model(torch.from_numpy(cspec))
    assert (state is None) == ("attention_window" not in args)  # a windowed net returns its state
    assert enhanced.dtype == torch.complex64 and tuple(mask.shape) == (2, 20, 257)
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref_mask), atol=1e-5)
    np.testing.assert_allclose(enhanced.numpy(), np.asarray(ref_enh), atol=1e-5)


def _auto_pair(jax_model, variables, model, tmp_path):
    jax_inf = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
        type="auto", stft=JaxStftConfig(**STFT), output_dir=str(tmp_path / "jax")))
    inf = BatchInferencer(model, InferencerConfig(type="auto", stft=StftConfig(**STFT),
                                                  output_dir=str(tmp_path / "torch")), device="cpu")
    return jax_inf, inf


@pytest.mark.parametrize("width", ["tiny", "windowed_df", "config5b"])
def test_auto_waveform_matches_jax(rng, tmp_path, width):
    """noisy wav -> enhanced wav through BatchInferencer(type="auto") in both
    packages: at small widths (B=2, 0.5 s) and at config 5b's full width
    (configs/mtfaa_windowed.toml, B=1, 0.5 s)."""
    args = {"tiny": TINY, "windowed_df": TINY_WINDOWED, "config5b": CONFIG_5B}[width]
    noisy = noisy_batch(rng, 1 if width == "config5b" else 2, 8000)
    jax_inf, inf = _auto_pair(*make_mtfaa_pair(rng, args), tmp_path)
    ref = np.asarray(jax_inf._strategy(jnp.asarray(noisy)))
    ours = inf.auto(torch.from_numpy(noisy)).numpy()
    assert ours.shape == ref.shape == noisy.shape
    err = np.abs(ours - ref).max()
    assert err < 1e-4, f"enhanced waveform max-abs {err} >= 1e-4"


def test_auto_run_batched_matches_jax(rng, tmp_path):
    jax_inf, inf = _auto_pair(*make_mtfaa_pair(rng, TINY_WINDOWED), tmp_path)
    wavs = [noisy_batch(rng, 1, n)[0] for n in (4000, 6543, 9100)]
    names = ["a", "b", "c"]
    ref = jax_inf.run_batched(wavs, names, batch_size=2, write=False)
    ours = inf.run_batched(wavs, names, batch_size=2, write=False)
    for (name, a, _), (_, b, _) in zip(ours, ref):
        assert a.shape == b.shape
        assert np.abs(a.astype(np.float64) - b.astype(np.float64)).max() / 32768.0 <= 1e-4, name


@pytest.mark.parametrize("toml,args", [
    ("tiny_mtfaa.toml", TINY),
    ("demo_mtfaa_windowed.toml", DEMO),
    ("mtfaa_windowed.toml", CONFIG_5B),
])
def test_build_from_config(toml, args):
    config = load_config(str(CONFIGS / toml))
    assert config == jax_load_config(str(CONFIGS / toml))
    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(1))
    assert isinstance(model, MtfaaNet) and model.config == MtfaaConfig(**args)
    again = build_from_config(config["model"], generator=torch.Generator().manual_seed(1))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    BatchInferencer(model, InferencerConfig(type="auto"), device="cpu")


def test_bridge_npz_round_trip(rng, tmp_path):
    _, variables, model = make_mtfaa_pair(rng, TINY_WINDOWED)
    p, s = variables["params"], variables["batch_stats"]
    block = model.enc_tfcm_1.block_1
    np.testing.assert_array_equal(block.pconv1_kernel.detach().numpy(),
                                  p["enc_tfcm_1"]["block_1"]["pconv1_kernel"])
    np.testing.assert_array_equal(block.dw_kernel.detach().numpy(), p["enc_tfcm_1"]["block_1"]["dw_kernel"])
    np.testing.assert_array_equal(block.bn2.var.numpy(), s["enc_tfcm_1"]["block_1"]["bn2"]["var"])
    assert block.prelu1.negative_slope.dim() == 0
    np.testing.assert_array_equal(model.df_coef_kernel.detach().numpy(), p["df_coef_kernel"])
    path = tmp_path / "w.npz"
    save_flax_npz(variables, str(path))
    loaded = state_dict_from_flax(load_flax_npz(str(path)), model)
    assert loaded.keys() == model.state_dict().keys()
    for key, value in model.state_dict().items():
        torch.testing.assert_close(loaded[key], value, rtol=0, atol=0)


@pytest.mark.parametrize("route,jax_impl", [("fused_fold", "fused_pallas_interpret"),
                                            ("pallas", "pallas_interpret")])
def test_training_forward_matches_jax(rng, route, jax_impl):
    """train=True: the mask and the enhanced spectrum from batch statistics,
    and every BatchNorm's running statistics moved as the reference's, by
    both of the port's TFCM routes (the reference by the routes that reach
    its kernels, in interpret mode; its "fused_fold" takes BN1's statistics
    from a Gram matrix, another rounding, and is not the port's forward); eval
    afterwards uses the moved statistics. The training outputs are held to
    2e-4, not 1e-5: twelve BatchNorms in a row take float32 batch variances as
    E[x^2] - mean^2, and a float64 run of the port differs from each float32
    package by 6e-6 to 6e-5 at these shapes."""
    jax_model, variables, _ = make_mtfaa_pair(rng, dict(TINY_WINDOWED, tfcm_dw_impl=jax_impl))
    model = MtfaaNet(MtfaaConfig(**TINY_WINDOWED, tfcm_dw_impl=route))
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    cspec = (rng.standard_normal((2, 12, 257, 2)) * 0.3).astype(np.float32)
    ((ref_enh, ref_mask), _), updated = jax_model.apply(variables, jnp.asarray(cspec), None, True,
                                                        mutable=["batch_stats"])
    (enhanced, mask), state = model.train()(torch.from_numpy(cspec), train=True)
    assert enhanced.requires_grad  # the windowed net's state is cut from autograd
    assert not any(t.requires_grad for t in jax.tree_util.tree_leaves(state, is_leaf=torch.is_tensor))
    np.testing.assert_allclose(mask.detach().numpy(), np.asarray(ref_mask), atol=2e-4)
    np.testing.assert_allclose(enhanced.detach().numpy(), np.asarray(ref_enh), atol=2e-4)
    ours = mtfaa_flax_from_named(model.state_dict())["batch_stats"]
    leaves = jax.tree_util.tree_leaves_with_path(updated["batch_stats"])
    assert len(leaves) == 2 * (3 + 3 + 6 * 2 * 2)  # mean, var of 6 stage BNs and 2 per TFCM block
    for path, want in leaves:
        got = ours
        for part in path:
            got = got[part.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    with torch.no_grad():
        (after, _), _ = model.eval()(torch.from_numpy(cspec))
    (ref_after, _), _ = jax_model.apply({"params": variables["params"], **updated}, jnp.asarray(cspec))
    np.testing.assert_allclose(after.numpy(), np.asarray(ref_after), atol=2e-5)


def test_unported_paths_raise():
    model = MtfaaNet(MtfaaConfig(**TINY_WINDOWED)).eval()
    cspec = torch.zeros(1, 5, 257, 2)
    with pytest.raises(ValueError, match="eval mode"):  # train and the module's mode must agree
        model(cspec, train=True)
    with pytest.raises(ValueError, match="training mode"):
        model.train()(cspec)
    with pytest.raises(NotImplementedError, match="carried state"):  # no path trains through a state
        model.train()(cspec, state=model.init_state(1), train=True)
    model.eval()
    with pytest.raises(ValueError, match="init_state"):
        model(cspec, state={})
    causal = MtfaaNet(MtfaaConfig(**TINY)).eval()
    with pytest.raises(ValueError, match="attention_window"):  # a full-causal net carries no state
        causal(cspec, state=model.init_state(1))
    with pytest.raises(ValueError, match="attention_window"):
        StreamingEnhancer(causal, StftConfig(center=False, **STFT))
    with pytest.raises(ValueError, match="auto"):
        BatchInferencer(model, InferencerConfig(type="mag_to_mag"))
    with pytest.raises(ValueError, match="cspec"):
        model(torch.zeros(1, 5, 161, 2))


def test_cli_enhances_a_directory(rng, tmp_path):
    """-C configs/tiny_mtfaa.toml --batch 2 (no [inferencer] table: the
    default strategy is auto, as in tools/infer.py) writes every wav; with
    --streaming this full-causal MTFAA config is refused for its lack of a window."""
    (tmp_path / "in").mkdir()
    lengths = (4000, 6543, 9100)
    for i, n in enumerate(lengths):
        write_wav(str(tmp_path / "in" / f"utt{i}.wav"), noisy_batch(rng, 1, n)[0], 16000)
    args = ["-C", str(CONFIGS / "tiny_mtfaa.toml"), "-I", str(tmp_path / "in"),
            "-O", str(tmp_path / "out"), "--device", "cpu"]
    cli_main(args + ["--batch", "2"])
    for i, n in enumerate(lengths):
        out, sr = read_wav(str(tmp_path / "out" / f"utt{i}.wav"))
        assert sr == 16000 and out.shape == (n,) and np.abs(out).max() > 0
    with pytest.raises(ValueError, match="attention_window"):
        cli_main(args + ["--streaming"])
