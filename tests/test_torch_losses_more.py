"""Port parity: the rest of cruse_tpu_torch's losses -- ``rmse_loss``,
``weighted_male_loss``, ``sdnr_loss``, ``multi_res_spectral_loss``,
``cirm_mse_loss``, ``pmsqe_loss``, ``si_snr_zero_mean``, ``stable_angle`` --
their helpers (``frame_vad``, the compressed cIRM) and the registry, against
cruse_tpu on the CPU.

Inputs are numpy-seeded random spectra and waveforms, where ties of a
``max``, ``clip`` or ``where`` (at which JAX and torch may split a gradient
differently) have probability zero. Tolerances: each value within 1e-5
relative (float32 sums in another order; PMSQE 2e-5, its Bark sums run
through a matrix product); each gradient within GRAD_TOL of its largest
element: 1e-5 for the elementwise losses (float32 rounding of chains of up
to a few dozen operations), 1e-4 for PMSQE and the zero-mean SI-SNR (sums
over bands or samples), 5e-4 for ``multi_res`` (three FFT sizes' transforms
summed in another order; the largest error, 1.4e-4 of the largest element,
is at a reflect-padded edge, whose samples gather gradient from several
frames).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.dsp import features as jfeatures
from cruse_tpu.dsp import mask as jmask
from cruse_tpu.losses import pmsqe as jpmsqe
from cruse_tpu.losses import registry as jregistry
from cruse_tpu.losses import sisnr as jsisnr
from cruse_tpu.losses import spectral as jspectral

from cruse_tpu_torch.dsp.features import frame_vad
from cruse_tpu_torch.dsp.mask import build_complex_ideal_ratio_mask, compress_cirm
from cruse_tpu_torch.losses import pmsqe, registry, sisnr, spectral

GRAD_TOL = {"rmse": 1e-5, "wo_male": 1e-5, "sdnr": 1e-5, "multi_res": 5e-4, "cirm": 1e-5, "pmsqe": 1e-4,
            "si_snr_zero_mean": 1e-4, "compressed": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spectra(seed, n=3, shape=(2, 9, 33, 2)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def waves(seed, shape=(2, 4000)):
    rng = np.random.default_rng(seed)
    ref = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (ref + 0.05 * rng.standard_normal(shape)).astype(np.float32), ref


def check(name, torch_fn, jax_fn, est, *consts, rtol=1e-5):
    """Value and gradient with respect to the first argument, both packages."""
    et = torch.from_numpy(est).requires_grad_()
    value = torch_fn(et, *[torch.from_numpy(c) for c in consts])
    value.backward()
    jconsts = [jnp.asarray(c) for c in consts]
    want, grad = jax.value_and_grad(lambda e: jax_fn(e, *jconsts))(jnp.asarray(est))
    np.testing.assert_allclose(float(value.detach()), float(want), rtol=rtol, err_msg=name)
    grad = np.asarray(grad)
    assert np.isfinite(et.grad.numpy()).all() and np.abs(grad).max() > 0, name
    err = np.abs(et.grad.numpy() - grad).max()
    assert err <= GRAD_TOL[name] * np.abs(grad).max(), (name, err, np.abs(grad).max())


def test_rmse_loss_matches_jax():
    est, ref, _ = spectra(0)
    check("rmse", spectral.rmse_loss, jspectral.rmse_loss, est, ref)


def test_weighted_male_loss_matches_jax():
    check("wo_male", spectral.weighted_male_loss, jspectral.weighted_male_loss, *spectra(1))


def test_cirm_mse_loss_matches_jax():
    check("cirm", spectral.cirm_mse_loss, jspectral.cirm_mse_loss, *spectra(2))


def test_compressed_spectral_loss_still_matches_jax():
    est, ref, _ = spectra(3)
    check("compressed", spectral.compressed_spectral_loss, jspectral.compressed_spectral_loss, est, ref)


@pytest.mark.parametrize("nb", [None, 24], ids=["default_bands", "24_bands"])
def test_pmsqe_loss_matches_jax(nb):
    est, ref, _ = spectra(4)
    check("pmsqe", lambda e, r: pmsqe.pmsqe_loss(e, r, nb=nb), lambda e, r: jpmsqe.pmsqe_loss(e, r, nb=nb),
          est, ref, rtol=2e-5)


def test_pmsqe_tables_match_jax():
    for n_fft, sr in ((64, 16000), (320, 16000), (256, 8000)):
        mat, widths, thresh, scale = pmsqe.pmsqe_tables(n_fft, sr, None, torch.device("cpu"))
        jmat, jwidths, jthresh, jscale = jpmsqe.pmsqe_tables(n_fft, sr)
        for ours, theirs in ((mat, jmat), (widths, jwidths), (thresh, jthresh)):
            assert ours.dtype == torch.float32
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        assert scale == jscale


def test_pmsqe_is_zero_for_equal_spectra_and_blind_to_gain():
    est, _, _ = spectra(5)
    e = torch.from_numpy(est)
    assert abs(float(pmsqe.pmsqe_loss(e, e))) < 1e-6
    np.testing.assert_allclose(float(pmsqe.pmsqe_loss(3.0 * e, e)), 0.0, atol=1e-6)


def test_multi_res_spectral_loss_matches_jax():
    est, ref = waves(6)
    check("multi_res", spectral.multi_res_spectral_loss, jspectral.multi_res_spectral_loss, est, ref)
    cfg = spectral.MultiResSpectralConfig(n_ffts=(256,), factor_complex=0.0)
    jcfg = jspectral.MultiResSpectralConfig(n_ffts=(256,), factor_complex=0.0)
    np.testing.assert_allclose(
        float(spectral.multi_res_spectral_loss(torch.from_numpy(est), torch.from_numpy(ref), cfg)),
        float(jspectral.multi_res_spectral_loss(jnp.asarray(est), jnp.asarray(ref), jcfg)), rtol=1e-5)


def test_sdnr_loss_matches_jax():
    rng = np.random.default_rng(7)
    clean = (rng.standard_normal((2, 9, 33)) + 1j * rng.standard_normal((2, 9, 33))).astype(np.complex64)
    clean[1, :3] *= 1e-4  # quiet frames, below the VAD's -60 dB
    noise = (rng.standard_normal((2, 9, 33)) + 1j * rng.standard_normal((2, 9, 33))).astype(np.complex64)
    gain = rng.uniform(0.05, 0.95, (2, 9, 33)).astype(np.float32)
    snr_db = np.array([3.0, 17.0], np.float32)
    check("sdnr", lambda g, c, n, s: spectral.sdnr_loss(c, g, n, s),
          lambda g, c, n, s: jspectral.sdnr_loss(c, g, n, s), gain, clean, noise, snr_db)


def test_si_snr_zero_mean_matches_jax():
    est, ref = waves(8)
    check("si_snr_zero_mean", sisnr.si_snr_zero_mean, jsisnr.si_snr_zero_mean, est, ref)


def test_stable_angle_matches_jax_and_clamps_at_zero():
    rng = np.random.default_rng(9)
    re, im = (rng.standard_normal(50).astype(np.float32) for _ in range(2))
    re[:2], im[:2] = 0.0, 0.0  # the radius clamp
    tr, ti = torch.from_numpy(re).requires_grad_(), torch.from_numpy(im).requires_grad_()
    out = spectral.stable_angle(tr, ti)
    out.sum().backward()
    want = jspectral.stable_angle(jnp.asarray(re), jnp.asarray(im))
    gr, gi = jax.grad(lambda r, i: jnp.sum(jspectral.stable_angle(r, i)), argnums=(0, 1))(
        jnp.asarray(re), jnp.asarray(im))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(gr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), rtol=1e-5, atol=1e-6)
    assert np.isfinite(tr.grad.numpy()).all()


def test_frame_vad_and_cirm_helpers_match_jax():
    rng = np.random.default_rng(10)
    mag = np.abs(rng.standard_normal((2, 12, 33))).astype(np.float32)
    mag[0, 4:7] *= 1e-4
    np.testing.assert_array_equal(frame_vad(torch.from_numpy(mag)).numpy(),
                                  np.asarray(jfeatures.frame_vad(jnp.asarray(mag))))
    assert float(frame_vad(torch.from_numpy(mag))[0, 4:7].sum()) == 0
    x = (rng.standard_normal(200) * 60).astype(np.float32)
    x[:3] = [-100.0, -250.0, 0.0]
    np.testing.assert_allclose(compress_cirm(torch.from_numpy(x)).numpy(),
                               np.asarray(jmask.compress_cirm(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    noisy, clean = ((rng.standard_normal((2, 5, 9)) + 1j * rng.standard_normal((2, 5, 9))).astype(np.complex64)
                    for _ in range(2))
    ours = build_complex_ideal_ratio_mask(torch.from_numpy(noisy), torch.from_numpy(clean))
    theirs = jmask.build_complex_ideal_ratio_mask(jnp.asarray(noisy), jnp.asarray(clean))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(jregistry.LOSS_REGISTRY))
def test_registry_entry_matches_jax(name):
    assert sorted(registry.LOSS_REGISTRY) == sorted(jregistry.LOSS_REGISTRY)
    est, ref, noisy = spectra(11)
    w_est, w_ref = waves(12)
    if name == "SDNR":
        rng = np.random.default_rng(13)
        clean = (rng.standard_normal((2, 9, 33)) + 1j * rng.standard_normal((2, 9, 33))).astype(np.complex64)
        args = (clean, rng.uniform(0, 1, (2, 9, 33)).astype(np.float32), clean * 0.3, np.array([5.0, 9.0], np.float32))
        kw = {}
    elif name in ("WO_MALE", "cirm"):
        args, kw = (est, ref), {"noisy": noisy}
    elif name in ("SI-SNR", "si_snr", "si_snr_zero_mean", "multi_res_spectral"):
        args, kw = (w_est, w_ref), {}
    else:
        args, kw = (est, ref), {}
    ours = registry.get_loss(name)(*[torch.from_numpy(a) for a in args], **{k: torch.from_numpy(v) for k, v in kw.items()})
    theirs = jregistry.get_loss(name)(*[jnp.asarray(a) for a in args], **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(float(ours), float(theirs), rtol=2e-5, err_msg=name)


def test_registry_errors_match_jax():
    with pytest.raises(KeyError, match="unknown loss 'nope'"):
        registry.get_loss("nope")
    with pytest.raises(KeyError, match="unknown loss 'nope'"):
        jregistry.get_loss("nope")
    est, ref, _ = spectra(14)
    with pytest.raises(TypeError, match="noisy RI spectrum"):
        registry.get_loss("cirm")(torch.from_numpy(est), torch.from_numpy(ref))
    with pytest.raises(TypeError, match="noisy RI spectrum"):
        jregistry.get_loss("cirm")(jnp.asarray(est), jnp.asarray(ref))
