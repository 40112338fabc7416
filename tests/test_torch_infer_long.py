"""Port parity: the mask post-filters, ``overlap_cat`` and
``BatchInferencer.enhance_long`` of cruse_tpu_torch against cruse_tpu, on the
CPU, and the ``infer`` CLI's ``--postfilter`` and ``--chunk_seconds``.

Tolerances: the post-filters and the stitch 1e-6 (elementwise float32 of the
same formulas); enhanced waveforms 1e-4 max-abs, the BASELINE contract.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruse_tpu.dsp import mask as jax_mask
from cruse_tpu.dsp.features import overlap_cat as jax_overlap_cat
from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.infer.batch import BatchInferencer as JaxBatchInferencer
from cruse_tpu.infer.batch import InferencerConfig as JaxInferencerConfig

from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.features import overlap_cat
from cruse_tpu_torch.dsp.mask import envelope_postfilter, postfilter_sin
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer.__main__ import main as cli_main
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.utils.weights import save_flax_npz
from tests.test_torch_cruse import SMALL, make_pair, noisy_batch

ROOT = Path(__file__).resolve().parent.parent
LONG = 36800  # 2.3 s at 16 kHz
CHUNK_SECONDS = 0.5
POSTFILTERS = {"sin": (postfilter_sin, jax_mask.postfilter_sin),
               "envelope": (envelope_postfilter, jax_mask.envelope_postfilter)}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The small CRUSE in both packages (configs/tiny_cruse.toml's model), its
    bridge .npz, 2.3 s of audio as a wav on disk and as read back (``wav``),
    and ``jax``: the JAX package's enhanced audio by name, each computed once
    (``sin`` and ``envelope``: mag_to_mag with that post-filter on the wav;
    ``long``: enhance_long of the wav and its reverse, in 0.5 s chunks)."""
    rng = np.random.default_rng(3)
    jax_model, variables, model = make_pair(SMALL, rng)
    root = tmp_path_factory.mktemp("long")
    save_flax_npz(variables, str(root / "w.npz"))
    write_wav(str(root / "in" / "utt.wav"), noisy_batch(rng, 1, LONG)[0], 16000)
    wav = read_wav(str(root / "in" / "utt.wav"))[0]
    made = {}

    def jax_output(name):
        if name not in made:
            inf = JaxBatchInferencer(jax_model, variables, JaxInferencerConfig(
                stft=JaxStftConfig(n_fft=320, hop_length=160), output_dir=str(root / "jax"),
                postfilter=None if name == "long" else name))
            made[name] = np.asarray(
                inf.enhance_long(jnp.asarray(np.stack([wav, wav[::-1]])), chunk_seconds=CHUNK_SECONDS)
                if name == "long" else inf._strategy(jnp.asarray(wav[None])))
        return made[name]
    return dict(model=model, root=root, wav=wav, jax=jax_output)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU ops in one thread: the suite runs several workers at
    once, and tiny ops on many threads each only wait for the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inferencer(pair, **options):
    return BatchInferencer(pair["model"], InferencerConfig(
        stft=StftConfig(n_fft=320, hop_length=160), output_dir=str(pair["root"] / "torch"), **options),
        device="cpu")


@pytest.mark.parametrize("name", list(POSTFILTERS))
def test_postfilter_matches_jax(rng, name):
    ours, ref = POSTFILTERS[name]
    mask = rng.uniform(0, 1, (3, 50, 161)).astype(np.float32)
    mask[0, 0, :6] = [0.0, 1.0, 1e-9, 1e-4, 0.5, 0.999]
    got = ours(torch.from_numpy(mask))
    want = np.asarray(ref(jnp.asarray(mask)))
    assert got.dtype == torch.float32 and got.shape == mask.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert not np.allclose(got.numpy(), mask, atol=1e-3)  # the filter does change the gains


def test_overlap_cat_matches_jax(rng):
    chunks = [rng.standard_normal((2, 3, 10)).astype(np.float32) for _ in range(4)]
    got = overlap_cat([torch.from_numpy(c) for c in chunks])
    want = np.asarray(jax_overlap_cat([jnp.asarray(c) for c in chunks]))
    assert tuple(got.shape) == want.shape == (2, 3, 25)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(overlap_cat([torch.from_numpy(chunks[0])]).numpy(), chunks[0])


@pytest.mark.parametrize("name", list(POSTFILTERS))
def test_mag_to_mag_postfilter_matches_jax(pair, name):
    noisy = pair["wav"][None]
    want = pair["jax"](name)
    got = inferencer(pair, postfilter=name).mag_to_mag(torch.from_numpy(noisy)).numpy()
    assert got.shape == want.shape == noisy.shape
    err = np.abs(got - want).max()
    assert err <= 1e-4, f"mag_to_mag with the {name} post-filter: max-abs {err}"
    plain = BatchInferencer(pair["model"], InferencerConfig(stft=StftConfig(n_fft=320, hop_length=160)),
                            device="cpu").mag_to_mag(torch.from_numpy(noisy)).numpy()
    assert np.abs(got - plain).max() > 1e-3  # the post-filter is applied


def test_auto_ignores_the_postfilter(pair, capsys):
    """As in the JAX package, ``auto`` does not apply the post-filter; the
    inferencer says so once."""
    noisy = torch.from_numpy(pair["wav"][None, :8000])
    filtered = BatchInferencer(pair["model"], InferencerConfig(type="auto", postfilter="sin"), device="cpu")
    assert "ignored by the auto strategy" in capsys.readouterr().out
    plain = BatchInferencer(pair["model"], InferencerConfig(type="auto"), device="cpu")
    torch.testing.assert_close(filtered.auto(noisy), plain.auto(noisy), rtol=0, atol=0)


def test_enhance_long_matches_jax(pair):
    """2.3 s in 0.5 s chunks (8,000 samples, 50 % overlap): nine chunks of
    the zero-padded audio, stitched and trimmed, for two rows at once."""
    ours = inferencer(pair)
    noisy = np.stack([pair["wav"], pair["wav"][::-1].copy()])
    want = pair["jax"]("long")
    got = ours.enhance_long(torch.from_numpy(noisy), chunk_seconds=CHUNK_SECONDS).numpy()
    assert got.shape == want.shape == noisy.shape
    err = np.abs(got - want).max()
    assert err <= 1e-4, f"enhance_long max-abs {err}"
    short = torch.from_numpy(noisy[:, :7000])  # shorter than a chunk: one strategy call
    torch.testing.assert_close(ours.enhance_long(short, chunk_seconds=CHUNK_SECONDS), ours.mag_to_mag(short),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="two hops"):
        ours.enhance_long(short, chunk_seconds=0.01)


def test_cli_postfilter_and_chunk_seconds(pair, tmp_path):
    """``--postfilter`` overrides the config's (none in tiny_cruse.toml) and
    ``--chunk_seconds`` enhances each file through ``enhance_long``; each
    written wav is the JAX package's result for the same wav, scaled to int16.
    ``--chunk_seconds`` with ``--streaming`` is refused."""
    base = ["-C", str(ROOT / "configs/tiny_cruse.toml"), "-I", str(pair["root"] / "in"),
            "--weights", str(pair["root"] / "w.npz"), "--device", "cpu"]
    runs = {"envelope": ["--postfilter", "envelope", "--batch", "2"],
            "long": ["--chunk_seconds", str(CHUNK_SECONDS), "--batch", "2"]}
    for name, flags in runs.items():
        cli_main([*base, "-O", str(tmp_path / name), *flags])
        want = to_int16_scaled(pair["jax"](name)[0]).astype(np.float64)
        got = np.round(read_wav(str(tmp_path / name / "utt.wav"))[0] * 32768.0)
        assert got.shape == want.shape
        err = np.abs(got - want).max() / 32768.0
        assert err <= 1e-4, f"{flags[0]}: written wav vs JAX max-abs {err}"
    with pytest.raises(SystemExit):
        cli_main([*base, "-O", str(tmp_path / "s"), "--streaming", "--chunk_seconds", "1"])
