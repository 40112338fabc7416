"""Port parity: cruse_tpu_torch.data (dataset, native I/O, prefetch) against
cruse_tpu.data on the CPU.

- Host batches (clean, noise, RIRs) equal cruse_tpu.data.dataset's bit for
  bit from the same seed, through Python I/O and through the native
  assembler; the port builds ``native/cruseio.cc`` itself into the build
  directory, and its ``assemble_batch`` equals the JAX package's copy.
- ``batches`` yields mixed [B, L] tensors, the same for the same seed and
  other mixing for another epoch; ``set_snr_range`` moves the mixer's range.
- Multi-channel configs are refused by name.
- ``prefetch``: order kept, a producer's exception raised in the consumer,
  the producer thread stopped when the consumer breaks off, and the epoch
  passed to a factory that takes it.
"""
import threading
import time

import numpy as np
import pytest
import torch

from cruse_tpu.data import native as jax_native
from cruse_tpu.data.dataset import SynMixConfig as JaxSynMixConfig
from cruse_tpu.data.dataset import SynMixDataset as JaxSynMixDataset

from cruse_tpu_torch.data import native
from cruse_tpu_torch.data.dataset import SynMixConfig, SynMixDataset, mixing_seed
from cruse_tpu_torch.data.manifest import write_manifest
from cruse_tpu_torch.data.prefetch import PrefetchingLoader, prefetch
from cruse_tpu_torch.data.wavio import write_wav

SR = 16000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Clean clips of 0.6 to 1.4 s (so rows concatenate clips with silence),
    noise clips, RIRs, and their manifests."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(9)
    paths = {"clean": [], "noise": [], "rir": []}
    for i in range(5):
        n = int(SR * rng.uniform(0.6, 1.4))
        t = np.arange(n) / SR
        paths["clean"].append(str(root / f"c{i}.wav"))
        write_wav(paths["clean"][-1], (0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(np.float32), SR)
        paths["noise"].append(str(root / f"n{i}.wav"))
        write_wav(paths["noise"][-1], (0.1 * rng.standard_normal(int(SR * 1.1))).astype(np.float32), SR)
        rir = np.zeros(int(SR * rng.uniform(0.2, 0.7)), np.float32)
        rir[20 + i] = 0.9
        rir[400 + 7 * i] = 0.3
        paths["rir"].append(str(root / f"r{i}.wav"))
        write_wav(paths["rir"][-1], rir, SR)
    manifests = {}
    for kind, files in paths.items():
        manifests[kind] = str(root / f"{kind}.txt")
        write_manifest(files, manifests[kind])
    return manifests


def config_args(corpus, **kw):
    return dict(clean_manifest=corpus["clean"], noise_manifest=corpus["noise"], rir_manifest=corpus["rir"],
                rir_noise_manifest=corpus["rir"], reverb_proportion=0.5, reverb_noise_proportion=0.5,
                sub_sample_seconds=2.0, batch_size=3, seed=4, **kw)


@pytest.mark.parametrize("use_native_io", [False, True], ids=["python_io", "native_io"])
def test_host_batches_equal_jax(corpus, use_native_io):
    ours = SynMixDataset(SynMixConfig(**config_args(corpus, use_native_io=use_native_io)), device="cpu")
    theirs = JaxSynMixDataset(JaxSynMixConfig(**config_args(corpus, use_native_io=use_native_io)))
    calls = native.assemble_batch.calls
    for _ in range(3):
        for a, b in zip(ours.host_batch(), theirs.host_batch()):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert native.assemble_batch.calls - calls == (6 if use_native_io else 0)


def test_native_assemble_batch_equals_jax_copy(corpus):
    from cruse_tpu_torch.data.manifest import load_manifest

    pool = load_manifest(corpus["clean"]) + ["/nonexistent.wav"]
    ours, ok = native.assemble_batch(pool, 6, 24000, 3200, SR, seed=123, threads=3)
    theirs, jax_ok = jax_native.assemble_batch(pool, 6, 24000, 3200, SR, seed=123, threads=3)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ok, jax_ok)
    assert ok.all() and np.abs(ours).max() > 0.1
    assert "build/cruse_tpu_torch/libcruseio-" in native.library_path()
    wav, sr = native.decode(load_manifest(corpus["clean"])[0])
    np.testing.assert_array_equal(wav, jax_native.decode(load_manifest(corpus["clean"])[0])[0])


def test_batches_mix_on_the_device(corpus):
    cfg = SynMixConfig(**config_args(corpus, valid_mode=True))
    ds, again = SynMixDataset(cfg, device="cpu"), SynMixDataset(cfg, device="cpu")
    first = list(ds.batches(num_batches=2))
    assert [tuple(b["noisy"].shape) for b in first] == [(3, 32000)] * 2
    assert first[0]["noisy"].dtype == torch.float32 and first[0]["name"][1] == "synth_00000_001"
    assert all(torch.isfinite(b["noisy"]).all() and b["noisy"].abs().max() <= 0.99 + 1e-6 for b in first)
    repeat = list(again.batches(num_batches=2))
    for a, b in zip(first, repeat):  # the same seed: the same batches
        assert torch.equal(a["noisy"], b["noisy"]) and torch.equal(a["clean"], b["clean"])
    # the next epoch's mixing: other draws on the same host selection
    ds.rng, again.rng = np.random.default_rng(0), np.random.default_rng(0)
    epoch_1 = next(ds.batches(num_batches=1))
    epoch_0 = next(again.batches(num_batches=1, generator=torch.Generator().manual_seed(mixing_seed(4, 0))))
    assert not torch.equal(epoch_1["noisy"], epoch_0["noisy"])


def test_set_snr_range(corpus):
    ds = SynMixDataset(SynMixConfig(**config_args(corpus, snr_range=(-5, 20))), device="cpu")
    ds.set_snr_range((15, 15))
    assert ds.mixer_cfg.snr_range == (15, 15)
    from cruse_tpu_torch.data.mixer import draw_mix, mix_components

    clean, noise, rir, rir_noise = (None if a is None else torch.from_numpy(a) for a in ds.host_batch())
    draws = draw_mix(torch.Generator().manual_seed(0), 3, ds.mixer_cfg)
    assert draws.snr.tolist() == [15, 15, 15]
    clean_s, noise_s, _ = mix_components(clean, noise, ds.mixer_cfg, draws)
    snr = 20 * torch.log10(clean_s.pow(2).mean(-1).sqrt() / noise_s.pow(2).mean(-1).sqrt())
    np.testing.assert_allclose(snr.numpy(), 15.0, atol=1e-3)
    with pytest.raises(ValueError, match="low snr"):
        ds.set_snr_range((10, 5))


@pytest.mark.parametrize("field", [{"num_mics": 2}, {"mc_room": True}, {"mc_rir_manifest": "x.txt"}])
def test_multichannel_is_refused_by_name(field):
    with pytest.raises(NotImplementedError, match=f"{next(iter(field))}.*McCruse"):
        SynMixConfig(**field)


def test_prefetch_keeps_order_and_reiterates():
    assert list(prefetch(iter(range(20)), size=3)) == list(range(20))
    seen = []

    def make(epoch: int = 0):
        seen.append(epoch)
        return iter([epoch, epoch + 1])

    loader = PrefetchingLoader(make, size=2)
    assert list(loader(epoch=5)) == [5, 6] and list(loader(epoch=7)) == [7, 8] and list(loader) == [0, 1]
    assert seen == [5, 7, 0]


def test_prefetch_raises_the_producers_exception():
    def broken():
        yield 1
        raise RuntimeError("bad batch")

    got = []
    with pytest.raises(RuntimeError, match="bad batch"):
        for item in prefetch(broken(), size=2):
            got.append(item)
    assert got == [1]


def test_prefetch_stops_the_producer_on_early_break():
    made = []

    def endless():
        i = 0
        while True:
            made.append(i)
            yield i
            i += 1

    before = set(threading.enumerate())
    gen = prefetch(endless(), size=2)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()
    producers = [t for t in threading.enumerate() if t not in before]
    for t in producers:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in producers)
    count = len(made)
    time.sleep(0.3)
    assert len(made) == count <= 3 + 2 + 1  # taken + queue + the one a put was waiting on
