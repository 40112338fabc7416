"""Port parity: training the multi-mic McCruse (cruse_tpu_torch) against
cruse_tpu on the CPU: multi-channel dataset batches, the train step on
``[B, M, L]`` batches, the trainer, and the train CLI on
``configs/tiny_mc.toml`` and ``configs/tiny_mc_rir.toml``.

- **The dataset**, over its three mixers (free field, the image-source room,
  measured array RIRs) at 3 mics: host batches equal the JAX package's bit
  for bit through Python I/O and the native assembler, the single-channel
  RIRs still drawn (and dropped) and the measured ones drawn after the
  audio, the speech's for all rows and then the noise's, through the
  per-path cache without moving the generator's sequence; device batches
  mixed with the JAX dataset's own draws (its key, split as it splits it)
  within the mixers' bounds (tests/test_torch_mc_mixer.py: free field
  1e-5, room and measured 1e-4); an RIR with fewer channels than mics
  raises; ``set_snr_range`` moves a multi-channel mixer's SNR.
- **The step** at ``configs/tiny_mc.toml``'s widths (mic pairs (0, 1), (0,
  2); the trunk (4, 8, 8, 16), 4 GRU groups), weights bridged from flax
  with BatchNorm statistics and the PReLU slope moved: the losses 1e-5
  relative, the gradient's norm 2e-3, every gradient leaf within
  tests/test_torch_train_step.py's bounds (relative 2e-3, or 3e-3 of the
  largest + 1e-3; a conv bias that feeds a BatchNorm, zero but for
  rounding, within 1e-3 of the largest + 5e-3), for si_snr + spec and for
  wo_male + cirm + distill taught by a second McCruse. ``sdnr`` takes the
  reference mic's noisy waveform: the JAX step raises on a multi-channel
  batch there (it subtracts [B, L] from [B, M, L]), so the port's loss is
  held to the JAX package's ``sdnr_loss`` on the reference mic (1e-5).
- **The trainer** against JAX's ``Trainer`` on the same pre-mixed [B, 3, L]
  batches, 1 epoch x 2 steps with validation (test_torch_trainer.py's
  bounds: epoch means 1e-4, the gradient norm's 2e-3, validation means
  1e-3, the best-epoch decision); the EMA, checkpoints, resume and the
  prefetcher on multi-channel batches.
- **The CLI** end to end on ``--device cpu`` for both tiny configs, on a
  corpus from ``examples/make_tiny_corpus.py`` under a temporary root.
"""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruse_tpu.data import mixer as jmixer
from cruse_tpu.data.dataset import SynMixConfig as JaxSynMixConfig
from cruse_tpu.data.dataset import SynMixDataset as JaxSynMixDataset
from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.dsp.stft import istft as jax_istft
from cruse_tpu.dsp.stft import mc_stft as jax_mc_stft
from cruse_tpu.dsp.stft import stft as jax_stft
from cruse_tpu.losses.balancer import Balancer as JaxBalancer
from cruse_tpu.losses.sisnr import si_snr_loss as jax_si_snr_loss
from cruse_tpu.losses import spectral as jspectral
from cruse_tpu.train import step as jstep
from cruse_tpu.train.trainer import Trainer as JaxTrainer
from cruse_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

from cruse_tpu_torch.data import native
from cruse_tpu_torch.data.dataset import SynMixConfig, SynMixDataset
from cruse_tpu_torch.data.manifest import write_manifest
from cruse_tpu_torch.data.prefetch import PrefetchingLoader
from cruse_tpu_torch.data.wavio import write_wav
from cruse_tpu_torch.dsp.stft import StftConfig, mc_stft
from cruse_tpu_torch.models import McCruseNet
from cruse_tpu_torch.train import checkpoint
from cruse_tpu_torch.train.step import StepConfig, forward_for_model, init_train_state, make_loss_gradients, \
    make_train_step
from cruse_tpu_torch.train.trainer import Trainer, TrainerConfig
from cruse_tpu_torch.utils.weights import state_dict_from_flax
from tests.test_torch_cruse_train import zero_gradient
from tests.test_torch_mc_cruse import MICS, make_mc_pair
from tests.test_torch_mc_mixer import FREE_TOL, MIX_TOL, jax_mc_draws
from tests.test_torch_trainer import METRICS, RecordingWriter, record_decisions, speech

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
STFT = dict(n_fft=320, hop_length=160)
LR = 1e-3
LOSS_SETS = {"si_snr_spec": (("si_snr", 1.0), ("spec", 1.0)),
             "wo_male_cirm_distill": (("wo_male", 1.0), ("cirm", 1.0), ("distill", 1.0))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_tiny_corpus(root) -> None:
    """``examples/make_tiny_corpus.py``'s corpus under ``root``: clean and
    noise clips, 3-mic measured RIRs, their manifests."""
    spec = importlib.util.spec_from_file_location("make_tiny_corpus", os.path.join(ROOT, "examples",
                                                                                   "make_tiny_corpus.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main(str(root))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tiny corpus, mono RIRs for the single-channel draws, and 2-channel
    RIRs (fewer than the mics)."""
    root = tmp_path_factory.mktemp("mc_corpus")
    make_tiny_corpus(root)
    rng = np.random.default_rng(3)
    mono, stereo = [], []
    for i in range(3):
        rir = np.zeros(int(SR * rng.uniform(0.2, 0.5)), np.float32)
        rir[20 + i], rir[300 + 9 * i] = 0.9, 0.3
        mono.append(str(root / f"rir_{i}.wav"))
        write_wav(mono[-1], rir, SR)
        stereo.append(str(root / f"rir2_{i}.wav"))
        write_wav(stereo[-1], np.stack([rir, np.roll(rir, 3)]), SR)
    write_manifest(mono, str(root / "rir.txt"))
    write_manifest(stereo, str(root / "rir2.txt"))
    return root


MIXERS = {"free": dict(mc_max_delay=6.0), "room": dict(mc_room=True, mc_room_t60=(0.25, 0.6)),
          "rir": dict(mc_rir_manifest="mc_rir_train.txt", rir_max_seconds=0.15)}


def mc_args(corpus, mixer_name: str, **kw) -> dict:
    extra = {k: str(corpus / v) if k.endswith("manifest") else v for k, v in MIXERS[mixer_name].items()}
    return dict(clean_manifest=str(corpus / "clean_train.txt"), noise_manifest=str(corpus / "noise_train.txt"),
                rir_manifest=str(corpus / "rir.txt"), reverb_proportion=0.5, sub_sample_seconds=0.5,
                batch_size=3, num_mics=3, seed=4, **extra, **kw)


def jax_room(cfg: JaxSynMixConfig) -> jmixer.RoomConfig:
    return jmixer.RoomConfig(sr=cfg.sr, t60=tuple(cfg.mc_room_t60), max_order=cfg.mc_room_max_order,
                             mic_spacing=cfg.mc_mic_spacing, array_geometry=cfg.mc_array_geometry,
                             array_radius=cfg.mc_array_radius,
                             mic_positions=tuple(tuple(p) for p in cfg.mc_mic_positions))


@pytest.mark.parametrize("use_native_io", [False, True], ids=["python_io", "native_io"])
@pytest.mark.parametrize("mixer_name", list(MIXERS))
def test_mc_host_batches_equal_jax(corpus, mixer_name, use_native_io):
    args = mc_args(corpus, mixer_name, use_native_io=use_native_io)
    ours, theirs = SynMixDataset(SynMixConfig(**args), device="cpu"), JaxSynMixDataset(JaxSynMixConfig(**args))
    calls = native.assemble_batch.calls
    for _ in range(3):  # a small RIR corpus: the later batches come from the cache
        got = ours.host_arrays()
        clean, noise, rir, _ = theirs.host_batch()
        assert rir is not None  # the single-channel draws are made, though the path ignores them
        want = [clean, noise]
        if mixer_name == "rir":
            want += [np.stack([theirs._select_rir_mc(theirs.mc_rir_list) for _ in range(3)]),
                     np.stack([theirs._select_rir_mc(theirs.mc_rir_noise_list) for _ in range(3)])]
            assert got[2].shape == (3, 3, int(0.15 * SR))
        else:
            want += [None, None]
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    assert native.assemble_batch.calls - calls == (6 if use_native_io else 0)
    assert ours.rng.integers(2**62) == theirs.rng.integers(2**62)  # the same sequence after the cache


@pytest.mark.parametrize("mixer_name", list(MIXERS))
def test_mc_device_batches_match_jax(corpus, mixer_name):
    """The port mixes its host arrays with the draws the JAX dataset's first
    batch makes from its key: the JAX batch within the mixer's bound."""
    args = mc_args(corpus, mixer_name, use_native_io=False, valid_mode=True)
    ours, theirs = SynMixDataset(SynMixConfig(**args), device="cpu"), JaxSynMixDataset(JaxSynMixConfig(**args))
    want = next(theirs.batches(num_batches=1))
    _, sub = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(4), 0))
    draws = jax_mc_draws(sub, mixer_name, ours.mixer_cfg, batch=3, num_mics=3, room=jax_room(theirs.cfg),
                         max_delay=ours.cfg.mc_max_delay)
    noisy, clean = ours.mix(ours.to_device(ours.host_arrays()), draws)
    tol = FREE_TOL if mixer_name == "free" else MIX_TOL
    assert noisy.shape == (3, 3, SR // 2) and clean.shape == (3, SR // 2)
    assert float(np.abs(noisy.numpy() - np.asarray(want["noisy"])).max()) <= tol
    assert float(np.abs(clean.numpy() - np.asarray(want["clean"])).max()) <= tol
    # the port's own batches: the shapes, the guard, the names
    again = SynMixDataset(SynMixConfig(**args), device="cpu")
    batch = next(again.batches(num_batches=1))
    assert batch["noisy"].shape == (3, 3, SR // 2) and batch["clean"].shape == (3, SR // 2)
    assert bool(torch.isfinite(batch["noisy"]).all()) and float(batch["noisy"].abs().max()) <= 0.99 + 1e-6
    assert batch["name"][2] == "synth_00000_002"


def test_mc_rir_with_fewer_channels_than_mics_raises(corpus):
    args = mc_args(corpus, "rir", use_native_io=False)
    ds = SynMixDataset(SynMixConfig(**{**args, "mc_rir_manifest": str(corpus / "rir2.txt")}), device="cpu")
    with pytest.raises(ValueError, match="2 channels < num_mics=3"):
        ds.host_arrays()


def test_mc_set_snr_range(corpus):
    ds = SynMixDataset(SynMixConfig(**mc_args(corpus, "free", use_native_io=False, snr_range=(-5, 20))),
                       device="cpu")
    ds.set_snr_range((15, 15))
    draws = ds.draw(torch.Generator().manual_seed(0))
    assert draws.snr.tolist() == [15, 15, 15]
    from cruse_tpu_torch.data.mixer import mix_components

    clean, noise, _, _ = ds.to_device(ds.host_arrays())
    clean_s, noise_s, _ = mix_components(clean, noise, ds.mixer_cfg, draws)
    snr = 20 * torch.log10(clean_s.pow(2).mean(-1).sqrt() / noise_s.pow(2).mean(-1).sqrt())
    np.testing.assert_allclose(snr.numpy(), 15.0, atol=1e-3)


# ---------------- the step ----------------


def mc_pair_batch(rng, b: int, n: int, mics: int = MICS) -> dict:
    """A clean utterance [B, L] and its noisy array [B, M, L]: the clean
    delayed 3 samples a mic with noise on every mic."""
    clean = speech(rng, b, n)["clean"]
    noisy = np.stack([np.roll(clean, 3 * m, axis=-1) + 0.05 * rng.standard_normal((b, n)) for m in range(mics)],
                     axis=1)
    return {"noisy": noisy.astype(np.float32), "clean": clean}


def jax_state(variables, jcfg, losses):
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    return jstep.TrainState(params=jvars["params"], batch_stats=jvars["batch_stats"],
                            opt_state=jstep.make_optimizer(jcfg).init(jvars["params"]),
                            balancer_state=JaxBalancer.make(dict(losses)).init_state(),
                            step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def teacher():
    jax_teacher, tvars, model = make_mc_pair(np.random.default_rng(12))
    return jax_teacher, tvars, model


@pytest.fixture(scope="module", params=list(LOSS_SETS))
def one_step(request, teacher):
    """Both packages' step on one [2, 3, 2400] batch from the same weights,
    and the port's gradients of it."""
    losses = LOSS_SETS[request.param]
    rng = np.random.default_rng(0)
    jax_model, variables, model = make_mc_pair(rng)
    jcfg = jstep.StepConfig(stft=JaxStftConfig(**STFT), learning_rate=LR, loss_weights=losses)
    jstate = jax_state(variables, jcfg, losses)
    data = mc_pair_batch(rng, 2, 2400)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    jforward = jstep.forward_for_model(jax_model)
    distill = any(name == "distill" for name, _ in losses)
    jax_teacher, tvars, teacher_model = teacher
    jteacher = ((jstep.forward_for_model(jax_teacher), jax.tree_util.tree_map(jnp.asarray, tvars))
                if distill else None)
    jnew, jmetrics = jax.jit(jstep.make_train_step(jax_model, jcfg, jforward, teacher=jteacher))(jstate, jbatch)

    cfg = StepConfig(stft=StftConfig(**STFT), learning_rate=LR, loss_weights=losses)
    state = init_train_state(model, cfg, device="cpu")
    port_teacher = (forward_for_model(teacher_model), teacher_model) if distill else None
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads, _, _ = make_loss_gradients(model, cfg, teacher=port_teacher)(state.balancer_state, tbatch)
    model.load_state_dict(before)  # the gradient pass moved the running statistics
    new, metrics = make_train_step(model, cfg, teacher=port_teacher)(state, tbatch)
    named = {n: g.numpy() for (n, _), g in zip(model.named_parameters(), grads)}
    return dict(losses=losses, jcfg=jcfg, jstate=jstate, jnew=jnew, jmetrics=jmetrics, jbatch=jbatch,
                jforward=jforward, jteacher=jteacher, model=model, new=new, metrics=metrics, grads=named)


def jax_loss_fns(jcfg, jb, out_ri_teacher=None):
    """The JAX step's losses on a multi-channel batch, from its own pieces:
    the reference mic's (mic 0's) noisy spectrum."""
    scfg = jcfg.stft
    ri = lambda z: jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)  # noqa: E731
    spec_mc = jax_mc_stft(jb["noisy"], scfg)
    noisy_spec, clean_spec = spec_mc[:, 0], jax_stft(jb["clean"], scfg)
    noisy_ri, clean_ri = ri(noisy_spec), ri(clean_spec)
    norm = clean_spec.shape[0] * clean_spec.shape[1] * clean_spec.shape[2]
    length = jb["noisy"].shape[-1]

    def sdnr(o):
        noisy_mag = jnp.sqrt(noisy_ri[..., 0] ** 2 + noisy_ri[..., 1] ** 2 + 1e-12)
        enh_mag = jnp.sqrt(o[..., 0] ** 2 + o[..., 1] ** 2 + 1e-12)
        gain = jnp.clip(enh_mag / (noisy_mag + 1e-8), 0.0, 1.0)
        noise = jb["noisy"][:, 0] - jb["clean"]
        snr_db = 10.0 * jnp.log10(jnp.sum(jb["clean"] ** 2, -1) / (jnp.sum(noise ** 2, -1) + 1e-10) + 1e-10)
        return jspectral.sdnr_loss(clean_spec, gain, noisy_spec - clean_spec, snr_db) / norm

    fns = {"si_snr": lambda o: jax_si_snr_loss(jax_istft((o[..., 0], o[..., 1]), scfg, length=length), jb["clean"]),
           "spec": lambda o: jspectral.compressed_spectral_loss(o, clean_ri) / norm,
           "wo_male": lambda o: jspectral.weighted_male_loss(o, clean_ri, noisy_ri),
           "cirm": lambda o: jspectral.cirm_mse_loss(o, noisy_ri, clean_ri),
           "sdnr": sdnr}
    if out_ri_teacher is not None:
        fns["distill"] = lambda o: jspectral.compressed_spectral_loss(o, out_ri_teacher) / norm
    return ri(spec_mc), fns


def jax_gradients(s):
    """The reference step's gradients (it returns none), from its pieces."""
    jstate = s["jstate"]

    @jax.jit
    def gradients(params, batch_stats, balancer_state, jb):
        model_ri, _ = jax_loss_fns(s["jcfg"], jb)
        teacher_ri = None
        if s["jteacher"] is not None:
            forward, tvars = s["jteacher"]
            teacher_ri = forward(tvars["params"], tvars["batch_stats"], model_ri, train=False)[0]
        _, fns = jax_loss_fns(s["jcfg"], jb, teacher_ri)
        out, vjp_fn, _ = jax.vjp(lambda p: s["jforward"](p, batch_stats, model_ri), params, has_aux=True)
        out_grad, _, _, _ = JaxBalancer.make(dict(s["losses"])).output_cotangent(
            {name: fns[name] for name, _ in s["losses"]}, out, balancer_state)
        return vjp_fn(out_grad)[0]

    return gradients(jstate.params, jstate.batch_stats, jstate.balancer_state, s["jbatch"])


def test_mc_step_losses_match_jax(one_step):
    s = one_step
    for name, _ in s["losses"]:
        np.testing.assert_allclose(float(s["metrics"][f"loss_{name}"]), float(s["jmetrics"][f"loss_{name}"]),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(s["metrics"]["grad_norm"]), float(s["jmetrics"]["grad_norm"]), rtol=2e-3)
    assert float(s["metrics"]["nonfinite_skipped"]) == float(s["jmetrics"]["nonfinite_skipped"]) == 0
    assert s["new"].step == int(s["jnew"].step) == 1 and s["new"].opt_state.count == 1


def test_mc_step_gradient_leaves_match_jax(one_step):
    s = one_step
    theirs = {k: v.numpy() for k, v in state_dict_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, jax_gradients(s))}, s["model"]).items()
        if not k.endswith("num_batches_tracked") and k in s["grads"]}
    ours = s["grads"]
    assert ours.keys() == theirs.keys() and len(ours) > 20
    gscale = max(np.abs(v).max() for v in theirs.values())
    for key, want in theirs.items():
        err = np.abs(ours[key] - want).max()
        if zero_gradient(s["model"], key):
            assert err < 1e-3 * gscale + 5e-3, (key, err)
        else:
            rel = err / (np.abs(want).max() + 1e-6)
            assert rel < 2e-3 or err < 3e-3 * gscale + 1e-3, (key, err, rel)
    # the front end and both GRU banks are on the gradient's path
    assert all(np.abs(ours[k]).max() > 1e-4 * gscale for k in (
        "spatial_proj.weight", "PReLU_0.negative_slope", "cruse.ggru.bank1.w_hh", "cruse.ggru.bank2.w_hh"))


def test_mc_sdnr_takes_the_reference_mic(teacher):
    """The port's ``sdnr`` on a multi-channel batch against the JAX
    package's ``sdnr_loss`` on the reference mic's noisy waveform, on the
    port's enhanced spectrum (1e-5); the JAX step itself cannot broadcast
    [B, M, L] - [B, L]."""
    losses = (("sdnr", 1.0),)
    rng = np.random.default_rng(1)
    jax_model, variables, model = make_mc_pair(rng)
    data = mc_pair_batch(rng, 2, 2400)
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    jcfg = jstep.StepConfig(stft=JaxStftConfig(**STFT), learning_rate=LR, loss_weights=losses)
    cfg = StepConfig(stft=StftConfig(**STFT), learning_rate=LR, loss_weights=losses)
    state = init_train_state(model, cfg, device="cpu")
    _, got, _ = make_loss_gradients(model, cfg)(state.balancer_state,
                                                {k: torch.from_numpy(v) for k, v in data.items()})
    with torch.no_grad():  # the step's enhanced spectrum (training mode: the batch's statistics)
        spec = mc_stft(torch.from_numpy(data["noisy"]), StftConfig(**STFT))
        out = forward_for_model(model)(torch.stack([spec.real, spec.imag], dim=-1), train=True)
    _, fns = jax_loss_fns(jcfg, jb)
    np.testing.assert_allclose(float(got["sdnr"]), float(fns["sdnr"](jnp.asarray(out.numpy()))), rtol=1e-5)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jax.jit(jstep.make_train_step(jax_model, jcfg, jstep.forward_for_model(jax_model)))(
            jax_state(variables, jcfg, losses), jb)


def test_mc_step_refuses_mismatched_batches(teacher):
    model = teacher[2]
    cfg = StepConfig(stft=StftConfig(**STFT))
    state = init_train_state(model, cfg, device="cpu")
    step = make_train_step(model, cfg)
    with pytest.raises(ValueError, match=r"noisy \[B, M, L\] and clean \[B, L\], got \(2, 3, 2400\) and "
                                         r"\(2, 3, 2400\)"):
        step(state, {"noisy": torch.zeros(2, 3, 2400), "clean": torch.zeros(2, 3, 2400)})
    with pytest.raises(ValueError, match=r"the multi-channel adapter takes \[B, M, T, F, 2\]"):
        step(state, {"noisy": torch.zeros(2, 2400), "clean": torch.zeros(2, 2400)})


# ---------------- the trainer ----------------


@pytest.fixture(scope="module")
def trainer_data():
    rng = np.random.default_rng(2)
    train = [mc_pair_batch(rng, 4, SR, 3) for _ in range(2)]
    valid = [{**mc_pair_batch(rng, 2, SR, 3), "name": ["va", "vb"]}]
    return train, valid


@pytest.fixture(scope="module")
def both(trainer_data, tmp_path_factory):
    """Both trainers after 1 epoch of 2 steps and a validation, from the same start."""
    from cruse_tpu.models.cruse import CruseConfig as JaxCruseConfig
    from cruse_tpu.models.mc_cruse import McCruseConfig as JaxMcCruseConfig
    from cruse_tpu.models.mc_cruse import McCruseNet as JaxMcCruseNet
    from cruse_tpu_torch.models import CruseConfig, McCruseConfig

    train, valid = trainer_data
    root = tmp_path_factory.mktemp("mc_trainer")
    trunk = dict(in_freq=161, channels=(4, 8, 8, 16), rnn_groups=4)
    pairs = ((0, 1), (0, 2))
    jax_model = JaxMcCruseNet(JaxMcCruseConfig(mic_pairs=pairs, cruse=JaxCruseConfig(**trunk)))
    jwriter = RecordingWriter()
    jtrainer = JaxTrainer(
        jax_model, jstep.StepConfig(stft=JaxStftConfig(**STFT), learning_rate=LR),
        JaxTrainerConfig(epochs=1, steps_per_epoch=2, save_dir=str(root), experiment_name="jax", metrics=METRICS,
                         visualization_examples=0),
        train_batches=train, validation_batches=valid, rng=jax.random.PRNGKey(0), writer=jwriter,
        example_feat=jnp.zeros((1, 4, jax_model.config.feature_dim), jnp.float32))
    start = jax.tree_util.tree_map(np.asarray, {"params": jtrainer.state.params,
                                                "batch_stats": jtrainer.state.batch_stats})
    jdecisions = record_decisions(jtrainer)
    jtrainer.train()

    model = McCruseNet(McCruseConfig(mic_pairs=pairs, cruse=CruseConfig(**trunk)))
    model.load_state_dict(state_dict_from_flax(start, model), strict=True)
    writer = RecordingWriter()
    trainer = Trainer(model, StepConfig(stft=StftConfig(**STFT), learning_rate=LR),
                      TrainerConfig(epochs=1, steps_per_epoch=2, save_dir=str(root), experiment_name="port",
                                    metrics=METRICS, visualization_examples=0, num_metric_workers=1),
                      train_batches=train, validation_batches=valid, device="cpu", writer=writer)
    decisions = record_decisions(trainer)
    trainer.train()
    return dict(jwriter=jwriter, writer=writer, jdecisions=jdecisions, decisions=decisions, jtrainer=jtrainer,
                trainer=trainer)


def test_mc_trainer_epoch_means_match_jax(both):
    ours, theirs = both["writer"].scalars, both["jwriter"].scalars
    assert ours.keys() == theirs.keys() and len(ours) == 4
    for (tag, epoch), value in theirs.items():
        rtol = 2e-3 if tag == "Train/grad_norm" else 1e-4
        np.testing.assert_allclose(ours[(tag, epoch)], value, rtol=rtol, atol=1e-12, err_msg=f"{tag} {epoch}")


def test_mc_trainer_validation_matches_jax(both):
    ours, theirs = both["writer"].validation, both["jwriter"].validation
    assert ours.keys() == theirs.keys() and len(ours) == len(METRICS)
    for key, values in theirs.items():
        for which in ("Noisy", "Enhanced"):
            np.testing.assert_allclose(ours[key][which], values[which], rtol=1e-3, atol=0, err_msg=f"{key} {which}")
    assert both["decisions"] == both["jdecisions"] == [True]
    np.testing.assert_allclose(both["trainer"].best_score, both["jtrainer"].best_score, rtol=0, atol=1e-3)
    # the noisy side is the reference mic's signal
    enhanced = both["trainer"].enhance(torch.from_numpy(both["jtrainer"].validation_batches[0]["noisy"]))
    assert enhanced.shape == (2, SR)


def test_mc_trainer_ema_checkpoints_resume_and_prefetch(trainer_data, tmp_path):
    """The EMA, the checkpoints, ``-R`` and the prefetcher on multi-channel
    batches: a resumed trainer restores latest bit for bit."""
    train, valid = trainer_data
    cfg = StepConfig(stft=StftConfig(**STFT), learning_rate=LR, ema_decay=0.9)

    def make(resume=False):
        from cruse_tpu_torch.models import CruseConfig, McCruseConfig
        model = McCruseNet(McCruseConfig(mic_pairs=((0, 1), (0, 2)), cruse=CruseConfig(
            in_freq=161, channels=(4, 8, 8, 16), rnn_groups=4)), generator=torch.Generator().manual_seed(4))
        return Trainer(model, cfg, TrainerConfig(epochs=2 if resume else 1, steps_per_epoch=2,
                                                 save_dir=str(tmp_path), experiment_name="mc", metrics=("STOI",),
                                                 visualization_examples=0, num_metric_workers=1),
                       train_batches=PrefetchingLoader(lambda: iter(train), size=2, device="cpu"),
                       validation_batches=valid, device="cpu", writer=False, resume=resume)

    first = make()
    first.train()
    ckpt = first.checkpoints_dir
    assert all((ckpt / n).is_file() for n in ("latest", "best", "model_0001", "model_0001.npz"))
    saved = checkpoint.load_checkpoint(ckpt / "latest")
    assert saved["step"] == 2 and saved["ema"] is not None
    resumed = make(resume=True)
    assert resumed.start_epoch == 2 and resumed.state.step == 2
    for key, value in resumed.state.model.state_dict().items():
        assert torch.equal(value, saved["model"][key]), key
    for got, want in zip(resumed.state.ema, saved["ema"]):
        assert torch.equal(got, want)
    resumed.train()
    assert resumed.state.step == 4 and np.isfinite(resumed.best_score)


# ---------------- the CLI ----------------


@pytest.mark.parametrize("name", ["tiny_mc", "tiny_mc_rir"])
def test_train_cli_runs_the_tiny_mc_configs(tmp_path, monkeypatch, name):
    """``python -m cruse_tpu_torch.train -C configs/<name>.toml --device cpu``
    on the tiny corpus written under a temporary root: one epoch of two
    steps on [4, 3, 16000] batches, validation scored, checkpoints written."""
    from cruse_tpu_torch.train.__main__ import dataset_from, main
    from cruse_tpu_torch.utils.config import load_config

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no TensorBoard writer
    make_tiny_corpus(tmp_path)
    text = open(os.path.join(ROOT, "configs", f"{name}.toml")).read()
    config = tmp_path / f"{name}.toml"
    config.write_text(text.replace("/tmp/corpus", str(tmp_path)))
    trainer = main(["-C", str(config), "--device", "cpu"])
    ckpt = tmp_path / "runs" / name / "checkpoints"
    assert isinstance(trainer.state.model, McCruseNet) and trainer.state.step == 2
    assert all((ckpt / n).is_file() for n in ("latest", "best", "model_0001", "model_0001.npz"))
    log = (tmp_path / "runs" / name / "train.log").read_text()
    assert log.count("composite score") == 1 and "epoch 1 loss_si_snr" in log and "NON-FINITE" not in log
    assert np.isfinite(trainer.best_score)
    ds = dataset_from(load_config(str(config))["train_dataset"], "cpu")
    assert ds._mc_measured == (name == "tiny_mc_rir") and ds.cfg.mc_room == (name == "tiny_mc")
    batch = next(ds.batches(num_batches=1))
    assert batch["noisy"].shape == (4, 3, SR) and batch["clean"].shape == (4, SR)


def test_dataset_from_makes_nested_lists_tuples(corpus):
    from cruse_tpu_torch.train.__main__ import dataset_from

    positions = [[-0.05, 0.0, 0.0], [0.0, 0.0, 0.0], [0.08, 0.0, 0.0]]
    args = {k: list(v) if isinstance(v, tuple) else v for k, v in mc_args(corpus, "room").items()}
    ds = dataset_from({"args": {**args, "mc_array_geometry": "custom", "mc_mic_positions": positions}}, "cpu")
    assert ds.room.mic_positions == tuple(tuple(p) for p in positions)
    assert ds.room.array_geometry == "custom" and ds.cfg.mc_room_t60 == (0.25, 0.6)
