"""Port parity: MetricGAN+ in cruse_tpu_torch (``models/bsrnn.py``'s
``Discriminator``, ``SpectralNorm`` and ``batch_quality_scores``;
``train/metricgan.py``; ``[trainer.adversarial]`` in the trainer and the
train CLI) against cruse_tpu, on the CPU, at small widths: ``ndf = 4``, a
CRUSE generator with ``channels=(2, 4, 4, 8)`` (n_fft 320) and a BSRNN one
with ``num_channel = 8``, ``num_layer = 1`` (n_fft 512), 0.3 s clips.

The port's seeded weights (and D's spectral-norm statistics) cross the
bridge to flax; each JAX step is jitted once a generator, in a module
fixture, and the JAX states are built from the bridged trees (no flax
``init``). Tolerances:

- D's output 1e-5, its stored ``u`` and ``sigma`` 1e-5; a spectral-normed
  kernel 1e-6 (flax's arithmetic on one matrix);
- the steps' gradients, every leaf, within test_torch_train_step.py's
  bounds: 2e-3 of the leaf's largest element, or 3e-3 of the largest
  gradient (without that file's 1e-3 absolute floor, which these widths'
  gradients would fall under). The port's are recorded as its steps take
  them (``torch.autograd.grad`` wrapped); JAX's D gradient is its own D
  step's, read from Adam's first moment (``mu = (1 - b1) g``: optax's
  ``adam`` has no clip), and its G gradient is ``jax.grad`` of the G
  step's loss, restated from ``cruse_tpu/train/metricgan.py`` (the step
  returns none), on the bridged trees the port's G step started from;
- the steps' losses 1e-5 relative; D's parameters after its Adam step
  within 5e-2 of the learning rate (Adam's first step is lr * g / (|g| +
  1e-8), so only a gradient within rounding of zero moves it by less than
  lr) and its statistics 1e-5;
- the generator's parameters after its step within 1e-2 of the learning
  rate: the step config clips the gradient's global norm to 1e-8, so that
  Adam's first update, lr * g / (|g| + 1e-8), is near linear in each
  element of the clipped gradient (the clip runs in both packages) and a
  gradient within rounding of zero moves its parameter by nearly nothing,
  not by +-lr;
- the normalized PESQ scores 1e-5 (both packages run the same numpy
  pipeline); D pretraining's mean loss and two alternations' losses 2e-3
  relative, D's first-step updates of a gradient near zero taking either
  sign of lr in each package and moving the later losses by that much.
"""
import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.dsp.stft import istft as jax_istft
from cruse_tpu.dsp.stft import stft as jax_stft
from cruse_tpu.losses.sisnr import si_snr_loss as jax_si_snr_loss
from cruse_tpu.losses.balancer import Balancer as JaxBalancer
from cruse_tpu.models import CruseConfig as JaxCruseConfig
from cruse_tpu.models import CruseNet as JaxCruseNet
from cruse_tpu.models import bsrnn as jb
from cruse_tpu.train import metricgan as jmg
from cruse_tpu.train import step as jstep

from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.models import BSRNN, BsrnnConfig, CruseConfig, CruseNet, Discriminator
from cruse_tpu_torch.models.bsrnn import SpectralNorm, batch_quality_scores
from cruse_tpu_torch.train import metricgan as mg
from cruse_tpu_torch.train.checkpoint import restore_discriminator
from cruse_tpu_torch.train.step import StepConfig
from cruse_tpu_torch.train.trainer import Trainer, TrainerConfig
from cruse_tpu_torch.utils.weights import (discriminator_flax_from_state_dict, discriminator_state_dict_from_flax,
                                           flax_from_state_dict)

NDF, LR, DISC_LR, ADV = 4, 1e-3, 1e-3, 0.5
LOSS_RTOL, D_OUT_TOL, RUN_RTOL = 1e-5, 1e-5, 2e-3
SAMPLES = 4800
CRUSE = dict(in_freq=161, channels=(2, 4, 4, 8), rnn_groups=4)
GENERATORS = {"cruse": dict(n_fft=320, hop_length=160), "bsrnn": dict(n_fft=512, hop_length=256)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def speech(rng, b, n=SAMPLES, snr_noise=0.05):
    """Harmonic, amplitude-modulated clips (which PESQ scores sensibly) and
    their noisy mixtures, float32."""
    t = np.arange(n) / 16000
    f0 = rng.uniform(120, 260, (b, 1))
    clean = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    clean = 0.2 * clean * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 5, (b, 1)) * t))
    noisy = clean + snr_noise * rng.standard_normal((b, n))
    return {"noisy": noisy.astype(np.float32), "clean": clean.astype(np.float32)}


def make_generators(name: str):
    """(the JAX generator, the port's, seeded) of one family."""
    if name == "cruse":
        return JaxCruseNet(JaxCruseConfig(**CRUSE)), CruseNet(CruseConfig(**CRUSE),
                                                              generator=torch.Generator().manual_seed(3))
    model = BSRNN(BsrnnConfig(8, 1, False), generator=torch.Generator().manual_seed(4))
    return jb.BSRNN(num_channel=8, num_layer=1), model


def configs(name: str):
    scfg = GENERATORS[name]
    # a clip of 1e-8 keeps Adam's first update near linear in the gradient (see the module doc)
    port = mg.MetricGanConfig(step=StepConfig(stft=StftConfig(**scfg), learning_rate=LR, clip_grad_norm=1e-8),
                              disc_lr=DISC_LR, adv_weight=ADV, ndf=NDF)
    jax_cfg = jmg.MetricGanConfig(step=jstep.StepConfig(stft=JaxStftConfig(**scfg), learning_rate=LR,
                                                        clip_grad_norm=1e-8),
                                  disc_lr=DISC_LR, adv_weight=ADV, ndf=NDF)
    return port, jax_cfg


def jax_state(jcfg, gen_vars, disc_vars):
    """The JAX package's MetricGanState on bridged trees, as its
    ``init_metricgan_state`` lays it out."""
    params = jax.tree_util.tree_map(jnp.asarray, gen_vars["params"])
    gen = jstep.TrainState(params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray, gen_vars.get("batch_stats", {})),
                           opt_state=jstep.make_optimizer(jcfg.step).init(params),
                           balancer_state=JaxBalancer.make(dict(jcfg.step.loss_weights)).init_state(),
                           step=jnp.zeros((), jnp.int32))
    dparams = jax.tree_util.tree_map(jnp.asarray, disc_vars["params"])
    return jmg.MetricGanState(gen=gen, disc_params=dparams,
                              disc_stats=jax.tree_util.tree_map(jnp.asarray, disc_vars["batch_stats"]),
                              disc_opt=optax.adam(jcfg.disc_lr).init(dparams))


def fresh(name: str):
    """Both packages' MetricGAN+ states from the same seeded weights, and
    the port's steps."""
    jax_gen, gen = make_generators(name)
    disc = Discriminator(NDF, generator=torch.Generator().manual_seed(5))
    cfg, jcfg = configs(name)
    gen_vars = flax_from_state_dict(gen)
    gen_vars = jax.tree_util.tree_map(np.array, gen_vars)  # copies: the port updates its module in place
    jstate = jax_state(jcfg, gen_vars, discriminator_flax_from_state_dict(disc.state_dict()))
    state = mg.init_metricgan_state(gen, disc, cfg, "cpu")
    return dict(state=state, steps=mg.make_metricgan_steps(gen, disc, cfg), jstate=jstate, jax_gen=jax_gen,
                gen=gen, disc=disc)


def flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def tree_err(ours, theirs) -> float:
    errs = jax.tree_util.tree_map(lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()), ours,
                                  jax.tree_util.tree_map(np.asarray, theirs))
    return max(jax.tree_util.tree_leaves(errs))


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_steps(name: str):
    """The JAX package's (enhance, disc_step, gen_step) of one generator,
    made once, so that each is compiled once."""
    return jmg.make_metricgan_steps(make_generators(name)[0], jb.Discriminator(ndf=NDF), configs(name)[1])


@functools.lru_cache(maxsize=None)
def jax_gen_gradients(name: str):
    """``jax.grad`` of the JAX G step's loss (``gen_step``'s ``loss_fn``,
    restated: si_snr + ADV * the adversarial term, D not updated), the
    generator's parameters and statistics and D's variables arguments;
    jitted once a generator."""
    scfg = configs(name)[1].step.stft
    forward = jstep.forward_for_model(make_generators(name)[0])
    disc = jb.Discriminator(ndf=NDF)

    def mags(wav):
        return jnp.abs(jax_stft(wav, scfg))

    def loss(params, batch_stats, disc_vars, noisy, clean):
        spec = jax_stft(noisy, scfg)
        out, _ = forward(params, batch_stats, jnp.stack([jnp.real(spec), jnp.imag(spec)], axis=-1), True)
        enhanced = jax_istft((out[..., 0], out[..., 1]), scfg, length=noisy.shape[-1])
        adv = jnp.mean(jnp.square(disc.apply(disc_vars, mags(clean), mags(enhanced)) - 1.0))
        return jax_si_snr_loss(enhanced, clean) + ADV * adv

    return jax.jit(jax.grad(loss))


@contextlib.contextmanager
def recorded_grads():
    """Every ``torch.autograd.grad`` result while the block runs, in order,
    copied (the G step clips its gradients in place)."""
    grad, got = torch.autograd.grad, []

    def recording(*args, **kwargs):
        out = grad(*args, **kwargs)
        got.append([None if g is None else g.detach().clone() for g in out])
        return out

    torch.autograd.grad = recording
    try:
        yield got
    finally:
        torch.autograd.grad = grad


@pytest.fixture(scope="module", params=list(GENERATORS))
def one_round(request):
    """Per generator: both packages' enhance, one D step on injected scores
    (both on the port's enhanced waveform), one G step, from the same
    weights, and both packages' gradients of each step; the JAX steps
    compiled once."""
    name = request.param
    made = fresh(name)
    jsteps = jax_steps(name)
    data = speech(np.random.default_rng(21), 2)
    scores = np.asarray([0.35, 0.62], np.float32)
    state, steps, jstate = made["state"], made["steps"], made["jstate"]
    enhanced = steps[0](state, torch.from_numpy(data["noisy"]))
    # JAX's enhance is compiled for the CRUSE generator alone (its alternations need it); the BSRNN
    # generator's is the port's waveform
    jenhanced = jsteps[0](jstate, jnp.asarray(data["noisy"])) if name == "cruse" else jnp.asarray(enhanced.numpy())
    disc_before = discriminator_flax_from_state_dict(made["disc"].state_dict())
    with recorded_grads() as grads:
        state, d_metrics = steps[1](state, torch.from_numpy(data["clean"]), enhanced, torch.from_numpy(scores))
        jstate, jd_metrics = jsteps[1](jstate, jnp.asarray(data["clean"]), jnp.asarray(enhanced.numpy()),
                                       jnp.asarray(scores))
        disc_after = discriminator_flax_from_state_dict(made["disc"].state_dict())
        gen_before = jax.tree_util.tree_map(np.array, flax_from_state_dict(made["gen"]))
        state, g_metrics = steps[2](state, as_torch(data))
    jstate, jg_metrics = jsteps[2](jstate, as_jax(data))
    d_names = [n for n, _ in made["disc"].named_parameters()]
    g_names = [n for n, p in made["gen"].named_parameters() if p.requires_grad]
    d_grads = (discriminator_flax_from_state_dict(dict(zip(d_names, grads[0])))["params"],
               jax.tree_util.tree_map(lambda mu: np.asarray(mu) / 0.1, jstate.disc_opt[0].mu))  # b1 = 0.9
    g_grads = (flax_from_state_dict(made["gen"], dict(zip(g_names, grads[1])))["params"],
               jax_gen_gradients(name)(gen_before["params"], gen_before.get("batch_stats", {}), disc_after,
                                       jnp.asarray(data["noisy"]), jnp.asarray(data["clean"])))
    return dict(name=name, enhanced=(enhanced.numpy(), np.asarray(jenhanced)), disc_before=disc_before,
                disc_after=disc_after, d_metrics=d_metrics, jd_metrics=jd_metrics, gen_before=gen_before,
                gen_after=flax_from_state_dict(made["gen"]), g_metrics=g_metrics, jg_metrics=jg_metrics,
                jstate=jstate, state=state, grads={"disc": d_grads, "gen": g_grads})


# ---------------- the discriminator ----------------


@pytest.mark.parametrize("kind", ["conv", "dense"])
@pytest.mark.parametrize("update_stats", [False, True], ids=["eval", "update"])
def test_spectral_norm_matches_flax(kind, update_stats):
    """One power iteration from the stored u, on a conv kernel (HWIO in
    flax, which its SpectralNorm takes as [-1, out]; OIHW here) and on a
    Dense kernel: the normed kernel, and u and sigma stored only under
    update_stats. flax's side is a bias-free Dense on that [-1, out] matrix,
    fed the identity, so that its output is the normed matrix itself."""
    import flax.linen as fnn

    class Normed(fnn.Module):
        @fnn.compact
        def __call__(self, x, train):
            return fnn.SpectralNorm(fnn.Dense(5, use_bias=False))(x, update_stats=train)

    rng = np.random.default_rng(7)
    kernel = rng.standard_normal((4, 4, 3, 5) if kind == "conv" else (6, 5)).astype(np.float32)
    u0 = rng.standard_normal((1, 5)).astype(np.float32)
    matrix = kernel.reshape(-1, 5)
    variables = {"params": {"Dense_0": {"kernel": jnp.asarray(matrix)}},
                 "batch_stats": {"SpectralNorm_0": {"Dense_0/kernel/u": jnp.asarray(u0),
                                                    "Dense_0/kernel/sigma": jnp.ones(())}}}
    want, new = Normed().apply(variables, jnp.eye(matrix.shape[0]), update_stats, mutable=["batch_stats"])
    stats = new["batch_stats"]["SpectralNorm_0"]
    weight = np.transpose(kernel, (3, 2, 0, 1)) if kind == "conv" else kernel.T  # the port's layout
    norm = SpectralNorm(5, torch.Generator().manual_seed(0))
    with torch.no_grad():
        norm.u.copy_(torch.from_numpy(u0))
    normed = norm(torch.from_numpy(np.ascontiguousarray(weight)), update_stats).numpy()
    back = np.transpose(normed, (2, 3, 1, 0)).reshape(-1, 5) if kind == "conv" else normed.T
    np.testing.assert_allclose(back, np.asarray(want), atol=1e-6)
    if update_stats:
        np.testing.assert_allclose(norm.u.numpy(), np.asarray(stats["Dense_0/kernel/u"]), atol=1e-6)
        np.testing.assert_allclose(float(norm.sigma), float(stats["Dense_0/kernel/sigma"]), rtol=1e-6)
        assert float(norm.sigma) != 1.0
    else:
        assert np.array_equal(norm.u.numpy(), u0) and float(norm.sigma) == 1.0
        assert np.array_equal(np.asarray(stats["Dense_0/kernel/u"]), u0)


@pytest.mark.parametrize("update_stats", [False, True], ids=["eval", "update"])
def test_discriminator_matches_jax(update_stats):
    """D's output on random magnitudes and, with update_stats, every stored u
    and sigma, against ``Discriminator.apply`` on the bridged variables."""
    rng = np.random.default_rng(8)
    disc = Discriminator(NDF, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        for name, p in disc.named_parameters():
            if name.endswith(("negative_slope", "slope", "bias")):
                p.add_(torch.from_numpy(np.asarray(rng.standard_normal(tuple(p.shape)) * 0.1, np.float32)))
    variables = discriminator_flax_from_state_dict(disc.state_dict())
    x, y = (np.abs(rng.standard_normal((3, 31, 161))).astype(np.float32) for _ in range(2))
    apply = jax.jit(functools.partial(jb.Discriminator(ndf=NDF).apply, mutable=["batch_stats"]), static_argnums=3)
    out, new = apply(variables, jnp.asarray(x), jnp.asarray(y), update_stats)
    got = disc(torch.from_numpy(x), torch.from_numpy(y), update_stats)
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=D_OUT_TOL)
    stats = discriminator_flax_from_state_dict(disc.state_dict())["batch_stats"]
    assert tree_err(stats, dict(new["batch_stats"])) < D_OUT_TOL
    assert (tree_err(stats, variables["batch_stats"]) > 1e-3) == update_stats
    # the bridge both ways is the identity
    back = discriminator_state_dict_from_flax(discriminator_flax_from_state_dict(disc.state_dict()))
    assert all(torch.equal(back[k], v) for k, v in disc.state_dict().items()) and back.keys() == disc.state_dict().keys()


# ---------------- the steps ----------------


def test_enhance_and_disc_step_match_jax(one_round):
    r = one_round
    np.testing.assert_allclose(*r["enhanced"], atol=1e-5)  # the BSRNN case: the same waveform in both
    np.testing.assert_allclose(float(r["d_metrics"]["disc_loss"]), float(r["jd_metrics"]["disc_loss"]),
                               rtol=LOSS_RTOL)
    assert tree_err(r["disc_after"]["params"], r["jstate"].disc_params) < 5e-2 * DISC_LR
    assert tree_err(r["disc_after"]["batch_stats"], dict(r["jstate"].disc_stats)) < D_OUT_TOL
    # both moved: the parameters by Adam's first step, the statistics by the two stored iterations
    assert tree_err(r["disc_after"]["params"], r["disc_before"]["params"]) > 0.5 * DISC_LR
    assert tree_err(r["disc_after"]["batch_stats"], r["disc_before"]["batch_stats"]) > 0


def test_gen_step_matches_jax(one_round):
    """The G step's three losses and every updated generator leaf."""
    r = one_round
    for key in ("gen_loss", "task_loss", "adv_loss"):
        np.testing.assert_allclose(float(r["g_metrics"][key]), float(r["jg_metrics"][key]), rtol=LOSS_RTOL)
    assert tree_err(r["gen_after"]["params"], r["jstate"].gen.params) < 1e-2 * LR
    assert tree_err(r["gen_after"]["params"], r["gen_before"]["params"]) > 1e-2 * LR
    assert r["state"].gen.step == 1 and int(r["jstate"].gen.step) == 1
    if r["name"] == "cruse":  # the training forward moved the BatchNorm statistics
        assert tree_err(r["gen_after"]["batch_stats"], r["jstate"].gen.batch_stats) < 1e-5


@pytest.mark.parametrize("net", ["disc", "gen"])
def test_step_gradients_match_jax(one_round, net):
    """Every gradient leaf of the D step and of the G step (see the module
    doc for where each package's comes from)."""
    ours, theirs = (flat(tree) for tree in one_round["grads"][net])
    assert ours.keys() == theirs.keys() and len(ours) >= (11 if net == "disc" else 8)
    gscale = max(np.abs(v).max() for v in theirs.values())
    assert gscale > 0
    for key, want in theirs.items():
        err = np.abs(ours[key] - want).max()
        rel = err / (np.abs(want).max() + 1e-30)
        assert rel < 2e-3 or err < 3e-3 * gscale, (key, err, rel, gscale)


# ---------------- the helpers ----------------


def test_replay_buffer_bounds_and_draws_match_jax():
    ours, theirs = mg.ReplayBuffer(capacity=3, seed=4), jmg.ReplayBuffer(capacity=3, seed=4)
    assert ours.sample() is None and theirs.sample() is None
    for i in range(5):
        c, e = np.full((1, 8), i, np.float32), np.full((1, 8), -i, np.float32)
        ours.add(torch.from_numpy(c), torch.from_numpy(e), [i / 5])
        theirs.add(c, e, [i / 5])
    assert len(ours) == len(theirs) == 3
    for _ in range(12):
        (c, e, s), (jc, je, js) = ours.sample(), theirs.sample()
        assert c[0, 0] >= 2 and np.array_equal(c, jc) and np.array_equal(e, je) and np.array_equal(s, js)
        assert isinstance(c, np.ndarray) and s.dtype == np.float32


def test_batch_quality_scores_match_jax():
    data = speech(np.random.default_rng(12), 2, 8000)
    ours = batch_quality_scores(list(data["clean"]), list(data["noisy"]))
    theirs = jb.batch_quality_scores(list(data["clean"]), list(data["noisy"]))
    assert ours.dtype == np.float32 and ours.shape == (2,)
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    assert 0.3 < ours.min() and ours.max() < 1.0


def test_pretraining_and_alternations_match_jax():
    """From fresh states (the CRUSE generator; its JAX steps reused):
    D pretraining on two scored batches, then two ``metricgan_train_batch``
    alternations with replay (capacity 2, seed 0), against JAX's."""
    made = fresh("cruse")
    jsteps = jax_steps("cruse")
    rng = np.random.default_rng(31)
    pre = [speech(rng, 2, snr_noise=s) for s in (0.02, 0.2)]
    replay, jreplay = mg.ReplayBuffer(capacity=2), jmg.ReplayBuffer(capacity=2)
    state, loss = mg.pretrain_discriminator(made["state"], made["steps"], [as_torch(b) for b in pre],
                                            replay=replay)
    jstate, jloss = jmg.pretrain_discriminator(made["jstate"], jsteps, [as_jax(b) for b in pre], replay=jreplay)
    assert np.isfinite(loss) and len(replay) == len(jreplay) == 2
    np.testing.assert_allclose(loss, jloss, rtol=RUN_RTOL)
    for i in range(2):
        batch = speech(rng, 2)
        state, metrics = mg.metricgan_train_batch(state, as_torch(batch), made["steps"], replay=replay)
        jstate, jmetrics = jmg.metricgan_train_batch(jstate, as_jax(batch), jsteps, replay=jreplay)
        assert metrics.keys() == jmetrics.keys() == {"disc_loss", "gen_loss", "task_loss", "adv_loss"}
        for key in metrics:
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=RUN_RTOL, err_msg=(i, key))
    assert state.gen.step == 2 and len(replay) == 2


# ---------------- the trainer and the CLI ----------------


ADVERSARIAL = {"adv_weight": 0.5, "disc_lr": 1e-4, "ndf": NDF, "replay_capacity": 4, "pretrain_steps": 1}


def port_trainer(root, epochs, resume=False, batches=None):
    rng = np.random.default_rng(0)
    train = batches or [speech(rng, 2) for _ in range(2)]
    valid = [{**speech(rng, 2), "name": ["a", "b"]}]
    model = CruseNet(CruseConfig(**CRUSE), generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, StepConfig(stft=StftConfig(n_fft=320, hop_length=160), learning_rate=1e-3),
                      TrainerConfig(epochs=epochs, steps_per_epoch=2, save_dir=str(root), experiment_name="gan",
                                    metrics=("STOI", "SI_SDR"), visualization_examples=0, num_metric_workers=1,
                                    adversarial=ADVERSARIAL),
                      train_batches=train, validation_batches=valid, resume=resume, device="cpu", writer=False)
    return trainer, train


def test_trainer_adversarial_mode_and_resume(tmp_path):
    """``[trainer.adversarial]`` through the Trainer: D pretrains once, both
    nets move, ``disc_latest`` is written beside ``latest``; a resumed
    trainer restores D (its parameters, statistics and Adam state) and skips
    the pretraining, as the JAX package's test_trainer_adversarial_mode
    checks its own."""
    trainer, train = port_trainer(tmp_path, 2)
    assert trainer._adv["pretrained"] is False
    g0 = [p.detach().clone() for p in trainer.model.parameters()]
    d0 = [p.detach().clone() for p in trainer._adv["disc"].parameters()]
    trainer.train()
    ckpt = tmp_path / "gan" / "checkpoints"
    assert (ckpt / "latest").is_file() and (ckpt / "disc_latest").is_file()
    assert trainer._adv["pretrained"] is True and trainer.state.step == 4
    assert all(not torch.equal(a, p) for a, p in zip(g0, trainer.model.parameters()))
    assert any(not torch.equal(a, p) for a, p in zip(d0, trainer._adv["disc"].parameters()))
    assert trainer._adv["disc_opt"].count == 1 + 2 * 2 * 2  # the pretraining batch, then fresh + replayed a batch

    resumed, _ = port_trainer(tmp_path, 3, resume=True, batches=train)
    assert resumed.start_epoch == 3 and resumed._adv["pretrained"] is True
    for name, value in trainer._adv["disc"].state_dict().items():
        assert torch.equal(resumed._adv["disc"].state_dict()[name], value), name
    assert resumed._adv["disc_opt"].count == trainer._adv["disc_opt"].count
    assert all(torch.equal(a, b) for a, b in zip(resumed._adv["disc_opt"].nu, trainer._adv["disc_opt"].nu))
    restored = Discriminator(NDF)
    opt = mg.disc_adam_state(restored)
    restore_discriminator(ckpt, restored, opt)
    assert all(torch.equal(a, b) for a, b in zip(restored.parameters(), trainer._adv["disc"].parameters()))


def test_train_cli_runs_tiny_bsrnn_gan(tmp_path, monkeypatch):
    """``python -m cruse_tpu_torch.train -C configs/tiny_bsrnn_gan.toml
    --device cpu`` (its main, the corpus in a temporary directory): D
    pretrains on 2 batches, one epoch of 2 alternations, finite G and D
    losses in the epoch log, ``disc_latest`` beside ``latest``."""
    from cruse_tpu_torch.train.__main__ import main
    from tests.test_torch_bsrnn_train import write_config
    from tests.test_torch_trainer import write_corpus

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no TensorBoard writer
    write_corpus(tmp_path)
    trainer = main(["-C", str(write_config(tmp_path, "tiny_bsrnn_gan.toml")), "--device", "cpu"])
    run = tmp_path / "runs" / "tiny_bsrnn_gan"
    assert isinstance(trainer.state.model, BSRNN) and trainer.state.step == 2
    assert all((run / "checkpoints" / n).is_file() for n in ("latest", "disc_latest", "model_0001.npz"))
    log = (run / "train.log").read_text()
    assert "D pretraining (2 metric-scored batches)" in log and "adversarial (MetricGAN+)" in log
    for key in ("disc_loss", "gen_loss", "task_loss", "adv_loss"):
        assert f"epoch 1 {key}" in log, key
    assert "NON-FINITE" not in log and log.count("composite score") == 1


def test_mesh_with_adversarial_is_refused():
    model = CruseNet(CruseConfig(**CRUSE))
    with pytest.raises(NotImplementedError, match="mesh.*adversarial"):
        Trainer(model, StepConfig(), TrainerConfig(adversarial=ADVERSARIAL), device="cpu", mesh=object())
