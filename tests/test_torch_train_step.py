"""Port parity: cruse_tpu_torch's MTFAA train step (``make_train_step``) against
``cruse_tpu.train.step.make_train_step``, on the CPU, in float32.

One tiny MTFAA (n_fft 256, 16 bands, channels (8, 8), 2 TFCM layers, window 8,
deep filter on; tests/test_tfcm_train.py's whole-net shape) starts both
packages from the same perturbed variables and takes one step on the same
numpy-seeded batch. The reference runs its kernel-backed TFCM backward and its
flash attention in interpret mode. Tolerances: losses 1e-5 relative; BatchNorm
running statistics 1e-5; gradients per leaf relative 2e-3 or absolute 3e-3 of
the largest gradient + 1e-3 (the bound of tests/test_tfcm_train.py's whole-net
test: through the phase encoder's square root and the spectral loss's power
law, float32 rounding reaches 1e-4 of the largest gradient against a float64
run, and a PReLU input within rounding of zero may take either side), and
their global norm 2e-3 relative; the balancer's averaged norms 1e-4 relative, because the
spectral loss's gradient grows as |S|^-0.7 at small bins, so the 1e-6
differences between the two enhanced spectra move its norm by a few 1e-5 (on
one spectrum the two packages' loss gradients agree to 1e-7).

Updated parameters: Adam's first step is lr * g / (|g| + 1e-8), so a leaf whose
true gradient is zero (a bias that feeds a BatchNorm) moves by +-lr on rounding
noise, and so does any element whose gradient is within the gradients'
tolerance of zero; and where the clipped |g| nears Adam's 1e-8 the step's
size follows |g| itself. Updates are compared where |g| exceeds GRAD_FLOOR of
its leaf's largest and the clipped |g| exceeds ADAM_FLOOR, outside the leaves
whose true gradient is zero, and bounded by lr everywhere.
"""
import dataclasses

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.dsp.stft import stft as jax_stft
from cruse_tpu.losses.balancer import Balancer as JaxBalancer
from cruse_tpu.models import mtfaa as jm
from cruse_tpu.train import step as jstep

from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.models import CruseConfig, CruseNet, MtfaaConfig, MtfaaNet
from cruse_tpu_torch.train.step import (
    AdamState, StepConfig, _adam_update, forward_for_model, init_train_state,
    make_loss_gradients, make_lr, make_train_step)
from cruse_tpu_torch.utils.weights import mtfaa_flax_from_named, state_dict_from_flax
from tests.test_torch_tfcm import perturbed
from tests.test_torch_tfcm_train import flat

TINY = dict(n_fft=256, n_bands=16, channels=(8, 8), band_strides=(2, 2), tfcm_layers=2,
            attention_window=8)
STFT = dict(n_fft=256, hop_length=128)
LR, GRAD_FLOOR, ADAM_FLOOR = 5e-4, 1e-2, 1e-5
ZERO_GRADIENT = ("pconv1_bias", "dw_bias", "enc_conv", "dec_conv")  # biases that feed a BatchNorm


def batch(rng, b=2, n=2048, nan=False):
    clean = (rng.standard_normal((b, n)) * 0.1).astype(np.float32)
    noisy = (clean + 0.05 * rng.standard_normal((b, n))).astype(np.float32)
    if nan:
        noisy[0, 100] = np.nan
    return {"noisy": noisy, "clean": clean}


@pytest.fixture(scope="module")
def one_step():
    """Both packages' state before and after one step on one batch, and the
    gradients of that step."""
    rng = np.random.default_rng(0)
    jax_model = jm.MtfaaNet(jm.MtfaaConfig(tfcm_dw_impl="fused_pallas_interpret",
                                           asa_impl="flash_interpret", **TINY))
    jcfg = jstep.StepConfig(stft=JaxStftConfig(**STFT), learning_rate=LR)
    variables = perturbed(jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 129, 2))), rng)
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    jstate = jstep.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jstep.make_optimizer(jcfg).init(variables["params"]),
        balancer_state=JaxBalancer.make(dict(jcfg.loss_weights)).init_state(),
        step=jnp.zeros((), jnp.int32))
    data = batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    jforward = jstep.forward_for_model(jax_model)
    jnew, jmetrics = jax.jit(jstep.make_train_step(jax_model, jcfg, jforward))(jstate, jbatch)

    model = MtfaaNet(MtfaaConfig(**TINY))
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables), model),
                          strict=True)
    cfg = StepConfig(stft=StftConfig(**STFT), learning_rate=LR)
    state = init_train_state(model, cfg, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads, _, _ = make_loss_gradients(model, cfg)(state.balancer_state, tbatch)
    model.load_state_dict(before)  # the gradient pass moved the running statistics
    new, metrics = make_train_step(model, cfg)(state, tbatch)
    named_grads = {n: g for (n, p), g in zip(model.named_parameters(), grads)}
    return dict(jax_model=jax_model, jcfg=jcfg, jstate=jstate, jnew=jnew, jmetrics=jmetrics,
                jbatch=jbatch, jforward=jforward, model=model, cfg=cfg, new=new, metrics=metrics,
                before=before, grads=named_grads, data=data)


def jax_gradients(s):
    """The reference step's gradients (it returns none): its own pieces in its own order."""
    scfg, jstate, jb = s["jcfg"].stft, s["jstate"], s["jbatch"]
    ri = lambda z: jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)  # noqa: E731
    noisy_ri, clean_spec = ri(jax_stft(jb["noisy"], scfg)), jax_stft(jb["clean"], scfg)
    out, vjp_fn, _ = jax.vjp(lambda p: s["jforward"](p, jstate.batch_stats, noisy_ri), jstate.params,
                             has_aux=True)
    norm = clean_spec.shape[0] * clean_spec.shape[1] * clean_spec.shape[2]
    from cruse_tpu.dsp.stft import istft as jax_istft
    from cruse_tpu.losses.sisnr import si_snr_loss
    from cruse_tpu.losses.spectral import compressed_spectral_loss
    fns = {"si_snr": lambda o: si_snr_loss(jax_istft((o[..., 0], o[..., 1]), scfg,
                                                     length=jb["noisy"].shape[-1]), jb["clean"]),
           "spec": lambda o: compressed_spectral_loss(o, ri(clean_spec)) / norm}
    out_grad, _, _, _ = JaxBalancer.make(dict(s["jcfg"].loss_weights)).output_cotangent(
        fns, out, jstate.balancer_state)
    return vjp_fn(out_grad)[0]


def test_losses_norm_and_balancer_state_match_jax(one_step):
    s = one_step
    for key in ("loss_si_snr", "loss_spec"):
        np.testing.assert_allclose(float(s["metrics"][key]), float(s["jmetrics"][key]), rtol=1e-5)
    np.testing.assert_allclose(float(s["metrics"]["grad_norm"]), float(s["jmetrics"]["grad_norm"]),
                               rtol=2e-3)
    assert float(s["metrics"]["nonfinite_skipped"]) == float(s["jmetrics"]["nonfinite_skipped"]) == 0
    for name in ("si_snr", "spec"):
        for ours, theirs in ((s["new"].balancer_state.total, s["jnew"].balancer_state.total),
                             (s["new"].balancer_state.fix, s["jnew"].balancer_state.fix)):
            np.testing.assert_allclose(float(ours[name]), float(theirs[name]), rtol=1e-4)
    assert s["new"].step == int(s["jnew"].step) == 1 and s["new"].opt_state.count == 1


def test_every_gradient_leaf_matches_jax(one_step):
    ours = flat(mtfaa_flax_from_named(one_step["grads"])["params"])
    theirs = flat(jax.tree_util.tree_map(np.asarray, jax_gradients(one_step)))
    assert ours.keys() == theirs.keys() and len(ours) > 100
    gscale = max(np.abs(v).max() for v in theirs.values())
    for key, want in theirs.items():
        err = np.abs(ours[key] - want).max()
        if key.endswith("bias") and any(name in key for name in ZERO_GRADIENT):
            assert err < 1e-3 * gscale + 5e-3, (key, err)  # zero but for rounding, on both sides
        else:
            rel = err / (np.abs(want).max() + 1e-6)
            assert rel < 2e-3 or err < 3e-3 * gscale + 1e-3, (key, err, rel)


def test_batch_norm_statistics_match_jax(one_step):
    ours = flat(mtfaa_flax_from_named(one_step["model"].state_dict())["batch_stats"])
    theirs = flat(jax.tree_util.tree_map(np.asarray, one_step["jnew"].batch_stats))
    assert ours.keys() == theirs.keys() and len(ours) >= 2 * (4 + 2 * 4 * 2)
    moved = 0
    for key, value in theirs.items():
        np.testing.assert_allclose(ours[key], value, rtol=1e-5, atol=1e-5, err_msg=key)
        moved += np.abs(ours[key] - one_step["before"][key.replace("/", ".")].numpy()).max() > 1e-4
    assert moved > len(ours) // 2


def test_updated_parameters_match_jax(one_step):
    s = one_step
    ours = flat(mtfaa_flax_from_named(s["model"].state_dict())["params"])
    theirs = flat(jax.tree_util.tree_map(np.asarray, s["jnew"].params))
    grads = flat(mtfaa_flax_from_named(s["grads"])["params"])
    clip = min(1.0, s["cfg"].clip_grad_norm / float(s["metrics"]["grad_norm"]))
    compared = 0
    for key, value in theirs.items():
        old = s["before"][key.replace("/", ".")].numpy()
        sure = np.abs(grads[key]) > max(GRAD_FLOOR * np.abs(grads[key]).max(), ADAM_FLOOR / clip)
        if key.endswith("bias") and any(name in key for name in ZERO_GRADIENT):
            sure[...] = False
        np.testing.assert_allclose(ours[key][sure], value[sure], rtol=0, atol=2e-2 * LR, err_msg=key)
        assert np.abs(ours[key] - old).max() <= LR + 1e-7, key  # 1e-7: the sum's rounding
        assert np.abs(value - old).max() <= LR + 1e-7, key
        compared += int(sure.sum())
    assert compared > 0.5 * sum(v.size for v in theirs.values()), compared


def test_nonfinite_batch_changes_nothing(one_step):
    s = one_step
    model, state = s["model"], s["new"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [m.clone() for m in state.opt_state.mu + state.opt_state.nu]
    bad = {k: torch.from_numpy(v) for k, v in batch(np.random.default_rng(1), nan=True).items()}
    new, metrics = make_train_step(model, s["cfg"])(state, bad)
    assert float(metrics["nonfinite_skipped"]) == 1.0 and not np.isfinite(float(metrics["grad_norm"]))
    assert new.step == state.step + 1 and new.opt_state.count == state.opt_state.count
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key
    for got, want in zip(new.opt_state.mu + new.opt_state.nu, moments):
        assert torch.equal(got, want)
    for name in ("si_snr", "spec"):
        assert torch.equal(new.balancer_state.total[name], state.balancer_state.total[name])


def test_pallas_route_and_full_causal_take_steps(rng):
    """The unfused TFCM route and the full-causal attention (config 5's) through
    the same step: finite losses that agree with the fused route's, since
    the two routes are the same function."""
    data = {k: torch.from_numpy(v) for k, v in batch(rng).items()}
    cfg = StepConfig(stft=StftConfig(**STFT), learning_rate=LR)
    losses = {}
    for impl in ("fused_fold", "pallas", "xla"):
        model = MtfaaNet(MtfaaConfig(tfcm_dw_impl=impl, **{**TINY, "attention_window": None}),
                         generator=torch.Generator().manual_seed(3))
        state = init_train_state(model, cfg, device="cpu")
        state, metrics = make_train_step(model, cfg)(state, data)
        losses[impl] = [float(metrics[k]) for k in ("loss_si_snr", "loss_spec", "grad_norm")]
        assert np.isfinite(losses[impl]).all() and state.opt_state.count == 1
    np.testing.assert_allclose(losses["pallas"], losses["fused_fold"], rtol=1e-4)
    np.testing.assert_allclose(losses["xla"], losses["pallas"], rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=5), dict(lr_schedule="constant"),
                                dict(lr_schedule="cosine", warmup_steps=3, decay_steps=20,
                                     final_lr_scale=0.1),
                                dict(lr_schedule="cosine", decay_steps=2, warmup_steps=4)],
                         ids=["constant", "warmup", "constant_named", "cosine", "cosine_tiny_run"])
def test_learning_rate_schedules_match_optax(kw):
    ours = make_lr(StepConfig(learning_rate=3e-3, **kw))
    theirs = jstep.make_lr(jstep.StepConfig(learning_rate=3e-3, **kw))
    for count in (0, 1, 2, 3, 4, 5, 7, 19, 20, 50):
        want = float(theirs(count)) if callable(theirs) else theirs
        np.testing.assert_allclose(ours(count), want, rtol=1e-6, atol=1e-12)


def test_adam_and_clip_match_optax_over_steps(rng):
    """Three updates from the same gradients, the second one clipped: the
    written-out clip and Adam against optax's chain."""
    cfg = StepConfig(learning_rate=1e-2, clip_grad_norm=1.0, warmup_steps=2)
    tx = jstep.make_optimizer(jstep.StepConfig(learning_rate=1e-2, clip_grad_norm=1.0, warmup_steps=2))
    shapes = [(3, 4), (5,), ()]
    values = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jparams = [jnp.asarray(v) for v in values]
    jopt = tx.init(jparams)
    params = [torch.from_numpy(np.array(v)) for v in values]
    opt = AdamState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])
    lr_at = make_lr(cfg)
    for scale in (0.1, 5.0, 0.3):
        grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
        updates, jopt = tx.update([jnp.asarray(g) for g in grads], jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = [torch.from_numpy(np.array(g)) for g in grads]
        norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
        if norm >= cfg.clip_grad_norm:
            torch._foreach_mul_(tg, cfg.clip_grad_norm / norm)
        _adam_update(params, tg, opt, cfg, lr_at(opt.count))
        for ours, theirs in zip(params, jparams):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-7)
    assert opt.count == 3


@pytest.mark.parametrize("kw,match", [
    (dict(weight_decay=0.01), "weight_decay"), (dict(freeze=("enc",)), "freeze"),
    (dict(remat="dots"), "remat"), (dict(compute_dtype="bfloat16"), "compute_dtype"),
    (dict(ema_decay=0.999), "ema_decay"), (dict(grad_accum_steps=2), "grad_accum_steps"),
    (dict(flatten_optimizer=True), "flatten_optimizer"),
    (dict(loss_weights=(("pmsqe", 1.0),)), "pmsqe"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_unported_step_options_raise_by_name(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        StepConfig(**kw)


def test_unported_entry_points_raise_by_name(monkeypatch):
    model = MtfaaNet(MtfaaConfig(**TINY))
    cfg = StepConfig(stft=StftConfig(**STFT))
    with pytest.raises(NotImplementedError, match="teacher"):
        make_train_step(model, cfg, teacher=(None, None))
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        StepConfig(lr_schedule="linear")
    with pytest.raises(ValueError, match="decay_steps"):
        StepConfig(lr_schedule="cosine")
    state = init_train_state(model, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-channel"):
        make_train_step(model, cfg)(state, {"noisy": torch.zeros(1, 2, 2048), "clean": torch.zeros(1, 2048)})
    other = MtfaaNet(MtfaaConfig(**TINY))
    with pytest.raises(ValueError, match="another model"):
        make_train_step(other, cfg)(state, {"noisy": torch.zeros(1, 2048), "clean": torch.zeros(1, 2048)})
    cruse = CruseNet(CruseConfig(), generator=torch.Generator().manual_seed(0)).train()
    with pytest.raises(NotImplementedError, match="CruseNet"):
        forward_for_model(cruse)(torch.zeros(1, 4, 161, 2), train=True)
    # the train step runs on the card unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(model, cfg)
    assert dataclasses.replace(cfg, learning_rate=1e-3).learning_rate == 1e-3
