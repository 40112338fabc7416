"""Port parity: cruse_tpu_torch's CRUSE and CRUSE+DF train steps
(``make_train_step``, config 2's step and config 3's model) against
``cruse_tpu.train.step.make_train_step``, on the CPU, in float32.

Small CRUSE trunks (in_freq 161, channels (4, 8, 8, 16), 4 GRU groups; both
decoder modes) and a small deep-filter head (24 bins, t=1, f=1) start both
packages from the same variables, BatchNorm statistics moved off their
defaults, and take one step on the same numpy-seeded batch. On the CPU the
port's GRU recurrence runs its ``autograd.Function`` with the plain backward,
and the deep filter its Function with the plain backward.

Tolerances: losses 1e-5 relative; the BatchNorm running statistics 1e-6
(flax and the port both move them with the batch's biased variance; torch's
own ``nn.BatchNorm2d`` would take the unbiased one and miss by far more);
gradients per leaf relative 2e-3 or absolute 3e-3 of the largest gradient +
1e-3, their norm 2e-3, and the updated parameters where the gradient is
clearly away from zero within 2e-2 lr: the bounds of
``tests/test_torch_train_step.py``, whose docstring gives the reasons. Conv
biases that feed a BatchNorm have a zero gradient but for rounding.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.dsp.stft import istft as jax_istft
from cruse_tpu.dsp.stft import stft as jax_stft
from cruse_tpu.losses.balancer import Balancer as JaxBalancer
from cruse_tpu.losses.sisnr import si_snr_loss
from cruse_tpu.losses.spectral import compressed_spectral_loss
from cruse_tpu.models import CruseConfig as JaxCruseConfig
from cruse_tpu.models import CruseNet as JaxCruseNet
from cruse_tpu.models.cruse_df import CruseDfConfig as JaxCruseDfConfig
from cruse_tpu.models.cruse_df import CruseDfNet as JaxCruseDfNet
from cruse_tpu.train import step as jstep

from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.models import CruseConfig, CruseDfConfig, CruseDfNet, CruseNet
from cruse_tpu_torch.nn.conv import BatchNorm2d
from cruse_tpu_torch.ops.deep_filter_kernel import deep_filter, deep_filter_bwd
from cruse_tpu_torch.ops.gru_kernel import gru_sequence, gru_sequence_bwd
from cruse_tpu_torch.train.step import (
    StepConfig, forward_for_model, init_train_state, make_loss_gradients, make_train_step)
from cruse_tpu_torch.utils.weights import state_dict_from_flax
from tests.test_torch_train_step import ADAM_FLOOR, GRAD_FLOOR, LR, batch

SMALL = dict(in_freq=161, channels=(4, 8, 8, 16), rnn_groups=4)
HEAD = dict(df_bins=24, df_taps_t=1, df_taps_f=1)
STFT = dict(n_fft=320, hop_length=160)
MODELS = ("transposed", "upsample", "cruse_df")


def make_models(kind: str):
    """The JAX model and the port's, in training mode, with the JAX config."""
    trunk = dict(SMALL, decoder_mode="upsample") if kind == "upsample" else SMALL
    if kind == "cruse_df":
        jax_model = JaxCruseDfNet(JaxCruseDfConfig(cruse=JaxCruseConfig(**trunk, emit_features=True), **HEAD))
        return jax_model, CruseDfNet(CruseDfConfig(cruse=CruseConfig(**trunk), **HEAD)).train()
    return JaxCruseNet(JaxCruseConfig(**trunk)), CruseNet(CruseConfig(**trunk)).train()


def zero_gradient(model, name: str) -> bool:
    """A conv bias that feeds a BatchNorm: its gradient is zero but for rounding."""
    for suffix, norm in ((".conv.bias", ".bn"), ("_conv.bias", "_bn")):
        if name.endswith(suffix):
            try:
                return model.get_submodule(name[: -len(suffix)] + norm) is not None
            except AttributeError:
                return False
    return False


@pytest.fixture(scope="module", params=MODELS)
def one_step(request):
    """Both packages' state before and after one step on one batch, and the
    gradients of that step, by the port's parameter names."""
    rng = np.random.default_rng(0)
    jax_model, model = make_models(request.param)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 4, 161), jnp.float32)))
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.2, 0.6, a.shape).astype(np.float32), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    jcfg = jstep.StepConfig(stft=JaxStftConfig(**STFT), learning_rate=LR)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jstate = jstep.TrainState(
        params=jvars["params"], batch_stats=jvars["batch_stats"],
        opt_state=jstep.make_optimizer(jcfg).init(jvars["params"]),
        balancer_state=JaxBalancer.make(dict(jcfg.loss_weights)).init_state(),
        step=jnp.zeros((), jnp.int32))
    data = batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    jforward = jstep.forward_for_model(jax_model)
    jnew, jmetrics = jax.jit(jstep.make_train_step(jax_model, jcfg, jforward))(jstate, jbatch)

    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    cfg = StepConfig(stft=StftConfig(**STFT), learning_rate=LR)
    state = init_train_state(model, cfg, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    launches = gru_sequence.launches, gru_sequence_bwd.launches, deep_filter.launches, deep_filter_bwd.launches
    grads, _, _ = make_loss_gradients(model, cfg)(state.balancer_state, tbatch)
    model.load_state_dict(before)  # the gradient pass moved the running statistics
    new, metrics = make_train_step(model, cfg)(state, tbatch)
    assert (gru_sequence.launches, gru_sequence_bwd.launches, deep_filter.launches,
            deep_filter_bwd.launches) == launches  # the CPU route launches nothing
    named_grads = {n: g for (n, _), g in zip(model.named_parameters(), grads)}
    return dict(kind=request.param, jax_model=jax_model, jcfg=jcfg, jstate=jstate, jnew=jnew,
                jmetrics=jmetrics, jbatch=jbatch, jforward=jforward, model=model, cfg=cfg, new=new,
                metrics=metrics, before=before, grads=named_grads, data=data)


def to_torch_names(s, tree, collection="params"):
    """A flax tree (gradients, parameters or statistics) in the port's names and layouts."""
    return {k: v.numpy() for k, v in state_dict_from_flax(
        {collection: jax.tree_util.tree_map(np.asarray, tree)}, s["model"]).items()
        if not k.endswith("num_batches_tracked")}


def jax_gradients(s):
    """The reference step's gradients (it returns none): its own pieces in its own order."""
    scfg, jstate, jb = s["jcfg"].stft, s["jstate"], s["jbatch"]
    ri = lambda z: jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)  # noqa: E731
    noisy_ri, clean_spec = ri(jax_stft(jb["noisy"], scfg)), jax_stft(jb["clean"], scfg)
    out, vjp_fn, _ = jax.vjp(lambda p: s["jforward"](p, jstate.batch_stats, noisy_ri), jstate.params,
                             has_aux=True)
    norm = clean_spec.shape[0] * clean_spec.shape[1] * clean_spec.shape[2]
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
    ours = {k: v.numpy() for k, v in one_step["grads"].items()}
    theirs = to_torch_names(one_step, jax_gradients(one_step))
    assert ours.keys() == theirs.keys() and len(ours) > 20
    gscale = max(np.abs(v).max() for v in theirs.values())
    for key, want in theirs.items():
        err = np.abs(ours[key] - want).max()
        if zero_gradient(one_step["model"], key):
            assert err < 1e-3 * gscale + 5e-3, (key, err)  # zero but for rounding, on both sides
        else:
            rel = err / (np.abs(want).max() + 1e-6)
            assert rel < 2e-3 or err < 3e-3 * gscale + 1e-3, (key, err, rel)
    # the GRU banks' gradients really flow (through the recurrence's backward)
    assert all(np.abs(ours[f"{p}ggru.bank{i}.{w}"]).max() > 1e-4 * gscale
               for p in ("cruse.",) * (one_step["kind"] == "cruse_df") or ("",)
               for i in (1, 2) for w in ("w_hh", "b_hh", "w_ih"))


def test_batch_norm_statistics_match_jax(one_step):
    """The running statistics after one training forward: flax's update, with
    the batch's biased variance, within 1e-6."""
    ours = {k: v.numpy() for k, v in one_step["model"].state_dict().items()
            if k.endswith(("running_mean", "running_var"))}
    theirs = to_torch_names(one_step, one_step["jnew"].batch_stats, "batch_stats")
    assert ours.keys() == theirs.keys() and len(ours) == 2 * (4 + 3)
    for key, value in theirs.items():
        np.testing.assert_allclose(ours[key], value, rtol=1e-6, atol=1e-6, err_msg=key)
        assert np.abs(ours[key] - one_step["before"][key].numpy()).max() > 1e-3, key  # they moved
    tracked = [v for k, v in one_step["model"].state_dict().items() if k.endswith("num_batches_tracked")]
    assert len(tracked) == 7 and all(int(v) == 1 for v in tracked)


def test_updated_parameters_match_jax(one_step):
    s = one_step
    ours = {k: v.numpy() for k, v in s["model"].state_dict().items()}
    theirs = to_torch_names(s, s["jnew"].params)
    grads = {k: v.numpy() for k, v in s["grads"].items()}
    clip = min(1.0, s["cfg"].clip_grad_norm / float(s["metrics"]["grad_norm"]))
    compared = 0
    for key, value in theirs.items():
        old = s["before"][key].numpy()
        sure = np.abs(grads[key]) > max(GRAD_FLOOR * np.abs(grads[key]).max(), ADAM_FLOOR / clip)
        if zero_gradient(s["model"], key):
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


@pytest.mark.parametrize("kind", MODELS)
def test_a_train_flag_against_the_mode_raises(kind):
    _, model = make_models(kind)
    feat = torch.rand(1, 4, 161)
    with pytest.raises(ValueError, match=r"train=False .* training mode"):
        model(feat)
    with pytest.raises(ValueError, match=r"train=True .* eval mode"):
        model.eval()(feat, None, True)
    with pytest.raises(ValueError, match="eval mode"):  # the adapter's own check
        forward_for_model(model.train())(torch.rand(1, 4, 161, 2), train=False)
    with torch.no_grad():
        out, _ = model.eval()(feat)
        assert (out[0] if kind == "cruse_df" else out).shape == (1, 4, 161)


@pytest.mark.parametrize("shape", [(3, 4, 5, 7), (2, 1, 1, 3)])
def test_batch_norm_training_matches_flax(rng, shape):
    """BatchNorm2d's training forward against flax's nn.BatchNorm(momentum
    0.9): output 1e-5, running statistics 1e-6, from non-default statistics
    and affine; torch's own module moves running_var with the unbiased
    variance and misses."""
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)  # NCHW
    c = shape[1]
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.standard_normal(c).astype(np.float32)
    mean, var = rng.standard_normal(c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xj = jnp.asarray(np.moveaxis(x, 1, -1))  # NHWC
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    yj, new = bn.apply(variables, xj, mutable=["batch_stats"])
    ours = BatchNorm2d(c, eps=1e-5)
    plain = torch.nn.BatchNorm2d(c, eps=1e-5)
    for m in (ours, plain):
        m.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                           "running_mean": torch.from_numpy(mean), "running_var": torch.from_numpy(var),
                           "num_batches_tracked": torch.tensor(0)})
    y = ours.train()(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.moveaxis(np.asarray(yj), -1, 1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(new["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(), np.asarray(new["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    assert int(ours.num_batches_tracked) == 1
    plain.train()(torch.from_numpy(x))
    assert np.abs(plain.running_var.numpy() - np.asarray(new["batch_stats"]["var"])).max() > 1e-4
    plain.load_state_dict(ours.state_dict())
    with torch.no_grad():  # eval mode: torch's, from the running statistics
        torch.testing.assert_close(ours.eval()(torch.from_numpy(x)), plain.eval()(torch.from_numpy(x)))
