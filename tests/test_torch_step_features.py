"""Port parity: the train step's features -- AdamW with its >=2-D mask,
``freeze``, gradient accumulation (optax's ``MultiSteps``), the EMA of the
parameters, distillation from a frozen teacher and every loss of the step --
and DFSMN training, against ``cruse_tpu.train.step``, on the CPU, in float32.

1. The optimiser alone: the same gradients, in the flax layout and bridged to
   the port's, through the port's step (its loss pass replaced by those
   gradients) and through the JAX package's ``make_optimizer`` chain, over
   six steps: parameters, moments, accumulator and EMA within 1e-5 relative
   + 3e-6 (5e-5 of six steps of lr 1e-2: optax takes Adam's bias correction
   ``1 - beta2^count`` in float32, 3e-5 off at count 2 by cancellation, where
   the port takes it in float64; each update moves by up to 2e-5 of itself).
2. Four featured steps of a small CRUSE (in_freq 33, channels (2, 4), 2 GRU
   groups, n_fft 64) taught by a small CRUSE+DF (8 deep-filter bins), all
   eight losses weighted, AdamW, ``freeze=("enc_0",)``, k = 2 and an EMA,
   against JAX's ``make_train_step`` jitted once in a module fixture, both
   from the same variables on the same batches. Steps 1 and 2 run the same
   parameters, so their losses agree within 1e-5 relative and their
   gradient norms within 2e-3 (the bounds of tests/test_torch_cruse_train.py);
   after step 1 the accumulator holds the step's gradients, held leaf by
   leaf within that file's gradient bounds (relative 2e-3, or 3e-3 of the
   largest gradient + 1e-5; a conv bias that feeds a BatchNorm has a zero
   gradient but for rounding). Steps 3 and 4 run parameters that one update
   has moved apart by Adam's noise at near-zero gradients (an element within
   rounding of a zero gradient takes Adam's full step either way): their
   losses agree within 1e-3 relative. After step 4, two updates: every
   parameter and EMA element within 2 (lr + lr wd |p|) of JAX's and 95 % of
   each leaf's elements within 8e-2 lr (the bounds of
   tests/test_torch_trainer.py for a 2-update run; the conv biases that feed
   a BatchNorm to the first bound alone); Adam's moments within
   3e-3 of their leaf's largest + 1e-8 (the gradients' bound). The frozen
   leaves stay bit for bit in both; the others do not move at steps 1 and 3.
3. A DFSMN step (config 4's family at small width) against JAX: losses,
   gradients, updated parameters, with the bounds of
   tests/test_torch_cruse_train.py.
4. The port alone: the masks against JAX's on every family, the non-finite
   guard in the middle of an accumulation, checkpoints with the EMA and the
   accumulator (round trip, a resume in the middle of an accumulation equal
   to an uninterrupted run, a pre-EMA resume, the narrow fallback), preload
   preferring the EMA from a checkpoint file and a ``.npz``, the trainer's
   EMA validation, and the train CLI with ``[trainer.distillation]``.
"""
import os
import sys

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.losses.balancer import Balancer as JaxBalancer
from cruse_tpu.losses.pmsqe import pmsqe_tables as jax_pmsqe_tables
from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.models import CruseConfig as JaxCruseConfig
from cruse_tpu.models import CruseNet as JaxCruseNet
from cruse_tpu.models import dfsmn as jd
from cruse_tpu.models import mtfaa as jm
from cruse_tpu.models.cruse_df import CruseDfConfig as JaxCruseDfConfig
from cruse_tpu.models.cruse_df import CruseDfNet as JaxCruseDfNet
from cruse_tpu.train import step as jstep

from cruse_tpu_torch.data.wavio import read_wav
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.models import CruseConfig, CruseDfConfig, CruseDfNet, CruseNet, DfsmnConfig, DfsmnNet
from cruse_tpu_torch.models import MtfaaConfig, MtfaaNet
from cruse_tpu_torch.train import checkpoint
from cruse_tpu_torch.train import step as tstep
from cruse_tpu_torch.train.step import (STEP_LOSSES, StepConfig, forward_for_model, init_train_state,
                                        make_loss_gradients, make_train_step, param_masks)
from cruse_tpu_torch.train.trainer import Trainer, TrainerConfig
from cruse_tpu_torch.utils.weights import (flax_from_state_dict, flax_param_paths, load_flax_npz, save_flax_npz,
                                           state_dict_from_flax)
from tests.test_torch_cruse_train import jax_gradients, to_torch_names, zero_gradient
from tests.test_torch_trainer import speech, write_corpus

SMALL = dict(in_freq=33, channels=(2, 4), rnn_groups=2)
HEAD = dict(df_bins=8, df_taps_t=1, df_taps_f=1)
STFT = dict(n_fft=64, hop_length=32)
# The JAX package caches its PMSQE tables per (n_fft, sr, nb) process-wide; the
# first call made inside a jit would cache tracers that a later jit in the same
# process (tests/test_losses.py's pmsqe step, at this n_fft) then reads. Fill
# the cache eagerly, with concrete arrays, before this file jits its steps.
jax_pmsqe_tables(STFT["n_fft"], 16000, None)
LR, WD, EMA, K = 1e-3, 0.05, 0.9, 2
FREEZE = ("enc_0",)
LOSSES = tuple(zip(STEP_LOSSES, (1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 1.0, 1.0)))
FEATURES = dict(learning_rate=LR, weight_decay=WD, freeze=FREEZE, ema_decay=EMA, grad_accum_steps=K,
                clip_grad_norm=1.0, loss_weights=LOSSES)
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def moved_stats(variables, rng):
    """numpy variables with the BatchNorm statistics moved off their defaults."""
    variables = jax.tree_util.tree_map(np.asarray, variables)
    stats = jax.tree_util.tree_map(lambda a: a + rng.uniform(0.2, 0.6, a.shape).astype(np.float32),
                                   variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def batches(seed, n, b=2, length=4000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        clean = (rng.standard_normal((b, length)) * 0.1).astype(np.float32)
        out.append({"noisy": (clean + 0.05 * rng.standard_normal((b, length))).astype(np.float32), "clean": clean})
    return out


def adam_state(opt_state):
    """The ScaleByAdamState inside an optax state."""
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
             if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def named(model, tensors):
    """A list in the optimiser's order -> {name: numpy}."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return {n: t.detach().cpu().numpy().copy() for n, t in zip(names, tensors)}


# ---------------- 1. the optimiser alone ----------------

OPTIMISERS = {
    "adamw_freeze_accum2_ema": dict(learning_rate=1e-2, weight_decay=0.1, freeze=("enc_0", "ln2"),
                                    grad_accum_steps=2, ema_decay=0.8, clip_grad_norm=2.0),
    "adam_freeze": dict(learning_rate=1e-2, freeze=("ggru",), clip_grad_norm=2.0, warmup_steps=2),
    "adamw_accum3_cosine": dict(learning_rate=1e-2, weight_decay=0.01, grad_accum_steps=3,
                                lr_schedule="cosine", decay_steps=4, warmup_steps=1, ema_decay=0.5),
}


@pytest.mark.parametrize("kind", sorted(OPTIMISERS))
def test_optimizer_chain_matches_optax(kind, monkeypatch):
    kw = OPTIMISERS[kind]
    rng = np.random.default_rng(1)
    jax_model = JaxCruseNet(JaxCruseConfig(**SMALL))
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init(jax.random.PRNGKey(0), jnp.ones((1, 4, 33))))
    jparams = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jstep.make_optimizer(jstep.StepConfig(**kw))
    jopt = tx.init(jparams)
    jema = jparams
    model = CruseNet(CruseConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    cfg = StepConfig(**kw)
    state = init_train_state(model, cfg, device="cpu")
    fed = {}

    def fake_loss_gradients(model_, cfg_, forward=None, teacher=None):
        return lambda balancer_state, batch: (fed["grads"], {"si_snr": torch.tensor(1.0)}, balancer_state)

    monkeypatch.setattr(tstep, "make_loss_gradients", fake_loss_gradients)
    step = make_train_step(model, cfg)
    names = [n for n, _ in model.named_parameters()]
    for i, scale in enumerate((0.3, 3.0, 0.2, 0.5, 4.0, 0.1)):
        jgrads = jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                                        variables["params"])
        bridged = state_dict_from_flax({"params": jgrads}, model)
        fed["grads"] = [bridged[n].clone() for n in names]
        updates, jopt = tx.update(jax.tree_util.tree_map(jnp.asarray, jgrads), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        if "ema_decay" in kw:
            d = kw["ema_decay"]
            jema = jax.tree_util.tree_map(lambda e, q: d * e + (1.0 - d) * q, jema, jparams)
        state, metrics = step(state, {"noisy": torch.zeros(1, 64), "clean": torch.zeros(1, 64)})
        want_norm = float(optax.global_norm(jgrads))
        np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-5)

        def close(ours, tree, what):
            theirs = to_torch_names({"model": model}, tree)
            for key, value in ours.items():
                np.testing.assert_allclose(value, theirs[key], rtol=1e-5, atol=3e-6, err_msg=f"{what} {key} {i}")

        close({n: p.detach().numpy() for n, p in model.named_parameters()}, jparams, "params")
        inner = jopt.inner_opt_state if kw.get("grad_accum_steps", 1) > 1 else jopt
        adam = adam_state(inner)
        close(named(model, state.opt_state.mu), adam.mu, "mu")
        close(named(model, state.opt_state.nu), adam.nu, "nu")
        assert state.opt_state.count == int(adam.count)
        if kw.get("grad_accum_steps", 1) > 1:
            assert state.opt_state.mini_step == int(jopt.mini_step)
            close(named(model, state.opt_state.acc), jopt.acc_grads, "acc")
        if "ema_decay" in kw:
            close(named(model, state.ema), jema, "ema")
    frozen, _ = param_masks(model, cfg)
    start = state_dict_from_flax(variables, model)
    for (name, p), f in zip(model.named_parameters(), frozen):
        assert torch.equal(p.detach(), start[name]) == f, name  # frozen leaves, and only they, stay


# ---------------- 2. four featured steps against JAX ----------------


@pytest.fixture(scope="module")
def featured():
    rng = np.random.default_rng(0)
    jax_model = JaxCruseNet(JaxCruseConfig(**SMALL))
    jax_teacher = JaxCruseDfNet(JaxCruseDfConfig(cruse=JaxCruseConfig(**SMALL, emit_features=True), **HEAD))
    variables = moved_stats(jax_model.init(jax.random.PRNGKey(0), jnp.ones((1, 4, 33))), rng)
    tvars = moved_stats(jax_teacher.init(jax.random.PRNGKey(1), jnp.ones((1, 4, 33))), rng)
    jcfg = jstep.StepConfig(stft=JaxStftConfig(**STFT), **FEATURES)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jstate = jstep.TrainState(
        params=jv["params"], batch_stats=jv["batch_stats"], opt_state=jstep.make_optimizer(jcfg).init(jv["params"]),
        balancer_state=JaxBalancer.make(dict(jcfg.loss_weights)).init_state(), step=jnp.zeros((), jnp.int32),
        ema_params=jax.tree_util.tree_map(jnp.array, jv["params"]))
    jstep_fn = jax.jit(jstep.make_train_step(
        jax_model, jcfg, jstep.forward_for_model(jax_model),
        teacher=(jstep.forward_for_model(jax_teacher), jax.tree_util.tree_map(jnp.asarray, tvars))))
    data = batches(2, STEPS)
    jstates, jmetrics = [jstate], []
    for b in data:
        jstate, m = jstep_fn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jstates.append(jstate)
        jmetrics.append({k: float(v) for k, v in m.items()})

    model = CruseNet(CruseConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    teacher = CruseDfNet(CruseDfConfig(cruse=CruseConfig(**SMALL), **HEAD)).eval()
    teacher.load_state_dict(state_dict_from_flax(tvars, teacher), strict=True)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    cfg = StepConfig(stft=StftConfig(**STFT), **FEATURES)
    state = init_train_state(model, cfg, device="cpu")
    step = make_train_step(model, cfg, teacher=(forward_for_model(teacher), teacher))
    snaps, metrics = [], []

    def snapshot(state):
        return dict(params={k: v.detach().numpy().copy() for k, v in model.named_parameters()},
                    mu=named(model, state.opt_state.mu), nu=named(model, state.opt_state.nu),
                    acc=named(model, state.opt_state.acc), ema=named(model, state.ema),
                    count=state.opt_state.count, mini_step=state.opt_state.mini_step)

    snaps.append(snapshot(state))
    for b in data:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        snaps.append(snapshot(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(model=model, teacher=teacher, teacher_before=teacher_before, cfg=cfg, state=state, snaps=snaps,
                metrics=metrics, jstates=jstates, jmetrics=jmetrics)


def test_featured_losses_and_norms_match_jax(featured):
    f = featured
    for i, (ours, theirs) in enumerate(zip(f["metrics"], f["jmetrics"])):
        assert ours.keys() == theirs.keys() and len(ours) == len(LOSSES) + 2
        rtol = 1e-5 if i < 2 else 1e-3  # steps 3 and 4 run parameters one update apart
        for name, _ in LOSSES:
            np.testing.assert_allclose(ours[f"loss_{name}"], theirs[f"loss_{name}"], rtol=rtol, err_msg=f"{name} {i}")
        np.testing.assert_allclose(ours["grad_norm"], theirs["grad_norm"], rtol=2e-3 if i < 2 else 2e-2)
        assert ours["nonfinite_skipped"] == theirs["nonfinite_skipped"] == 0


def test_featured_accumulator_holds_the_first_gradients(featured):
    """After step 1 the accumulator is that step's gradients: the whole
    featured step's backward, distillation included, leaf by leaf."""
    f = featured
    ours = f["snaps"][1]["acc"]
    theirs = to_torch_names(f, f["jstates"][1].opt_state.acc_grads)
    assert ours.keys() == theirs.keys() and f["snaps"][1]["mini_step"] == int(f["jstates"][1].opt_state.mini_step) == 1
    gscale = max(np.abs(v).max() for v in theirs.values())
    for key, want in theirs.items():
        err = np.abs(ours[key] - want).max()
        if zero_gradient(f["model"], key):
            assert err < 1e-3 * gscale + 1e-5, (key, err)
        else:
            assert err <= 2e-3 * np.abs(want).max() or err <= 3e-3 * gscale + 1e-5, (key, err)


def test_featured_updates_follow_freeze_and_accumulation(featured):
    f = featured
    snaps, frozen = f["snaps"], param_masks(f["model"], f["cfg"])[0]
    names = [n for n, _ in f["model"].named_parameters()]
    assert sum(frozen) == 4 and all(n.startswith("enc_0.") for n, fr in zip(names, frozen) if fr)
    jparams = [to_torch_names(f, s.params) for s in f["jstates"]]
    for name, is_frozen in zip(names, frozen):
        for i in range(1, STEPS + 1):
            moved = not np.array_equal(snaps[i]["params"][name], snaps[i - 1]["params"][name])
            jmoved = not np.array_equal(jparams[i][name], jparams[i - 1][name])
            assert moved == jmoved == (not is_frozen and i % K == 0), (name, i, moved, jmoved)
    assert [s["count"] for s in snaps] == [0, 0, 1, 1, 2] and [s["mini_step"] for s in snaps] == [0, 1, 0, 1, 0]
    # one step's EMA from the recorded tensors: d e + (1 - d) p
    for name in names:
        np.testing.assert_allclose(snaps[2]["ema"][name], EMA * snaps[1]["ema"][name] + (1 - EMA) * snaps[2]["params"][name],
                                   rtol=1e-6, atol=1e-8)


def test_featured_parameters_moments_and_ema_match_jax(featured):
    f = featured
    last, jlast = f["snaps"][-1], f["jstates"][-1]
    adam = adam_state(jlast.opt_state.inner_opt_state)
    assert last["count"] == int(adam.count) == STEPS // K
    for what, ours, tree in (("params", last["params"], jlast.params), ("ema", last["ema"], jlast.ema_params)):
        theirs = to_torch_names(f, tree)
        for key, want in theirs.items():
            err = np.abs(ours[key] - want)
            bound = 2 * (LR + LR * WD * np.abs(want))
            assert (err <= bound).all(), (what, key, err.max())
            if not zero_gradient(f["model"], key):  # a conv bias that feeds a BatchNorm: Adam's noise alone
                assert np.mean(err <= 8e-2 * LR) >= 0.95, (what, key, np.mean(err <= 8e-2 * LR))
    for what, ours, tree in (("mu", last["mu"], adam.mu), ("nu", last["nu"], adam.nu)):
        theirs = to_torch_names(f, tree)
        for key, want in theirs.items():
            err = np.abs(ours[key] - want).max()
            assert err <= 3e-3 * np.abs(want).max() + 1e-8 or zero_gradient(f["model"], key), (what, key, err)


def test_teacher_does_not_move(featured):
    for key, value in featured["teacher"].state_dict().items():
        assert torch.equal(value, featured["teacher_before"][key]), key
    assert not featured["teacher"].training


def test_nonfinite_step_keeps_the_accumulation(featured):
    f = featured
    model, state = f["model"], f["state"]
    step = make_train_step(model, f["cfg"], teacher=(forward_for_model(f["teacher"]), f["teacher"]))
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in batches(5, 1)[0].items()})  # mini-step 1
    kept = dict(params={k: v.clone() for k, v in model.state_dict().items()},
                acc=[a.clone() for a in state.opt_state.acc], ema=[e.clone() for e in state.ema],
                mini=state.opt_state.mini_step, count=state.opt_state.count)
    bad = batches(6, 1)[0]
    bad["noisy"][0, 100] = np.nan
    new, metrics = step(state, {k: torch.from_numpy(v) for k, v in bad.items()})
    assert float(metrics["nonfinite_skipped"]) == 1.0 and new.step == state.step + 1
    assert new.opt_state.mini_step == kept["mini"] == 1 and new.opt_state.count == kept["count"]
    for got, want in zip(new.opt_state.acc + new.ema, kept["acc"] + kept["ema"]):
        assert torch.equal(got, want)
    for key, value in model.state_dict().items():
        assert torch.equal(value, kept["params"][key]), key


# ---------------- 3. DFSMN ----------------


def test_dfsmn_step_matches_jax():
    from tests.test_torch_dfsmn import with_skips

    rng = np.random.default_rng(3)
    args = dict(in_freq=33, hidden_dim=16, num_blocks=2, left_frames=2, right_frames=1)
    jax_model = jd.DfsmnNet(**args)
    variables = with_skips(jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 33))), rng)
    variables = {"params": variables["params"], "batch_stats": {}}
    jcfg = jstep.StepConfig(stft=JaxStftConfig(**STFT), learning_rate=LR)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jstate = jstep.TrainState(params=jv["params"], batch_stats={}, opt_state=jstep.make_optimizer(jcfg).init(jv["params"]),
                              balancer_state=JaxBalancer.make(dict(jcfg.loss_weights)).init_state(),
                              step=jnp.zeros((), jnp.int32))
    data = batches(4, 1)[0]
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    jforward = jstep.forward_for_model(jax_model)
    jnew, jmetrics = jax.jit(jstep.make_train_step(jax_model, jcfg, jforward))(jstate, jbatch)

    model = DfsmnNet(DfsmnConfig(**args))
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    cfg = StepConfig(stft=StftConfig(**STFT), learning_rate=LR)
    state = init_train_state(model, cfg, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads, _, _ = make_loss_gradients(model, cfg)(state.balancer_state, tbatch)
    new, metrics = make_train_step(model, cfg)(state, tbatch)
    s = dict(model=model, jcfg=jcfg, jstate=jstate, jbatch=jbatch, jforward=jforward)
    for key in ("loss_si_snr", "loss_spec"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]), rtol=2e-3)
    ours = named(model, grads)
    theirs = to_torch_names(s, jax_gradients(s))
    assert ours.keys() == theirs.keys() and len(ours) == len(list(model.parameters())) > 10
    gscale = max(np.abs(v).max() for v in theirs.values())
    for key, want in theirs.items():
        err = np.abs(ours[key] - want).max()
        assert err <= 2e-3 * np.abs(want).max() or err <= 3e-3 * gscale + 1e-5, (key, err)
    new_params = to_torch_names(s, jnew.params)
    for key, want in new_params.items():
        got = model.state_dict()[key].numpy()
        sure = np.abs(ours[key]) > 1e-2 * np.abs(ours[key]).max()
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=2e-2 * LR, err_msg=key)
        assert np.abs(got - before[key].numpy()).max() <= LR + 1e-7, key
    assert new.opt_state.count == 1


# ---------------- 4. the port alone ----------------


def mtfaa_pair():
    tiny = dict(n_fft=256, n_bands=16, channels=(8, 8), band_strides=(2, 2), tfcm_layers=2, attention_window=8)
    return jm.MtfaaNet(jm.MtfaaConfig(**tiny)), MtfaaNet(MtfaaConfig(**tiny)), jnp.zeros((1, 4, 129, 2))


FAMILIES = {
    "cruse": lambda: (JaxCruseNet(JaxCruseConfig(**SMALL)), CruseNet(CruseConfig(**SMALL)), jnp.ones((1, 4, 33))),
    "cruse_df": lambda: (JaxCruseDfNet(JaxCruseDfConfig(cruse=JaxCruseConfig(**SMALL, emit_features=True), **HEAD)),
                         CruseDfNet(CruseDfConfig(cruse=CruseConfig(**SMALL), **HEAD)), jnp.ones((1, 4, 33))),
    "dfsmn": lambda: (jd.DfsmnNet(in_freq=33, hidden_dim=16, num_blocks=2), DfsmnNet(DfsmnConfig(
        in_freq=33, hidden_dim=16, num_blocks=2)), jnp.zeros((1, 4, 33))),
    "mtfaa": mtfaa_pair,
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_freeze_and_decay_masks_match_jax(family):
    """The freeze patterns and AdamW's mask select the same leaves as the
    JAX package's tree_map_with_path / ndim rules, family by family."""
    jax_model, model, example = FAMILIES[family]()
    params = jax_model.init(jax.random.PRNGKey(0), example)["params"]
    paths = flax_param_paths(model)
    flat = {jax.tree_util.keystr(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    ours = {"".join(f"['{k}']" for k in path.split("/")): ndim for path, ndim in paths.values()}
    assert ours == {k: v.ndim for k, v in flat.items()}
    patterns = ("enc", "['dec_0']", "ggru", "block_1", "kernel", "nothing")
    cfg = StepConfig(weight_decay=0.1, freeze=patterns)
    frozen, decayed = param_masks(model, cfg)
    jfrozen = {k: any(p in k for p in patterns) for k in flat}
    keys = ["".join(f"['{k}']" for k in paths[n][0].split("/")) for n, _ in model.named_parameters()]
    assert frozen == [jfrozen[k] for k in keys] and any(frozen) and not all(frozen)
    assert decayed == [flat[k].ndim >= 2 for k in keys] and any(decayed) and not all(decayed)


@pytest.fixture(scope="module")
def small_data():
    rng = np.random.default_rng(0)
    return [speech(rng, 2, 4000) for _ in range(3)], [{**speech(rng, 2, 4000), "name": ["va", "vb"]}]


def make_trainer(root, name, epochs, data, resume=False, validate=False, **step_kw):
    train, valid = data
    model = CruseNet(CruseConfig(**SMALL), generator=torch.Generator().manual_seed(1))
    cfg = StepConfig(stft=StftConfig(**STFT), learning_rate=LR, **step_kw)
    return Trainer(model, cfg, TrainerConfig(epochs=epochs, steps_per_epoch=3, save_dir=str(root), experiment_name=name,
                                             metrics=("STOI",), visualization_examples=0, num_metric_workers=1,
                                             validation_interval=1 if validate else 10**9),
                   train_batches=train, validation_batches=valid, device="cpu", writer=False, resume=resume)


FEATURED_TRAINER = dict(weight_decay=WD, freeze=FREEZE, ema_decay=EMA, grad_accum_steps=K)


def test_resume_in_the_middle_of_an_accumulation(small_data, tmp_path):
    """Epochs of 3 steps with k = 2: epoch 1 ends one mini-step into an
    accumulation. A run resumed there equals an uninterrupted one, and the
    checkpoint round trip is bit for bit (EMA, accumulator, mini-step)."""
    whole = make_trainer(tmp_path, "whole", 2, small_data, **FEATURED_TRAINER)
    whole.train()
    first = make_trainer(tmp_path, "split", 1, small_data, **FEATURED_TRAINER)
    first.train()
    saved = checkpoint.load_checkpoint(first.checkpoints_dir / "latest")
    assert saved["opt_mini_step"] == 1 and saved["opt_count"] == 1 and len(saved["ema"]) == len(saved["opt_acc"])
    resumed = make_trainer(tmp_path, "split", 2, small_data, resume=True, **FEATURED_TRAINER)
    state = resumed.state
    assert state.opt_state.mini_step == 1 and state.opt_state.count == 1
    for got, want in zip(state.ema + state.opt_state.acc, saved["ema"] + saved["opt_acc"]):
        assert torch.equal(got, want)
    resumed.train()
    assert resumed.state.opt_state.count == whole.state.opt_state.count == 3
    for got, want in zip(resumed.state.ema + list(resumed.state.model.state_dict().values()),
                         whole.state.ema + list(whole.state.model.state_dict().values())):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_snapshots_carry_the_ema_and_preload_prefers_it(small_data, tmp_path):
    trainer = make_trainer(tmp_path, "ema", 1, small_data, validate=True, ema_decay=EMA)
    trainer.train()
    ckpt = trainer.checkpoints_dir
    snap = checkpoint.load_checkpoint(ckpt / "model_0001")
    ema = dict(zip([n for n, _ in trainer.state.model.named_parameters()], trainer.state.ema))
    assert snap.keys() == {"model", "ema"} and all(torch.equal(snap["ema"][k], v) for k, v in ema.items())
    with np.load(ckpt / "model_0001.npz") as data:
        assert any(k.startswith("ema_params/") for k in data.files) and any(k.startswith("params/") for k in data.files)
    loaded = state_dict_from_flax(load_flax_npz(str(ckpt / "model_0001.npz")), trainer.state.model)
    assert all(torch.equal(loaded[k], v) for k, v in ema.items())
    assert torch.equal(loaded["enc_0.bn.running_var"], trainer.state.model.enc_0.bn.running_var)
    for source in ("model_0001", "model_0001.npz", "latest"):
        target = CruseNet(CruseConfig(**SMALL), generator=torch.Generator().manual_seed(9))
        checkpoint.preload_params(ckpt / source, target)
        for name, p in target.named_parameters():
            assert torch.equal(p.detach(), ema[name]), (source, name)
    # validation ran the EMA weights: enhance() equals a model that holds them
    plain = CruseNet(CruseConfig(**SMALL))
    plain.load_state_dict({**trainer.state.model.state_dict(), **ema})
    x = torch.from_numpy(small_data[1][0]["noisy"])
    own = trainer.enhance(x)
    with torch.no_grad():
        spec = tstep.stft(x, trainer.scfg)
        out = forward_for_model(plain.eval())(torch.stack([spec.real, spec.imag], -1))
        want = tstep.istft((out[..., 0], out[..., 1]), trainer.scfg, length=x.shape[-1])
    np.testing.assert_allclose(own.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert trainer.state.model.training and not any(torch.equal(trainer.state.model.get_parameter(k), v)
                                                    for k, v in ema.items() if not k.endswith("bias"))


def test_pre_ema_resume_and_the_narrow_fallback(small_data, tmp_path):
    plain = make_trainer(tmp_path, "pre", 1, small_data)
    plain.train()
    resumed = make_trainer(tmp_path, "pre", 2, small_data, resume=True, ema_decay=EMA)
    for e, p in zip(resumed.state.ema, resumed.state.model.parameters()):
        assert torch.equal(e, p.detach())  # started from the restored parameters
    tree = checkpoint.load_checkpoint(plain.checkpoints_dir / "latest")
    tree["ema"] = tree["opt_mu"][:-1]  # an EMA that does not fit the model
    torch.save(tree, plain.checkpoints_dir / "latest")
    with pytest.raises(ValueError, match="EMA tensors"):
        make_trainer(tmp_path, "pre", 2, small_data, resume=True, ema_decay=EMA)


def test_cli_trains_with_distillation_and_features(tmp_path, monkeypatch):
    from cruse_tpu_torch.infer.__main__ import main as infer_main
    from cruse_tpu_torch.train.__main__ import main

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    files = write_corpus(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    teacher = CruseDfNet(CruseDfConfig(cruse=CruseConfig(in_freq=161, channels=(4, 8, 8, 16), rnn_groups=4),
                                       df_bins=24, df_taps_t=1, df_taps_f=1),
                         generator=torch.Generator().manual_seed(4))
    for name, buffer in teacher.named_buffers():
        if name.endswith("running_var"):
            buffer.fill_(1.7)  # statistics that must come with the weights
    save_flax_npz(flax_from_state_dict(teacher), str(tmp_path / "teacher.npz"))
    text = open(os.path.join(root, "configs", "tiny_cruse.toml")).read()
    text = text.replace("/tmp/corpus/runs", str(tmp_path / "runs")).replace("/tmp/corpus", str(tmp_path))
    text = text.replace("lr = 1e-3", 'lr = 1e-3\nweight_decay = 0.01\nema_decay = 0.9\nfreeze = ["enc_0"]')
    text = text.replace("spec = 1.0", "spec = 1.0\ndistill = 1.0\npmsqe = 0.5")
    text = text.replace("clip_grad_norm_value = 10.0", "clip_grad_norm_value = 10.0\ngrad_accum_steps = 2")
    text = text.replace("epochs = 1", "epochs = 2")
    text += (f'\n[trainer.distillation]\nconfig = "{root}/configs/tiny_cruse_df.toml"\n'
             f'checkpoint = "{tmp_path / "teacher.npz"}"\n')
    config = tmp_path / "distill.toml"
    config.write_text(text)
    trainer = main(["-C", str(config), "--device", "cpu"])
    assert trainer.state.step == 4 and trainer.state.opt_state.count == 2 and trainer.state.ema is not None
    log = (tmp_path / "runs" / "tiny_cruse" / "train.log").read_text()
    assert "distillation teacher" in log and "epoch 2 loss_distill" in log and "epoch 2 loss_pmsqe" in log
    assert isinstance(trainer.teacher, CruseDfNet) and not trainer.teacher.training
    for key, value in teacher.state_dict().items():  # its weights and statistics, unmoved
        assert torch.equal(trainer.teacher.state_dict()[key], value), key
    ckpt = tmp_path / "runs" / "tiny_cruse" / "checkpoints"
    clips = tmp_path / "clips"
    clips.mkdir()
    for f in files["clean"][4:]:
        os.link(f, clips / os.path.basename(f))
    infer_main(["-C", str(config), "-I", str(clips), "-O", str(tmp_path / "out"),
                "--weights", str(ckpt / "model_0002.npz"), "--device", "cpu"])
    for f in sorted(clips.iterdir()):
        served = read_wav(str(tmp_path / "out" / f.name))[0]
        own = trainer.enhance(torch.from_numpy(read_wav(str(f))[0][None]))[0].numpy()
        own = 0.8 * 32767 * own / np.abs(own).max() / 32768
        assert np.abs(served - own).max() <= 1e-4
