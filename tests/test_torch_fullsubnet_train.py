"""Port parity: training cruse_tpu_torch's FullSubNet against cruse_tpu, on
the CPU: one ``make_train_step`` step with the recipe's losses (``si_snr`` +
``cirm``) through the ``fullsubnet`` forward adapter, and the train CLI on a
tiny FullSubNet TOML.

Both packages start from the same flax-initialised parameters (the
cumulative-norm model, so the norms' carries are on the gradient's path too)
and take one step on the same numpy-seeded batch. Tolerances, those of
tests/test_torch_train_step.py: the losses 1e-5 relative; the gradient's
global norm 2e-3 relative; each gradient leaf 2e-3 relative or 3e-3 of the
largest gradient + 1e-3 absolute; the updated parameters 2e-2 lr where the
gradient is clearly away from zero, and every element within lr of its start.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.dsp.stft import istft as jax_istft
from cruse_tpu.dsp.stft import stft as jax_stft
from cruse_tpu.losses.balancer import Balancer as JaxBalancer
from cruse_tpu.losses.sisnr import si_snr_loss as jax_si_snr_loss
from cruse_tpu.losses.spectral import cirm_mse_loss as jax_cirm_mse_loss
from cruse_tpu.models import fullsubnet as jf
from cruse_tpu.train import step as jstep

from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.models import FullSubNet, FullSubNetConfig
from cruse_tpu_torch.train.step import StepConfig, init_train_state, make_loss_gradients, make_train_step
from cruse_tpu_torch.utils.weights import flax_from_state_dict, state_dict_from_flax
from tests.test_torch_train_step import ADAM_FLOOR, GRAD_FLOOR, batch
from tests.test_torch_trainer import write_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = dict(num_freqs=33, num_neighbors=2, fb_hidden=16, fb_layers=2, sb_hidden=8, sb_layers=2,
            norm="cumulative_laplace_norm")
STFT = dict(n_fft=64, hop_length=32)
LOSSES = (("si_snr", 1.0), ("cirm", 1.0))
LR = 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def one_step():
    """Both packages before and after one step, and the step's gradients."""
    rng = np.random.default_rng(0)
    jax_model = jf.FullSubNet(jf.FullSubNetConfig(**ARGS))
    jcfg = jstep.StepConfig(stft=JaxStftConfig(**STFT), learning_rate=LR, loss_weights=LOSSES)
    jstate = jstep.init_train_state(jax_model, jcfg, jax.random.PRNGKey(0),
                                    jnp.ones((1, 4, ARGS["num_freqs"]), jnp.float32))
    data = batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    jforward = jstep.forward_for_model(jax_model)
    jnew, jmetrics = jax.jit(jstep.make_train_step(jax_model, jcfg, jforward))(jstate, jbatch)

    model = FullSubNet(FullSubNetConfig(**ARGS))
    model.load_state_dict(state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jstate.params)},
                                               model), strict=True)
    cfg = StepConfig(stft=StftConfig(**STFT), learning_rate=LR, loss_weights=LOSSES)
    state = init_train_state(model, cfg, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads, _, _ = make_loss_gradients(model, cfg)(state.balancer_state, tbatch)
    new, metrics = make_train_step(model, cfg)(state, tbatch)
    named = {name: g for (name, _), g in zip(model.named_parameters(), grads)}
    return dict(jcfg=jcfg, jstate=jstate, jnew=jnew, jmetrics=jmetrics, jbatch=jbatch, jforward=jforward,
                model=model, cfg=cfg, new=new, metrics=metrics, before=before, grads=named)


def jax_gradients(s):
    """The reference step's gradients, from its own pieces in its own order."""
    scfg, jstate, jb = s["jcfg"].stft, s["jstate"], s["jbatch"]
    ri = lambda z: jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)  # noqa: E731
    noisy_ri, clean_ri = ri(jax_stft(jb["noisy"], scfg)), ri(jax_stft(jb["clean"], scfg))
    out, vjp_fn, _ = jax.vjp(lambda p: s["jforward"](p, jstate.batch_stats, noisy_ri), jstate.params, has_aux=True)
    fns = {"si_snr": lambda o: jax_si_snr_loss(jax_istft((o[..., 0], o[..., 1]), scfg,
                                                         length=jb["noisy"].shape[-1]), jb["clean"]),
           "cirm": lambda o: jax_cirm_mse_loss(o, noisy_ri, clean_ri)}
    out_grad, _, _, _ = JaxBalancer.make(dict(LOSSES)).output_cotangent(fns, out, jstate.balancer_state)
    return vjp_fn(out_grad)[0]


def test_losses_and_norm_match_jax(one_step):
    s = one_step
    for key in ("loss_si_snr", "loss_cirm"):
        np.testing.assert_allclose(float(s["metrics"][key]), float(s["jmetrics"][key]), rtol=1e-5)
    np.testing.assert_allclose(float(s["metrics"]["grad_norm"]), float(s["jmetrics"]["grad_norm"]), rtol=2e-3)
    assert float(s["metrics"]["nonfinite_skipped"]) == float(s["jmetrics"]["nonfinite_skipped"]) == 0
    assert s["new"].step == int(s["jnew"].step) == 1


def test_every_gradient_leaf_matches_jax(one_step):
    ours = flat(flax_from_state_dict(one_step["model"], one_step["grads"])["params"])
    theirs = flat(jax_gradients(one_step))
    assert ours.keys() == theirs.keys() and len(ours) == 4 * 4 + 2 * 2
    gscale = max(np.abs(v).max() for v in theirs.values())
    for key, want in theirs.items():
        err = np.abs(ours[key] - want).max()
        rel = err / (np.abs(want).max() + 1e-6)
        assert rel < 2e-3 or err < 3e-3 * gscale + 1e-3, (key, err, rel)
        assert np.abs(want).max() > 0, key  # every leaf is on the gradient's path


def test_updated_parameters_match_jax(one_step):
    s = one_step
    model = s["model"]
    ours = flat(flax_from_state_dict(model)["params"])
    theirs = flat(s["jnew"].params)
    grads = flat(flax_from_state_dict(model, s["grads"])["params"])
    old = flat(flax_from_state_dict(model, s["before"])["params"])
    clip = min(1.0, s["cfg"].clip_grad_norm / float(s["metrics"]["grad_norm"]))
    compared = 0
    for key, value in theirs.items():
        sure = np.abs(grads[key]) > max(GRAD_FLOOR * np.abs(grads[key]).max(), ADAM_FLOOR / clip)
        np.testing.assert_allclose(ours[key][sure], value[sure], rtol=0, atol=2e-2 * LR, err_msg=key)
        assert np.abs(ours[key] - old[key]).max() <= LR + 1e-7, key
        compared += int(sure.sum())
    assert compared > 0.5 * sum(v.size for v in theirs.values()), compared


def test_train_cli_runs_a_fullsubnet_toml(tmp_path, monkeypatch):
    """``python -m cruse_tpu_torch.train``'s main on configs/tiny_fullsubnet.toml
    (complex_mask serving, the corpus in a temporary directory): one epoch of
    two steps, validation scored, checkpoints and the snapshot written."""
    from cruse_tpu_torch.train.__main__ import main

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no TensorBoard writer
    write_corpus(tmp_path)
    text = open(os.path.join(ROOT, "configs", "tiny_fullsubnet.toml")).read()
    text = text.replace("/tmp/corpus/runs", str(tmp_path / "runs")).replace("/tmp/corpus", str(tmp_path))
    config = tmp_path / "fsn.toml"
    config.write_text(text.replace('type = "mag_to_mag"', 'type = "complex_mask"'))
    trainer = main(["-C", str(config), "--device", "cpu"])
    ckpt = tmp_path / "runs" / "tiny_fullsubnet" / "checkpoints"
    assert isinstance(trainer.state.model, FullSubNet) and trainer.state.step == 2
    assert all((ckpt / n).is_file() for n in ("latest", "best", "model_0001.npz"))
    log = (tmp_path / "runs" / "tiny_fullsubnet" / "train.log").read_text()
    assert log.count("composite score") == 1 and "epoch 1 loss_si_snr" in log
    assert np.isfinite(trainer.best_score)
