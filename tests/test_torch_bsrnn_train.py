"""Port parity: training cruse_tpu_torch's BSRNN against cruse_tpu, on the
CPU: the step's losses (``si_snr`` + ``spec``, configs/tiny_bsrnn*.toml's)
and every gradient leaf through the complex forward adapter and cuDNN's
(here: PyTorch's CPU) LSTM backward, offline and causal; the train CLI on
both tiny configs. MetricGAN+ (``configs/tiny_bsrnn_gan.toml``) is
tests/test_torch_metricgan.py's.

The port's seeded weights cross the bridge to JAX; the JAX step's pieces
(the adapter, the balancer's cotangent, the losses) run jitted once a
model. Tolerances, those of tests/test_torch_train_step.py: the losses 1e-5
relative; the gradient's global norm 2e-3 relative; each gradient leaf 2e-3
relative or 3e-3 of the largest gradient + 1e-3 absolute.
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
from cruse_tpu.losses.spectral import compressed_spectral_loss as jax_spec_loss
from cruse_tpu.train import step as jstep

from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.models import BSRNN
from cruse_tpu_torch.train.step import StepConfig, init_train_state, make_loss_gradients, make_train_step
from cruse_tpu_torch.utils.weights import flax_from_state_dict
from tests.test_torch_bsrnn import ROOT, make_pair
from tests.test_torch_train_step import batch
from tests.test_torch_trainer import write_corpus

STFT = dict(n_fft=512, hop_length=256)
LOSSES = (("si_snr", 1.0), ("spec", 1.0))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_loss_gradients(jax_model, params, data):
    """The reference step's losses and gradients, from its own pieces in its
    own order, as one jitted call."""
    scfg = JaxStftConfig(**STFT)
    forward = jstep.forward_for_model(jax_model)

    def run(params, noisy, clean):
        ri = lambda z: jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)  # noqa: E731
        noisy_ri, clean_spec = ri(jax_stft(noisy, scfg)), jax_stft(clean, scfg)
        clean_ri = ri(clean_spec)
        norm = clean.shape[0] * clean_spec.shape[1] * clean_spec.shape[2]
        out, vjp_fn, _ = jax.vjp(lambda p: forward(p, {}, noisy_ri), params, has_aux=True)
        fns = {"si_snr": lambda o: jax_si_snr_loss(jax_istft((o[..., 0], o[..., 1]), scfg, length=noisy.shape[-1]),
                                                   clean),
               "spec": lambda o: jax_spec_loss(o, clean_ri) / norm}
        balancer = JaxBalancer.make(dict(LOSSES))
        out_grad, losses, _, _ = balancer.output_cotangent(fns, out, balancer.init_state())
        return vjp_fn(out_grad)[0], losses

    grads, losses = jax.jit(run)(params, jnp.asarray(data["noisy"]), jnp.asarray(data["clean"]))
    return flat(grads), {k: float(v) for k, v in losses.items()}


@pytest.fixture(scope="module", params=[False, True], ids=["offline", "causal"])
def one_step(request):
    """Both packages' losses and gradients on one numpy-seeded batch, and one
    port step from there."""
    jax_model, variables, model = make_pair(request.param, 1, seed=7)
    data = batch(np.random.default_rng(3), b=2, n=4096)
    jgrads, jlosses = jax_loss_gradients(jax_model, variables["params"], data)
    cfg = StepConfig(stft=StftConfig(**STFT), loss_weights=LOSSES)
    state = init_train_state(model, cfg, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    grads, losses, _ = make_loss_gradients(model, cfg)(state.balancer_state, tbatch)
    named = {name: g for (name, _), g in zip(model.named_parameters(), grads)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    new, metrics = make_train_step(model, cfg)(state, tbatch)
    return dict(model=model, jgrads=jgrads, jlosses=jlosses, grads=named, losses=losses, new=new,
                metrics=metrics, before=before, cfg=cfg)


def test_losses_match_jax(one_step):
    s = one_step
    for name, want in s["jlosses"].items():
        np.testing.assert_allclose(float(s["losses"][name]), want, rtol=1e-5)
        np.testing.assert_allclose(float(s["metrics"][f"loss_{name}"]), want, rtol=1e-5)
    jnorm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in s["jgrads"].values()))
    np.testing.assert_allclose(float(s["metrics"]["grad_norm"]), jnorm, rtol=2e-3)


def test_every_gradient_leaf_matches_jax(one_step):
    s = one_step
    ours = flat(flax_from_state_dict(s["model"], s["grads"])["params"])
    theirs = s["jgrads"]
    assert ours.keys() == theirs.keys() and len(ours) == 31 * 4 + 31 * 6 + 2 * 4 + 4 + 8
    gscale = max(np.abs(v).max() for v in theirs.values())
    for key, want in theirs.items():
        err = np.abs(ours[key] - want).max()
        rel = err / (np.abs(want).max() + 1e-6)
        assert rel < 2e-3 or err < 3e-3 * gscale + 1e-3, (key, err, rel)
    # the LSTMs' weights are on the gradient's path, both directions of the band LSTM
    for key in ("['lstm_t_0']['w_hh']", "['lstm_k_0']['w_ih_reverse']", "['lstm_k_0']['b_hh_reverse']"):
        assert np.abs(theirs[key]).max() > 0, key


def test_the_step_moves_every_parameter(one_step):
    s = one_step
    assert s["new"].step == 1 and float(s["metrics"]["nonfinite_skipped"]) == 0
    after = s["model"].state_dict()
    lr = s["cfg"].learning_rate
    for key, old in s["before"].items():
        moved = (after[key] - old).abs().max()
        assert 0 < moved <= lr + 1e-7, (key, moved)


def write_config(root, name: str):
    text = open(os.path.join(ROOT, "configs", name)).read()
    text = text.replace("/tmp/corpus/runs", str(root / "runs")).replace("/tmp/corpus", str(root))
    config = root / name
    config.write_text(text)
    return config


@pytest.mark.parametrize("name", ["tiny_bsrnn.toml", "tiny_bsrnn_causal.toml"])
def test_train_cli_runs_the_tiny_configs(tmp_path, monkeypatch, name):
    """``python -m cruse_tpu_torch.train``'s main on the config (the corpus in
    a temporary directory): one epoch of two steps, validation on the
    complex model scored, checkpoints and the snapshot written."""
    from cruse_tpu_torch.train.__main__ import main

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no TensorBoard writer
    write_corpus(tmp_path)
    trainer = main(["-C", str(write_config(tmp_path, name)), "--device", "cpu"])
    run = tmp_path / "runs" / name.removesuffix(".toml")
    assert isinstance(trainer.state.model, BSRNN) and trainer.state.step == 2
    assert trainer.state.model.config.causal == ("causal" in name)
    assert all((run / "checkpoints" / n).is_file() for n in ("latest", "best", "model_0001.npz"))
    log = (run / "train.log").read_text()
    assert log.count("composite score") == 1 and "epoch 1 loss_si_snr" in log and "epoch 1 loss_spec" in log
    assert np.isfinite(trainer.best_score)
