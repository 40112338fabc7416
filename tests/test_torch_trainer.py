"""Port parity: cruse_tpu_torch.train.trainer.Trainer against
cruse_tpu.train.trainer.Trainer on the CPU, and the port's checkpoints and
train CLI.

Both trainers train configs/tiny_cruse.toml's model (in_freq 161, channels
(4, 8, 8, 16), 4 GRU groups, lr 1e-3) from the same weights -- the JAX
trainer's initial parameters and BatchNorm statistics, bridged by
``utils/weights.py::state_dict_from_flax`` -- on the same list of numpy
batches (2 of B=4 x 1 s), 2 epochs x 2 steps, with a validation batch
(B=2 x 1 s) scored after each epoch on STOI, SI-SDR, WB-PESQ and PMOS.
Tolerances: the epoch means of the losses rtol 1e-4, of the gradient norm
2e-3 (tests/test_torch_train_step.py's bound for one step); every validation
mean (noisy and enhanced) rtol 1e-3 (SI-SDR, in dB, is the loosest: 4e-4
after 4 steps); the best-epoch decisions equal. The
final parameters: Adam moves a leaf about lr a step at most (ADAM_REACH
bounds how far above), so after 4 steps every element of both runs lies
within 4.04 lr of its start; the two runs'
parameters agree within 8e-2 lr (2e-2 lr a step, the train-step test's
bound for an element whose gradient is clearly away from zero) on at least
97 % of each leaf's elements, and every element within 2 lr: an element
whose gradient is within rounding of zero may take Adam's full step either
way (see tests/test_torch_train_step.py). The conv biases that feed a
BatchNorm have a zero gradient but for rounding, so they are held to that
bound alone. The BatchNorm running variances agree within 1e-5 of their
largest value; the running means are not compared, for each carries the
drift of the conv bias before it (up to 1e-2 of the mean).

Then, the port alone: a checkpoint round trip (the restored tensors equal
the saved ones bit for bit), resume equal to an uninterrupted run (1e-6),
preload with missing keys and a stale layout, the preemption save,
``only_validation``, the profiling window's Chrome trace, a tiny CRUSE+DF through the trainer (the deep-filter
path), and the CLI end to end on ``--device cpu`` with a tiny corpus,
whose ``model_NNNN.npz`` the infer CLI serves within 1e-4 of the trainer's
own validation enhancement.
"""
import os
import signal
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.dsp.stft import StftConfig as JaxStftConfig
from cruse_tpu.dsp.stft import stft as jax_stft
from cruse_tpu.models import CruseConfig as JaxCruseConfig
from cruse_tpu.models import CruseNet as JaxCruseNet
from cruse_tpu.train.step import StepConfig as JaxStepConfig
from cruse_tpu.train.trainer import Trainer as JaxTrainer
from cruse_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

from cruse_tpu_torch.data.manifest import write_manifest
from cruse_tpu_torch.data.wavio import read_wav, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.models import CruseConfig, CruseDfConfig, CruseDfNet, CruseNet
from cruse_tpu_torch.train import checkpoint
from cruse_tpu_torch.train.step import StepConfig
from cruse_tpu_torch.train.trainer import Trainer, TrainerConfig
from cruse_tpu_torch.utils.weights import state_dict_from_flax
from tests.test_torch_cruse_train import zero_gradient

TINY = dict(in_freq=161, channels=(4, 8, 8, 16), rnn_groups=4)
LR, EPOCHS, STEPS = 1e-3, 2, 2
METRICS = ("STOI", "SI_SDR", "WB_PESQ", "PMOS")
# Adam's bias-corrected step in the first steps can exceed lr: by Cauchy-Schwarz
# |m_hat / sqrt(v_hat)| <= sqrt(sum_i a_i^2 / b_i) with the moments' weights a_i, b_i,
# 1.0013 at step 2 for beta1 = 0.9, beta2 = 0.999, and below 1.01 up to step 4
ADAM_REACH = 1.01


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class RecordingWriter:
    """A TensorBoard stand-in that keeps what the trainer emits."""

    def __init__(self):
        self.scalars, self.validation = {}, {}

    def add_scalar(self, tag, value, step):
        self.scalars[(tag, step)] = float(value)

    def add_scalars(self, tag, values, step):
        self.validation[(tag, step)] = {k: float(v) for k, v in values.items()}

    def add_audio(self, *args, **kwargs):
        pass


def speech(rng, b, n):
    t = np.arange(n) / 16000
    f0 = rng.uniform(120, 260, (b, 1))
    clean = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    clean = 0.2 * clean * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 5, (b, 1)) * t))
    noisy = clean + 0.05 * rng.standard_normal((b, n))
    return {"noisy": noisy.astype(np.float32), "clean": clean.astype(np.float32)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    train = [speech(rng, 4, 16000) for _ in range(STEPS)]
    valid = [{**speech(rng, 2, 16000), "name": ["va", "vb"]}]
    return train, valid


def record_decisions(trainer):
    decisions = []
    decide = trainer._is_best_epoch

    def recorded(score):
        decisions.append(decide(score))
        return decisions[-1]

    trainer._is_best_epoch = recorded
    return decisions


@pytest.fixture(scope="module")
def both(data, tmp_path_factory):
    """Both trainers after 2 epochs from the same start."""
    train, valid = data
    root = tmp_path_factory.mktemp("parity")
    jax_model = JaxCruseNet(JaxCruseConfig(**TINY))
    feat = jax_model.compress(jnp.abs(jax_stft(jnp.asarray(train[0]["noisy"]), JaxStftConfig(n_fft=320, hop_length=160))))
    jwriter = RecordingWriter()
    jtrainer = JaxTrainer(
        jax_model, JaxStepConfig(stft=JaxStftConfig(n_fft=320, hop_length=160), learning_rate=LR),
        JaxTrainerConfig(epochs=EPOCHS, steps_per_epoch=STEPS, save_dir=str(root), experiment_name="jax",
                         metrics=METRICS, visualization_examples=0),
        train_batches=train, validation_batches=valid, example_feat=feat, rng=jax.random.PRNGKey(0),
        writer=jwriter)
    start = jax.tree_util.tree_map(np.asarray, {"params": jtrainer.state.params,
                                                "batch_stats": jtrainer.state.batch_stats})
    jdecisions = record_decisions(jtrainer)
    jtrainer.train()

    model = CruseNet(CruseConfig(**TINY))
    model.load_state_dict(state_dict_from_flax(start, model), strict=True)
    start_sd = {k: v.clone() for k, v in model.state_dict().items()}
    writer = RecordingWriter()
    trainer = Trainer(model, StepConfig(stft=StftConfig(n_fft=320, hop_length=160), learning_rate=LR),
                      TrainerConfig(epochs=EPOCHS, steps_per_epoch=STEPS, save_dir=str(root), experiment_name="port",
                                    metrics=METRICS, visualization_examples=0, num_metric_workers=1),
                      train_batches=train, validation_batches=valid, device="cpu", writer=writer)
    decisions = record_decisions(trainer)
    trainer.train()
    final_jax = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, {
        "params": jtrainer.state.params, "batch_stats": jtrainer.state.batch_stats}), model)
    return dict(jwriter=jwriter, writer=writer, jdecisions=jdecisions, decisions=decisions, jtrainer=jtrainer,
                trainer=trainer, start=start_sd, final_jax=final_jax, root=root)


def test_epoch_means_match_jax(both):
    ours, theirs = both["writer"].scalars, both["jwriter"].scalars
    assert ours.keys() == theirs.keys() and len(ours) == EPOCHS * 4
    for (tag, epoch), value in theirs.items():
        rtol = 2e-3 if tag == "Train/grad_norm" else 1e-4
        np.testing.assert_allclose(ours[(tag, epoch)], value, rtol=rtol, atol=1e-12, err_msg=f"{tag} {epoch}")


def test_validation_metrics_and_best_epochs_match_jax(both):
    ours, theirs = both["writer"].validation, both["jwriter"].validation
    assert ours.keys() == theirs.keys() and len(ours) == EPOCHS * len(METRICS)
    for key, values in theirs.items():
        for which in ("Noisy", "Enhanced"):
            np.testing.assert_allclose(ours[key][which], values[which], rtol=1e-3, atol=0, err_msg=f"{key} {which}")
    assert both["decisions"] == both["jdecisions"] and len(both["decisions"]) == EPOCHS
    np.testing.assert_allclose(both["trainer"].best_score, both["jtrainer"].best_score, rtol=0, atol=1e-3)
    assert both["trainer"].state.step == int(both["jtrainer"].state.step) == EPOCHS * STEPS


def test_final_parameters_match_jax(both):
    model = both["trainer"].state.model
    steps = EPOCHS * STEPS
    compared = 0
    for name, _ in model.named_parameters():
        ours, theirs = model.state_dict()[name].numpy(), both["final_jax"][name].numpy()
        start = both["start"][name].numpy()
        assert np.abs(ours - start).max() <= ADAM_REACH * steps * LR, name
        assert np.abs(theirs - start).max() <= ADAM_REACH * steps * LR, name
        if zero_gradient(model, name):
            continue  # a conv bias that feeds a BatchNorm: Adam's full step on rounding noise
        compared += 1
        err = np.abs(ours - theirs)
        assert err.max() <= 2 * LR, (name, err.max())
        assert np.mean(err <= 8e-2 * LR) >= 0.97, (name, np.mean(err <= 8e-2 * LR))
    assert compared >= 30
    variances = [k for k in model.state_dict() if k.endswith("running_var")]
    assert len(variances) == 7
    for name in variances:
        want = both["final_jax"][name].numpy()
        assert np.abs(model.state_dict()[name].numpy() - want).max() <= 1e-5 * np.abs(want).max(), name


def test_checkpoint_trio_round_trip(both):
    trainer = both["trainer"]
    ckpt = trainer.checkpoints_dir
    for name in ("latest", "best", "model_0001", "model_0002", "model_0002.npz"):
        assert (ckpt / name).is_file(), name
    saved = checkpoint.load_checkpoint(ckpt / "latest")
    assert saved["epoch"] == EPOCHS and saved["step"] == EPOCHS * STEPS and saved["opt_count"] == EPOCHS * STEPS
    fresh = CruseNet(CruseConfig(**TINY))
    state = Trainer(fresh, trainer.step_cfg, trainer.cfg, device="cpu", writer=False).state
    state, start_epoch, best = checkpoint.restore_checkpoint(ckpt, state)
    assert start_epoch == EPOCHS + 1 and best == saved["best_score"] == trainer.best_score
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, saved["model"][key]), key
    for got, want in zip(state.opt_state.mu + state.opt_state.nu, saved["opt_mu"] + saved["opt_nu"]):
        assert torch.equal(got, want)
    assert state.opt_state.count == saved["opt_count"] and state.step == saved["step"]
    for name in state.balancer_state.total:
        assert torch.equal(state.balancer_state.total[name], saved["balancer_total"][name])
    # the snapshot's flax layout is the model's weights
    from cruse_tpu_torch.utils.weights import load_flax_npz
    bridged = state_dict_from_flax(load_flax_npz(str(ckpt / "model_0002.npz")), fresh)
    for key, value in checkpoint.load_checkpoint(ckpt / "model_0002").items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(bridged[key], value), key


def port_trainer(root, name, data, epochs, model=None, **kw):
    train, valid = data
    model = model if model is not None else CruseNet(CruseConfig(**TINY), generator=torch.Generator().manual_seed(1))
    return Trainer(model, StepConfig(stft=StftConfig(n_fft=320, hop_length=160), learning_rate=LR),
                   TrainerConfig(epochs=epochs, steps_per_epoch=STEPS, save_dir=str(root), experiment_name=name,
                                 metrics=("STOI", "SI_SDR"), visualization_examples=0, num_metric_workers=1),
                   train_batches=kw.pop("train_batches", train), validation_batches=valid, device="cpu",
                   writer=False, **kw)


def test_resume_equals_an_uninterrupted_run(data, tmp_path):
    whole = port_trainer(tmp_path, "whole", data, 3)
    whole.train()
    first = port_trainer(tmp_path, "split", data, 2)
    first.train()
    resumed = port_trainer(tmp_path, "split", data, 3, resume=True)
    assert resumed.start_epoch == 3 and resumed.state.step == 2 * STEPS
    resumed.train()
    assert resumed.state.step == whole.state.step == 3 * STEPS
    for key, value in whole.state.model.state_dict().items():
        np.testing.assert_allclose(resumed.state.model.state_dict()[key].numpy(), value.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    assert resumed.best_score == pytest.approx(whole.best_score, abs=1e-6)


def test_preload_tolerates_missing_and_refuses_a_stale_layout(data, tmp_path):
    source = CruseNet(CruseConfig(**TINY), generator=torch.Generator().manual_seed(5))
    partial = {k: v for k, v in source.state_dict().items() if not k.startswith("dec_")}
    torch.save(partial, tmp_path / "partial")
    target = CruseNet(CruseConfig(**TINY), generator=torch.Generator().manual_seed(6))
    before = {k: v.clone() for k, v in target.state_dict().items()}
    counts = checkpoint.preload_params(tmp_path / "partial", target)
    assert counts["merged"] > 0 and counts["kept"] > 0
    for name, param in target.named_parameters():
        want = partial[name] if name in partial else before[name]
        assert torch.equal(param.detach(), want), name
    assert torch.equal(target.enc_0.bn.running_var, before["enc_0.bn.running_var"])  # statistics untouched
    torch.save({"old_layer.w": torch.zeros(3, 3)}, tmp_path / "stale")
    with pytest.raises(ValueError, match="0 of"):
        checkpoint.preload_params(tmp_path / "stale", target)
    torch.save({"enc_0.conv.weight": torch.zeros(1, 2, 3)}, tmp_path / "shape")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.preload_params(tmp_path / "shape", target)
    trainer = port_trainer(tmp_path, "pre", data, 1, preload_path=str(tmp_path / "partial"))
    assert torch.equal(trainer.state.model.enc_0.conv.weight.detach(), partial["enc_0.conv.weight"])


def test_preemption_saves_latest(data, tmp_path):
    train, _ = data
    sent = {"done": False}

    def batches():
        yield train[0]
        if not sent["done"]:
            sent["done"] = True
            os.kill(os.getpid(), signal.SIGTERM)
        yield train[1]

    trainer = port_trainer(tmp_path, "pre", data, 50, train_batches=batches)
    trainer.cfg.validation_interval = trainer.cfg.save_checkpoint_interval = 10**9
    trainer.train()  # returns instead of dying
    saved = checkpoint.load_checkpoint(trainer.checkpoints_dir / "latest")
    assert 0 < saved["step"] == trainer.state.step < 50 * STEPS and saved["epoch"] == 1
    resumed = port_trainer(tmp_path, "pre", data, 50, resume=True)
    assert resumed.start_epoch == 2 and resumed.state.step == saved["step"]


def test_only_validation(data, tmp_path):
    trainer = port_trainer(tmp_path, "val", data, 1)
    trainer.cfg.only_validation = True
    before = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    trainer.train()
    assert trainer.state.step == 0 and np.isfinite(trainer.best_score)
    assert (trainer.checkpoints_dir / "best").is_file()
    for key, value in trainer.state.model.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_profiling_window_writes_a_chrome_trace(data, tmp_path):
    trainer = port_trainer(tmp_path, "prof", data, 1)
    trainer.cfg.profiling = {"epoch": 1, "start_step": 1, "num_steps": 1, "trace_dir": str(tmp_path / "trace")}
    trainer.cfg.validation_interval = 10**9
    trainer.train()
    trace = tmp_path / "trace" / "epoch1_steps1-1.json"
    assert trace.is_file() and '"traceEvents"' in trace.read_text()


def test_cruse_df_trains_through_the_deep_filter(data, tmp_path):
    model = CruseDfNet(CruseDfConfig(cruse=CruseConfig(**TINY), df_bins=24, df_taps_t=1, df_taps_f=1),
                       generator=torch.Generator().manual_seed(3))
    head = {k: v.clone() for k, v in model.df_head.state_dict().items()}
    trainer = port_trainer(tmp_path, "df", data, 1, model=model)
    trainer.train()
    assert trainer.state.step == STEPS and np.isfinite(trainer.best_score)
    assert any(not torch.equal(v, model.df_head.state_dict()[k]) for k, v in head.items())
    assert (trainer.checkpoints_dir / "model_0001.npz").is_file()


def write_corpus(root):
    rng = np.random.default_rng(7)
    files = {"clean": [], "noise": []}
    for i in range(6):
        files["clean"].append(str(root / f"clean_{i}.wav"))
        write_wav(files["clean"][-1], speech(rng, 1, 32000)["clean"][0], 16000)
        files["noise"].append(str(root / f"noise_{i}.wav"))
        write_wav(files["noise"][-1], (0.1 * rng.standard_normal(32000)).astype(np.float32), 16000)
    for kind in files:
        write_manifest(files[kind][:4], str(root / f"{kind}_train.txt"))
        write_manifest(files[kind][4:], str(root / f"{kind}_valid.txt"))
    return files


def test_cli_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    from cruse_tpu_torch.infer.__main__ import main as infer_main
    from cruse_tpu_torch.train.__main__ import build_trainer, main, parse_args

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no TensorBoard writer
    files = write_corpus(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(root, "configs", "tiny_cruse.toml")).read().replace("/tmp/corpus/runs", str(tmp_path / "runs"))
    config = tmp_path / "tiny.toml"
    config.write_text(text.replace("/tmp/corpus", str(tmp_path)).replace("epochs = 1", "epochs = 2"))
    trainer = main(["-C", str(config), "--device", "cpu"])
    ckpt = tmp_path / "runs" / "tiny_cruse" / "checkpoints"
    assert trainer.state.step == 4 and all((ckpt / n).is_file() for n in ("latest", "best", "model_0002.npz"))
    log = (tmp_path / "runs" / "tiny_cruse" / "train.log").read_text()
    assert log.count("composite score") == 2 and "epoch 2 loss_si_snr" in log

    # serve the snapshot: the infer CLI against the trainer's own enhancement
    clips = tmp_path / "clips"
    clips.mkdir()
    for f in files["clean"][4:]:
        os.link(f, clips / os.path.basename(f))
    infer_main(["-C", str(config), "-I", str(clips), "-O", str(tmp_path / "out"),
                "--weights", str(ckpt / "model_0002.npz"), "--device", "cpu"])
    for f in sorted(clips.iterdir()):
        served = read_wav(str(tmp_path / "out" / f.name))[0]
        own = trainer.enhance(torch.from_numpy(read_wav(str(f))[0][None]))[0].numpy()
        own = 0.8 * 32767 * own / np.abs(own).max() / 32768  # to_int16_scaled, read back
        assert np.abs(served - own).max() <= 1e-4

    config.write_text(config.read_text().replace("epochs = 2", "epochs = 3"))
    resumed = build_trainer(parse_args(["-C", str(config), "-R", "--device", "cpu"]))
    assert resumed.start_epoch == 3
    saved = checkpoint.load_checkpoint(ckpt / "latest")
    for key, value in resumed.state.model.state_dict().items():
        assert torch.equal(value, saved["model"][key]), key
    resumed.train()
    assert resumed.state.step == 6
    with pytest.raises(SystemExit, match="item 9"):
        main(["-C", str(config), "-N", "2", "--device", "cpu"])
