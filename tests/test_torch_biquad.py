"""Port parity: cruse_tpu_torch.dsp.biquad against cruse_tpu.dsp.biquad on the
CPU.

- ``biquad_coeffs`` for all six kinds over seeded frequencies, gains and Qs,
  rtol 1e-5.
- ``lfilter`` at L = 4,800, both methods, within 1e-4 of max|y|: the port's
  sequential ``scan`` and its log-depth ``doubling`` scan against the JAX
  package's sequential ``scan``, and the doubling scan against the JAX
  package's associative form wherever that form is within 5e-5 of its own
  sequential form. In float32 a parallel form loses precision where the
  poles sit near z = 1 (a 40 Hz low shelf at +12 dB: the JAX associative form
  misses its sequential form by about 1e-2 of max|y|), so the port runs its
  doubling scan in float64; it is held to a float64 sequential run within
  1e-6 of max|y| at every filter.
- ``sos_chain`` and ``eq_chain_from_draws`` with the draws the test derives
  from JAX keys exactly as ``random_eq_chain`` splits them: the chain's
  coefficients within rtol 1e-5, and its output against the same chain run
  section by section through the JAX package's sequential ``lfilter``
  (1e-4 of max|y|) and against ``random_eq_chain`` itself wherever its
  associative form is within 5e-5 of the sequential chain.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.dsp import biquad as jb

from cruse_tpu_torch.dsp import biquad as tb

L = 4800
SR = 16000.0
FILTERS = (("high_pass", 40.0, 0.0, 0.7), ("low_shelf", 40.0, 12.0, 1.0), ("high_shelf", 3000.0, -9.0, 0.8),
           ("low_pass", 3500.0, 0.0, 1.4), ("peaking_eq", 1000.0, -10.0, 1.2), ("notch", 60.0, 0.0, 0.5))
ASSOC_AGREES = 5e-5  # the JAX associative form within this of its own sequential form


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).standard_normal((3, L)).astype(np.float32)


def rel(a, b, scale):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / scale)


@pytest.mark.parametrize("kind", tb.FILTER_KINDS)
def test_coefficients_match_jax(kind):
    rng = np.random.default_rng(1)
    lo, hi = tb.FILTER_FREQ_RANGES[kind]
    f = np.exp(rng.uniform(np.log(lo), np.log(hi), 16)).astype(np.float32)
    g = rng.uniform(-15, 15, 16).astype(np.float32)
    q = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bj, aj = jax.vmap(lambda f, g, q: jb.biquad_coeffs(kind, f, g, q, SR))(f, g, q)
    bt, at = tb.biquad_coeffs(kind, torch.from_numpy(f), torch.from_numpy(g), torch.from_numpy(q), SR)
    assert bt.dtype == torch.float32 and bt.shape == (16, 3)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5, atol=1e-7)
    assert np.all(at.numpy()[:, 0] == 1.0)


@pytest.mark.parametrize("spec", FILTERS, ids=[f[0] for f in FILTERS])
def test_lfilter_matches_jax(x, spec):
    b, a = tb.biquad_coeffs(*spec, SR)
    xt = torch.from_numpy(x)
    doubling, scan = tb.lfilter(xt, b, a), tb.lfilter(xt, b, a, method="scan")
    exact = tb.lfilter(xt.double(), b.double(), a.double(), method="scan")
    jax_scan = jb.lfilter(jnp.asarray(x), jnp.asarray(b.numpy()), jnp.asarray(a.numpy()), method="scan")
    jax_assoc = jb.lfilter(jnp.asarray(x), jnp.asarray(b.numpy()), jnp.asarray(a.numpy()))
    scale = float(np.abs(np.asarray(jax_scan)).max())
    assert doubling.dtype == torch.float32 and doubling.shape == xt.shape
    assert rel(doubling, jax_scan, scale) < 1e-4
    assert rel(scan, jax_scan, scale) < 1e-4
    assert rel(doubling, exact, scale) < 1e-6
    if rel(jax_assoc, jax_scan, scale) < ASSOC_AGREES:
        assert rel(doubling, jax_assoc, scale) < 1e-4


def test_lfilter_broadcasts_per_row_coefficients(x):
    """One filter a row equals each row filtered alone."""
    rows = [tb.biquad_coeffs(*spec, SR) for spec in FILTERS[:3]]
    b, a = torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])
    xt = torch.from_numpy(x)
    together = tb.lfilter(xt, b, a)
    for i in range(3):
        np.testing.assert_allclose(together[i].numpy(), tb.lfilter(xt[i], b[i], a[i]).numpy(), rtol=0, atol=1e-7)


def jax_draws(key, num_filters):
    """random_eq_chain's draws, split from its key as it splits them."""
    kinds, us, gains, qs = [], [], [], []
    for k in jax.random.split(key, num_filters):
        k_kind, k_freq, k_gain, k_q = jax.random.split(k, 4)
        kinds.append(int(jax.random.randint(k_kind, (), 0, len(jb.FILTER_KINDS))))
        us.append(float(jax.random.uniform(k_freq, ())))
        gains.append(float(jax.random.uniform(k_gain, (), minval=-15.0, maxval=15.0)))
        qs.append(float(jax.random.uniform(k_q, (), minval=0.5, maxval=1.5)))
    return tb.EqDraws(kind=torch.tensor(kinds), u=torch.tensor(us, dtype=torch.float32),
                      gain_db=torch.tensor(gains, dtype=torch.float32), q=torch.tensor(qs, dtype=torch.float32))


@pytest.mark.parametrize("seed", range(6))
def test_eq_chain_from_jax_draws(x, seed):
    key = jax.random.PRNGKey(seed)
    draws = jax_draws(key, 3)
    b, a = tb.eq_chain_coeffs(draws, SR)  # [S, 3]
    lo = np.log(np.asarray([jb.FILTER_FREQ_RANGES[k][0] for k in jb.FILTER_KINDS], np.float32))
    hi = np.log(np.asarray([jb.FILTER_FREQ_RANGES[k][1] for k in jb.FILTER_KINDS], np.float32))
    jax_b, jax_a = [], []
    for s in range(3):
        kind = jb.FILTER_KINDS[int(draws.kind[s])]
        freq = jnp.exp(lo + float(draws.u[s]) * (hi - lo))[int(draws.kind[s])]
        bj, aj = jb.biquad_coeffs(kind, freq, float(draws.gain_db[s]), float(draws.q[s]), SR)
        jax_b.append(np.asarray(bj))
        jax_a.append(np.asarray(aj))
    np.testing.assert_allclose(b.numpy(), np.stack(jax_b), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(a.numpy(), np.stack(jax_a), rtol=1e-5, atol=1e-7)

    ours = tb.eq_chain_from_draws(torch.from_numpy(x), tb.EqDraws(
        kind=draws.kind.expand(3, 3), u=draws.u.expand(3, 3), gain_db=draws.gain_db.expand(3, 3),
        q=draws.q.expand(3, 3)), SR)
    sequential = jnp.asarray(x)
    for bj, aj in zip(jax_b, jax_a):
        sequential = jb.lfilter(sequential, jnp.asarray(bj), jnp.asarray(aj), method="scan")
    scale = float(np.abs(np.asarray(sequential)).max())
    assert rel(ours, sequential, scale) < 1e-4
    np.testing.assert_allclose(tb.sos_chain(torch.from_numpy(x), b, a).numpy(), ours.numpy(), rtol=0, atol=0)
    jax_chain = jb.random_eq_chain(key, jnp.asarray(x), 3, SR)
    if rel(jax_chain, sequential, scale) < ASSOC_AGREES:
        assert rel(ours, jax_chain, scale) < 1e-4


def test_draws_stay_in_range():
    gen = torch.Generator().manual_seed(0)
    d = tb.draw_eq(gen, (4096,), 3)
    assert d.kind.shape == (4096, 3) and set(d.kind.unique().tolist()) == set(range(len(tb.FILTER_KINDS)))
    assert ((d.u >= 0) & (d.u < 1)).all()
    assert ((d.gain_db >= -15) & (d.gain_db <= 15)).all() and ((d.q >= 0.5) & (d.q <= 1.5)).all()
    y = tb.random_eq_chain(torch.randn(4, 800, generator=gen), gen)
    assert y.shape == (4, 800) and torch.isfinite(y).all()
    hp = tb.hp_filter(torch.randn(2, 800, generator=gen), gen)
    assert hp.shape == (2, 800) and torch.isfinite(hp).all()
