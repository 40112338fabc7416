"""Port parity: the deep filter of cruse_tpu_torch against cruse_tpu, on the
CPU (the wrapper's plain version).

Inputs come from a numpy seed and go through both packages: the port's
``deep_filter_reference`` and ``deep_filter`` against the JAX shift-MAC
``deep_filter_apply`` (causal and symmetric) and against the Pallas kernel
``deep_filter_pallas`` run in interpret mode, as cruse_tpu's own tests run
it; the history form frame by frame against ``apply_cruse_df_streaming``.
Tolerance 1e-5: float32 sums of the same 15 products in the same order.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.models.cruse_df import CruseDfConfig as JaxCruseDfConfig
from cruse_tpu.models.cruse_df import apply_cruse_df_streaming as jax_apply_cruse_df_streaming
from cruse_tpu.models.cruse_df import df_stream_init as jax_df_stream_init
from cruse_tpu.models.deep_filter import DeepFilterHead as JaxDeepFilterHead
from cruse_tpu.models.deep_filter import deep_filter_apply as jax_deep_filter_apply
from cruse_tpu.models.deep_filter import tap_offsets as jax_tap_offsets

from cruse_tpu_torch.models.cruse import CruseConfig
from cruse_tpu_torch.models.cruse_df import CruseDfConfig, apply_cruse_df_streaming, df_stream_init
from cruse_tpu_torch.models.deep_filter import DeepFilterHead, _shift2d, deep_filter_apply, tap_offsets
from cruse_tpu_torch.ops.deep_filter_kernel import deep_filter, deep_filter_reference
from cruse_tpu_torch.utils.weights import flatten_tree


def _inputs(rng, b, t, f, t_dim, f_dim, causal):
    k = len(tap_offsets(t_dim, f_dim, causal))
    spec = (rng.standard_normal((b, t, f)) + 1j * rng.standard_normal((b, t, f))).astype(np.complex64)
    coefs = (rng.standard_normal((b, t, f, k, 2)) * 0.2).astype(np.float32)
    return spec, coefs


def _jax_apply(spec, coefs, t_dim, f_dim, causal):
    out_r, out_i = jax_deep_filter_apply(jnp.asarray(spec.real), jnp.asarray(spec.imag),
                                         jnp.asarray(coefs[..., 0]), jnp.asarray(coefs[..., 1]),
                                         t_dim, f_dim, causal=causal)
    return np.asarray(out_r) + 1j * np.asarray(out_i)


def _jax_pallas(spec, coefs, t_dim, f_dim):
    from jax.experimental.pallas import tpu as pltpu
    import cruse_tpu.ops.deep_filter_kernel as dfk

    with pltpu.force_tpu_interpret_mode():
        out_r, out_i = dfk.deep_filter_pallas(
            jnp.asarray(spec.real), jnp.asarray(spec.imag), jnp.asarray(coefs[..., 0]),
            jnp.asarray(coefs[..., 1]), t_dim, f_dim)
    return np.asarray(out_r) + 1j * np.asarray(out_i)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "symmetric"])
@pytest.mark.parametrize("t_dim,f_dim", [(1, 1), (2, 1), (1, 2), (0, 1)])
def test_reference_matches_deep_filter_apply(rng, t_dim, f_dim, causal):
    assert tap_offsets(t_dim, f_dim, causal) == jax_tap_offsets(t_dim, f_dim, causal)
    spec, coefs = _inputs(rng, 2, 11, 24, t_dim, f_dim, causal)
    want = _jax_apply(spec, coefs, t_dim, f_dim, causal)
    got = deep_filter_reference(torch.from_numpy(spec), torch.from_numpy(coefs), t_dim, f_dim, causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the JAX-signature apply, through the wrapper (CPU: the plain version)
    out_r, out_i = deep_filter_apply(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        spec.real, spec.imag, coefs[..., 0], coefs[..., 1])), t_dim, f_dim, causal)
    np.testing.assert_allclose(out_r.numpy() + 1j * out_i.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("t_dim,f_dim,t,f", [(1, 1, 40, 64), (2, 1, 200, 96)])
def test_wrapper_matches_pallas_interpret(rng, t_dim, f_dim, t, f):
    spec, coefs = _inputs(rng, 2, t, f, t_dim, f_dim, True)
    want = _jax_pallas(spec, coefs, t_dim, f_dim)
    got = deep_filter(torch.from_numpy(spec), torch.from_numpy(coefs), t_dim, f_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_block_boundary_impulse_matches_pallas_interpret():
    """An impulse at frame 127, the TPU kernel's 128-frame block edge, lands
    at frames 127..131 in both (taps dt = 0..4)."""
    b, t, f, t_dim, f_dim = 1, 300, 32, 2, 0
    spec = np.zeros((b, t, f), np.complex64)
    spec[0, 127] = 1.0
    coefs = np.zeros((b, t, f, 5, 2), np.float32)
    coefs[..., 0] = 1.0
    want = _jax_pallas(spec, coefs, t_dim, f_dim)
    got = deep_filter(torch.from_numpy(spec), torch.from_numpy(coefs), t_dim, f_dim).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[0, 129, 0] == 1.0 and got[0, 131, 0] == 1.0 and got[0, 132, 0] == 0.0


def test_strided_low_bin_slice_matches_copy(rng):
    """The low bins of a wider spectrum go in as a strided view (the
    kernel's row stride); the result equals that of a contiguous copy."""
    full, coefs = _inputs(rng, 2, 9, 40, 2, 1, True)
    view = torch.from_numpy(full)[:, :, :24]
    c = torch.from_numpy(coefs[:, :, :24].copy())
    torch.testing.assert_close(deep_filter(view, c, 2, 1), deep_filter(view.contiguous(), c, 2, 1),
                               rtol=0, atol=0)


def test_history_form_matches_jax_streaming(rng):
    """Frame by frame with the carried history: the port's
    apply_cruse_df_streaming (deep_filter with history) against cruse_tpu's,
    and both against the whole-utterance filter."""
    cfg = CruseDfConfig(cruse=CruseConfig(channels=(4, 8)), df_bins=24, df_taps_t=2, df_taps_f=1)
    jcfg = JaxCruseDfConfig(df_bins=24, df_taps_t=2, df_taps_f=1)
    b, t, f = 2, 9, 40
    spec = (rng.standard_normal((b, t, f)) + 1j * rng.standard_normal((b, t, f))).astype(np.complex64)
    mask = rng.uniform(0.2, 1.0, (b, t, f)).astype(np.float32)
    coefs = (rng.standard_normal((b, t, 24, cfg.num_taps, 2)) * 0.2).astype(np.float32)
    state, jstate = df_stream_init(b, cfg), jax_df_stream_init(b, jcfg)
    ours, ref = [], []
    for i in range(t):
        out, state = apply_cruse_df_streaming(state, torch.from_numpy(spec[:, i]),
                                              torch.from_numpy(mask[:, i]),
                                              torch.from_numpy(coefs[:, i]), cfg)
        jout, jstate = jax_apply_cruse_df_streaming(jstate, jnp.asarray(spec[:, i]),
                                                    jnp.asarray(mask[:, i]),
                                                    jnp.asarray(coefs[:, i]), jcfg)
        ours.append(out.numpy())
        ref.append(np.asarray(jout))
    np.testing.assert_allclose(np.stack(ours, 1), np.stack(ref, 1), atol=1e-5)
    np.testing.assert_allclose(state.spec_history.numpy(), np.asarray(jstate.spec_history),
                               atol=1e-6)
    whole = deep_filter(torch.from_numpy(spec * mask)[:, :, :24], torch.from_numpy(coefs), 2, 1)
    np.testing.assert_allclose(np.stack(ours, 1)[:, :, :24], whole.numpy(), atol=1e-5)


def test_history_is_read_before_the_first_frame(rng):
    """A history equals prepending its frames to the spectrum (with any
    coefficients for them) and dropping their outputs."""
    spec, coefs = _inputs(rng, 2, 3, 16, 2, 1, True)
    hist = (rng.standard_normal((2, 4, 16)) + 1j * rng.standard_normal((2, 4, 16))).astype(np.complex64)
    got = deep_filter(torch.from_numpy(spec), torch.from_numpy(coefs), 2, 1,
                      history=torch.from_numpy(hist))
    ext = deep_filter(torch.from_numpy(np.concatenate([hist, spec], 1)),
                      torch.from_numpy(np.concatenate([np.zeros_like(coefs[:, :1]).repeat(4, 1),
                                                       coefs], 1)), 2, 1)
    torch.testing.assert_close(got, ext[:, 4:], rtol=0, atol=1e-6)


def test_shift2d_zero_fill():
    x = torch.arange(12.0).reshape(1, 3, 4)
    torch.testing.assert_close(_shift2d(x, 1, -1), torch.tensor(
        [[[0.0, 0.0, 0.0, 0.0], [1.0, 2.0, 3.0, 0.0], [5.0, 6.0, 7.0, 0.0]]]))
    torch.testing.assert_close(_shift2d(x, -1, 2), torch.tensor(
        [[[0.0, 0.0, 4.0, 5.0], [0.0, 0.0, 8.0, 9.0], [0.0, 0.0, 0.0, 0.0]]]))


def test_deep_filter_head_matches_jax(rng):
    d, t_dim, f_dim, f = 12, 1, 2, 20
    feats = rng.standard_normal((2, 6, d)).astype(np.float32)
    spec = (rng.standard_normal((2, 6, f)) + 1j * rng.standard_normal((2, 6, f))).astype(np.complex64)
    jm = JaxDeepFilterHead(t_dim=t_dim, f_dim=f_dim, num_freqs=f)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(spec))
    ref = np.asarray(jm.apply(variables, jnp.asarray(feats), jnp.asarray(spec)))
    head = DeepFilterHead(d, t_dim, f_dim, num_freqs=f)
    params = flatten_tree(variables["params"])
    head.load_state_dict({"coef_head.weight": torch.from_numpy(params["coef_head/kernel"].T.copy()),
                          "coef_head.bias": torch.from_numpy(params["coef_head/bias"])}, strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(feats), torch.from_numpy(spec))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_wrapper_on_cpu_counts_no_launch(rng):
    spec, coefs = _inputs(rng, 2, 5, 8, 1, 1, True)
    before = deep_filter.launches
    got = deep_filter(torch.from_numpy(spec), torch.from_numpy(coefs), 1, 1)
    assert deep_filter.launches == before
    torch.testing.assert_close(got, deep_filter_reference(torch.from_numpy(spec),
                                                          torch.from_numpy(coefs), 1, 1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["taps", "coef_dtype", "spec_dtype", "history_shape",
                                  "history_symmetric", "meta_device"])
def test_wrapper_rejects(rng, case):
    spec, coefs = (torch.from_numpy(a) for a in _inputs(rng, 2, 5, 8, 1, 1, True))
    history, causal = None, True
    if case == "taps":
        coefs = coefs[..., :-1, :]
    elif case == "coef_dtype":
        coefs = coefs.double()
    elif case == "spec_dtype":
        spec = spec.to(torch.complex128)
    elif case == "history_shape":
        history = torch.zeros(2, 3, 8, dtype=torch.complex64)
    elif case == "history_symmetric":
        history, causal = torch.zeros(2, 2, 8, dtype=torch.complex64), False
        coefs = coefs[..., :9, :]
    else:  # neither cpu nor cuda: no path runs the plain version instead
        spec, coefs = spec.to("meta"), coefs.to("meta")
    with pytest.raises(ValueError):
        deep_filter(spec, coefs, 1, 1, causal, history)
