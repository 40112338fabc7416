"""Port parity: the deep filter of cruse_tpu_torch against cruse_tpu, on the
CPU (the wrapper's plain version).

Inputs come from a numpy seed and go through both packages: the port's
``deep_filter_reference`` and ``deep_filter`` against the JAX shift-MAC
``deep_filter_apply`` (causal and symmetric) and against the Pallas kernel
``deep_filter_pallas`` run in interpret mode, as cruse_tpu's own tests run
it; the history form frame by frame against ``apply_cruse_df_streaming``.
Tolerance 1e-5: float32 sums of the same 15 products in the same order.

The backward: ``deep_filter_backward_reference`` against ``jax.vjp`` of
``deep_filter_apply`` and of the T-minor ``deep_filter_apply_tm`` that
JAX's MTFAA step differentiates; ``deep_filter`` under autograd on the CPU;
``df_plan``'s tiles, and ``deep_filter_bwd_walk_reference`` (the backward
kernel's walk) against the plain backward.
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
from cruse_tpu.models.deep_filter import deep_filter_apply_tm as jax_deep_filter_apply_tm
from cruse_tpu.models.deep_filter import tap_offsets as jax_tap_offsets

from cruse_tpu_torch.models.cruse import CruseConfig
from cruse_tpu_torch.models.cruse_df import CruseDfConfig, apply_cruse_df_streaming, df_stream_init
from cruse_tpu_torch.models.deep_filter import DeepFilterHead, _shift2d, deep_filter_apply, tap_offsets
from cruse_tpu_torch.ops.deep_filter_kernel import (
    MAX_SMEM, deep_filter, deep_filter_backward_reference, deep_filter_bwd, deep_filter_bwd_walk_reference,
    deep_filter_reference, df_plan, df_walk)
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


def _cotangent(rng, b, t, f):
    return (rng.standard_normal((b, t, f)) + 1j * rng.standard_normal((b, t, f))).astype(np.complex64)


def _torch_backward(grad, spec, coefs, t_dim, f_dim, causal):
    dspec, dcoefs = deep_filter_backward_reference(*(torch.from_numpy(a) for a in (grad, spec, coefs)),
                                                   t_dim, f_dim, causal)
    return dspec.numpy(), dcoefs.numpy()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "symmetric"])
@pytest.mark.parametrize("t_dim,f_dim", [(1, 1), (2, 1), (1, 2), (0, 1)])
def test_backward_reference_matches_jax_vjp(rng, t_dim, f_dim, causal):
    """dspec (as d/dRe + i d/dIm) and dcoefs against jax.vjp of
    deep_filter_apply with a seeded cotangent; tolerance 1e-5 (float32 sums
    of at most 15 products)."""
    spec, coefs = _inputs(rng, 2, 11, 24, t_dim, f_dim, causal)
    grad = _cotangent(rng, 2, 11, 24)
    _, vjp = jax.vjp(lambda sr, si, cr, ci: jax_deep_filter_apply(sr, si, cr, ci, t_dim, f_dim, causal=causal),
                     *(jnp.asarray(a) for a in (spec.real, spec.imag, coefs[..., 0], coefs[..., 1])))
    dsr, dsi, dcr, dci = (np.asarray(a) for a in vjp((jnp.asarray(grad.real), jnp.asarray(grad.imag))))
    dspec, dcoefs = _torch_backward(grad, spec, coefs, t_dim, f_dim, causal)
    np.testing.assert_allclose(dspec, dsr + 1j * dsi, atol=1e-5)
    np.testing.assert_allclose(dcoefs, np.stack([dcr, dci], -1), atol=1e-5)


def test_backward_reference_matches_jax_vjp_tm(rng):
    """The T-minor apply that JAX's MTFAA step differentiates (spec [B, F,
    T], coefs [B, F, K, T]), at config 5b's taps, with transposed inputs;
    tolerance 1e-5."""
    t_dim, f_dim = 1, 1
    spec, coefs = _inputs(rng, 2, 13, 20, t_dim, f_dim, True)
    grad = _cotangent(rng, 2, 13, 20)
    tm = lambda x: jnp.asarray(np.ascontiguousarray(np.moveaxis(x, 1, -1)))  # noqa: E731  [B, T, ...] -> [B, ..., T]
    _, vjp = jax.vjp(lambda sr, si, cr, ci: jax_deep_filter_apply_tm(sr, si, cr, ci, t_dim, f_dim, causal=True),
                     tm(spec.real), tm(spec.imag), tm(coefs[..., 0]), tm(coefs[..., 1]))
    dsr, dsi, dcr, dci = (np.moveaxis(np.asarray(a), -1, 1) for a in vjp((tm(grad.real), tm(grad.imag))))
    dspec, dcoefs = _torch_backward(grad, spec, coefs, t_dim, f_dim, True)
    np.testing.assert_allclose(dspec, dsr + 1j * dsi, atol=1e-5)
    np.testing.assert_allclose(dcoefs, np.stack([dcr, dci], -1), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "symmetric"])
def test_wrapper_backward_on_cpu_matches_autograd(rng, causal):
    """deep_filter under autograd on the CPU (its autograd.Function with the
    plain backward) against autograd.grad through deep_filter_reference,
    within 1e-6; no kernel launch is counted."""
    spec, coefs = _inputs(rng, 2, 9, 16, 1, 1, causal)
    grad = torch.from_numpy(_cotangent(rng, 2, 9, 16))
    before = deep_filter.launches, deep_filter_bwd.launches
    results = []
    for fn in (deep_filter, deep_filter_reference):
        s = torch.from_numpy(spec).requires_grad_()
        c = torch.from_numpy(coefs).requires_grad_()
        out = fn(s, c, 1, 1, causal)
        results.append((out.detach(), *torch.autograd.grad(out, (s, c), grad)))
    assert (deep_filter.launches, deep_filter_bwd.launches) == before
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # one input with a gradient: the other gets none
    c = torch.from_numpy(coefs).requires_grad_()
    (dc,) = torch.autograd.grad(deep_filter(torch.from_numpy(spec), c, 1, 1, causal), (c,), grad)
    torch.testing.assert_close(dc, results[1][2], rtol=0, atol=1e-6)


def test_gradient_with_history_raises(rng):
    spec, coefs = (torch.from_numpy(a) for a in _inputs(rng, 2, 3, 16, 2, 1, True))
    history = torch.zeros(2, 4, 16, dtype=torch.complex64)
    with pytest.raises(ValueError, match="history"):
        deep_filter(spec.requires_grad_(), coefs, 2, 1, history=history)
    with torch.no_grad():  # the streaming form itself runs
        assert deep_filter(spec, coefs, 2, 1, history=history).shape == (2, 3, 16)
    with pytest.raises(ValueError, match="history"):
        df_plan(2, 3, 16, 2, 1, True, True, backward=True)


def test_deep_filter_bwd_on_cpu_is_the_plain_backward(rng):
    spec, coefs = _inputs(rng, 2, 7, 12, 2, 1, True)
    grad = _cotangent(rng, 2, 7, 12)
    got = deep_filter_bwd(*(torch.from_numpy(a) for a in (grad, spec, coefs)), 2, 1, True)
    for x, y in zip(got, _torch_backward(grad, spec, coefs, 2, 1, True)):
        np.testing.assert_array_equal(x.numpy(), y)


# B, T, F, t_dim, f_dim, causal, history: config 5b, config 3 offline and its hop, ragged ones
PLAN_SHAPES = [(16, 626, 257, 1, 1, True, False), (256, 1001, 96, 2, 1, True, False),
               (256, 1, 96, 2, 1, True, True), (3, 7, 24, 1, 1, True, False), (3, 3, 24, 2, 1, True, False),
               (3, 9, 20, 1, 2, False, False), (1, 1500, 1024, 2, 2, True, False)]


@pytest.mark.parametrize("shape,backward", [(s, bw) for s in PLAN_SHAPES for bw in (False, True)
                                            if not (bw and s[-1])],  # a history goes with the forward only
                         ids=lambda x: "x".join(map(str, x[:5])) if isinstance(x, tuple) else ("bwd" if x else "fwd"))
def test_df_plan_is_a_legal_tile(shape, backward):
    """Every frame and bin is owned by one block; a span's walk reaches 2
    t_dim frames back (forward: the spectrum its taps read) or out (backward:
    the g and coefficient frames whose taps reach its dspec); a block fits
    the card."""
    b, t, f, t_dim, f_dim, causal, history = shape
    plan = df_plan(b, t, f, t_dim, f_dim, causal, history, backward)
    assert plan.smem <= MAX_SMEM and plan.threads <= 1024 and plan.threads >= plan.bins
    assert plan.blocks == b * -(-t // plan.span) * -(-f // plan.bins) and plan.blocks_per_sm >= 1
    owned = [u for t0, nt, _, _ in df_walk(t, plan.span, t_dim, causal, backward) for u in range(t0, t0 + nt)]
    assert owned == list(range(t))
    assert sorted(f0 + i for f0 in range(0, f, plan.bins) for i in range(min(plan.bins, f - f0))) == list(range(f))
    dt_min = 0 if causal else -t_dim
    for t0, nt, first, last in df_walk(t, plan.span, t_dim, causal, backward):
        if backward:  # dspec[tau] needs g and coefs at tau + dt for every tap
            assert (first, last) == (t0 + dt_min, t0 + nt - 1 + dt_min + 2 * t_dim)
        else:  # out[u] reads the spectrum at u - dt for every tap
            assert (first, last) == (t0 - dt_min - 2 * t_dim, t0 + nt - 1 - dt_min)
        assert last - first == nt - 1 + 2 * t_dim


@pytest.mark.parametrize("bad", ["span0", "span_long", "bins0", "bins_wide", "smem", "threads"])
def test_df_plan_refuses_bad_plans(bad):
    b, t, f = 2, 50, 300
    kwargs = {"span0": {"span": 0}, "span_long": {"span": 51}, "bins0": {"bins": 0},
              "bins_wide": {"bins": 301}}.get(bad, {})
    if bad == "smem":  # 600 bins x 25 taps do not fit
        with pytest.raises(ValueError):
            df_plan(b, t, 600, 2, 2, bins=600)
        assert df_plan(b, t, 600, 2, 2).smem <= MAX_SMEM  # the plan splits the bins instead
        return
    if bad == "threads":
        with pytest.raises(ValueError):
            df_plan(1, 4, 1100, 0, 0, bins=1100)
        assert df_plan(1, 4, 1100, 0, 0).threads <= 1024
        return
    with pytest.raises(ValueError):
        df_plan(b, t, f, 1, 1, **kwargs)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "symmetric"])
@pytest.mark.parametrize("t_dim,f_dim,span,bins", [(1, 1, 4, 24), (2, 1, 3, 10), (1, 2, 5, 7), (0, 1, 2, 24),
                                                   (2, 1, 13, 24), (1, 1, 1, 6)])
def test_bwd_walk_reference_matches_plain_backward(rng, causal, t_dim, f_dim, span, bins):
    """The backward kernel's walk, span by span and range by range (spans and
    ranges that split T = 13 and F = 24 raggedly, T < 2 t_dim + span), gives
    the plain backward within 1e-5 and stores every value once."""
    spec, coefs = _inputs(rng, 2, 13, 24, t_dim, f_dim, causal)
    grad = _cotangent(rng, 2, 13, 24)
    plan = df_plan(2, 13, 24, t_dim, f_dim, causal, backward=True, span=span, bins=bins)
    got = deep_filter_bwd_walk_reference(*(torch.from_numpy(a) for a in (grad, spec, coefs)), t_dim, f_dim,
                                         causal, plan)
    for x, y in zip(got, _torch_backward(grad, spec, coefs, t_dim, f_dim, causal)):
        np.testing.assert_allclose(x.numpy(), y, atol=1e-5)


def test_conjugated_tensors_reach_the_launchers_resolved(rng, monkeypatch):
    """A lazily conjugated spec, history or cotangent (``.conj()``, or the
    gradient that comes back through ``.conj()`` of the output) is resolved
    before the launch: the kernels read ``data_ptr()``, the values before the
    conjugation. The launchers are replaced by recorders that fill their
    outputs with the plain versions, and the CUDA route is taken on CPU
    tensors; the results match the plain versions on resolved inputs."""
    import cruse_tpu_torch.ops.deep_filter_kernel as dfk

    seen = []

    def fake_fwd(spec, coefs, t_dim, f_dim, causal, history, plan, out):
        seen.extend(x for x in (spec, coefs, history, out) if x is not None)
        out.copy_(deep_filter_reference(spec, coefs, t_dim, f_dim, causal, history))

    def fake_bwd(grad, spec, coefs, t_dim, f_dim, causal, plan, dspec, dcoefs):
        seen.extend((grad, spec, coefs, dspec, dcoefs))
        want = deep_filter_backward_reference(grad, spec, coefs, t_dim, f_dim, causal)
        dspec.copy_(want[0])
        dcoefs.copy_(want[1])

    monkeypatch.setattr(dfk, "_runs_plain", lambda spec: False)
    monkeypatch.setattr(dfk, "launch_df_fwd", fake_fwd)
    monkeypatch.setattr(dfk, "launch_df_bwd", fake_bwd)
    spec, coefs = (torch.from_numpy(a) for a in _inputs(rng, 2, 9, 16, 2, 1, True))
    grad = torch.from_numpy(_cotangent(rng, 2, 9, 16))
    history = torch.from_numpy(_cotangent(rng, 2, 4, 16))
    plain = spec.conj().resolve_conj()

    got = deep_filter(spec.conj(), coefs, 2, 1)
    torch.testing.assert_close(got, deep_filter_reference(plain, coefs, 2, 1), rtol=0, atol=0)
    got = deep_filter(spec.conj(), coefs, 2, 1, history=history.conj())
    torch.testing.assert_close(got, deep_filter_reference(plain, coefs, 2, 1, history=history.conj().resolve_conj()),
                               rtol=0, atol=0)
    got = deep_filter_bwd(grad.conj(), spec.conj(), coefs, 2, 1)
    for x, y in zip(got, deep_filter_backward_reference(grad.conj().resolve_conj(), plain, coefs, 2, 1)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)

    # through autograd: a conjugated spec in, and the cotangent back through .conj() of the output
    results = []
    for fn in (deep_filter, deep_filter_reference):
        s, c = spec.clone().requires_grad_(), coefs.clone().requires_grad_()
        out = fn(s.conj(), c, 2, 1)
        loss = (out.conj() * grad).real.sum() + torch.stack([out.real, out.imag], -1).pow(2).sum()
        results.append(torch.autograd.grad(loss, (s, c)))
    for x, y in zip(*results):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
    assert len(seen) == 3 + 4 + 5 + 3 + 5 and not any(x.is_conj() for x in seen)
