"""Port parity: the grouped-GRU recurrence's backward (the plain backward,
``gru_sequence_bwd`` and the ``autograd.Function`` that ``gru_sequence``
becomes under a gradient) against autograd and against cruse_tpu, on the CPU.

The JAX package has no backward kernel: its train step differentiates
``gru_scan`` under XLA's autodiff, so ``jax.vjp`` of ``gru_scan`` and
``jax.grad`` of the flax layers are the references. Inputs come from a numpy
seed. Tolerances: 1e-10 against autograd in float64 (the same formulas, summed
in another order); 1e-5 against JAX in float32 (two float32 implementations
of the same sums, over a dozen steps). Also the resident backward kernel's
plan, its packed layout of w_hh and its decomposition by unit slices, and
the routing between the two backward kernels.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.nn.gru import GGRUBottleneck as JaxGGRU
from cruse_tpu.nn.gru import GroupedGRULayer as JaxGroupedGRULayer
from cruse_tpu.nn.gru import gru_scan as jax_gru_scan

from cruse_tpu_torch.nn.gru import GGRUBottleneck, GroupedGRULayer, gru_scan
from cruse_tpu_torch.ops import gru_kernel
from cruse_tpu_torch.ops.gru_kernel import (
    BWD_MAX_THREADS, BWD_PARTS, BWD_ROWS_CHUNK, BWD_SCATTER_CS, BWD_TILE_ROWS, CLUSTER_SIZES, H100_CLUSTERS,
    MAX_CLUSTER_WAVES, HOP_CLUSTER_WAVES, ROW_TILES, SHARED_LIMIT, bwd_cluster_fit, bwd_fit_at, bwd_row_tile,
    bwd_rows_fit, bwd_rows_stages, bwd_threads, gru_backward_walk_reference, gru_sequence,
    gru_sequence_backward_reference, gru_sequence_bwd, gru_sequence_reference, launch_gru_bwd, packed_weight,
    packed_weight_bwd, padded_weight_bwd, resident_bwd_bytes, resident_bwd_plan, scatter_fit, scatter_stride)
from cruse_tpu_torch.utils.weights import flatten_tree

# B, T, G, H: a ragged batch, one step, an odd H, one group
SHAPES = [(3, 7, 2, 5), (2, 1, 3, 4), (4, 9, 1, 7), (1, 12, 2, 3)]


def _inputs(rng, b, t, g, h, dtype=np.float32):
    arrays = (rng.standard_normal((b, t, g, 3 * h)), rng.standard_normal((b, g, h)) * 0.5,
              rng.standard_normal((g, 3 * h, h)) * 0.4, rng.standard_normal((g, 3 * h)) * 0.1,
              rng.standard_normal((b, t, g, h)), rng.standard_normal((b, g, h)))
    return [a.astype(dtype) for a in arrays]  # x_proj, h0, w_hh, b_hh, dy, dh_last


@pytest.mark.parametrize("with_dh_last", [True, False], ids=["dh_last", "no_dh_last"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_autograd_float64(rng, shape, with_dh_last):
    x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in _inputs(rng, *shape, dtype=np.float64))
    leaves = [a.clone().requires_grad_() for a in (x, h0, w, b)]
    y, h_last = gru_sequence_reference(*leaves)
    loss = (y * dy).sum() + ((h_last * dh_last).sum() if with_dh_last else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = gru_sequence_backward_reference(dy, dh_last if with_dh_last else None, x, h0, w, b, y.detach())
    for name, g, ref in zip(("dx_proj", "dh0", "dw_hh", "db_hh"), got, want):
        torch.testing.assert_close(g, ref, rtol=0, atol=1e-10, msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_jax_vjp(rng, shape):
    arrays = _inputs(rng, *shape)
    (y_ref, _), vjp = jax.vjp(jax_gru_scan, *(jnp.asarray(a) for a in arrays[:4]))
    want = vjp((jnp.asarray(arrays[4]), jnp.asarray(arrays[5])))
    x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in arrays)
    y, _ = gru_sequence_reference(x, h0, w, b)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    got = gru_sequence_backward_reference(dy, dh_last, x, h0, w, b, y)
    for name, g, ref in zip(("dx_proj", "dh0", "dw_hh", "db_hh"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5, err_msg=name)


def test_walk_splits_dhp_from_dx_proj(rng):
    """The kernel's outputs: dhp equals dx_proj but for the n gate, which is
    dn_pre * r; the walk's dh0 is the full backward's."""
    x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in _inputs(rng, 3, 6, 2, 5, np.float64))
    y, _ = gru_sequence_reference(x, h0, w, b)
    dx, dhp, dh0 = gru_backward_walk_reference(dy, dh_last, x, h0, w, b, y)
    torch.testing.assert_close(dhp[..., :10], dx[..., :10], rtol=0, atol=0)
    h_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
    hp = torch.einsum("btgh,gkh->btgk", h_prev, w) + b
    r = torch.sigmoid(x[..., :5] + hp[..., :5])
    torch.testing.assert_close(dhp[..., 10:], dx[..., 10:] * r, rtol=0, atol=1e-12)
    full = gru_sequence_backward_reference(dy, dh_last, x, h0, w, b, y)
    torch.testing.assert_close(full[0], dx, rtol=0, atol=0)
    torch.testing.assert_close(full[1], dh0, rtol=0, atol=0)


@pytest.mark.parametrize("use", ["y", "h_last", "both"])
def test_function_matches_autograd_through_plain_recurrence(rng, use):
    """gru_sequence under a gradient (the Function, plain backward on the CPU)
    against autograd through the plain recurrence, whichever outputs the loss
    reads (the other's gradient arrives as None); no launch is counted."""
    x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in _inputs(rng, 3, 8, 2, 6, np.float64))
    before = gru_sequence.launches, gru_sequence_bwd.launches
    results = []
    for fn in (gru_sequence, gru_sequence_reference):
        leaves = [a.clone().requires_grad_() for a in (x, h0, w, b)]
        y, h_last = fn(*leaves)
        loss = {"y": (y * dy).sum(), "h_last": (h_last * dh_last).sum(),
                "both": (y * dy).sum() + (h_last * dh_last).sum()}[use]
        results.append(torch.autograd.grad(loss, leaves))
    assert (gru_sequence.launches, gru_sequence_bwd.launches) == before
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


def test_function_gives_only_the_gradients_asked_for(rng):
    x, h0, w, b, dy, _ = (torch.from_numpy(a) for a in _inputs(rng, 2, 5, 2, 4))
    wq = w.clone().requires_grad_()
    y, _ = gru_sequence(x, h0, wq, b)
    assert y.requires_grad
    (dw,) = torch.autograd.grad((y * dy).sum(), (wq,))
    torch.testing.assert_close(dw, gru_sequence_backward_reference(dy, None, x, h0, w, b, y.detach())[2],
                               rtol=0, atol=1e-6)
    with torch.no_grad():  # no gradient wanted: the plain forward, nothing recorded
        assert not gru_sequence(x, h0, wq, b)[0].requires_grad


def test_gru_sequence_bwd_on_cpu_is_the_plain_backward_and_counts_no_launch(rng):
    x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in _inputs(rng, 3, 4, 2, 5))
    y, _ = gru_sequence_reference(x, h0, w, b)
    before = gru_sequence_bwd.launches
    for dl in (dh_last, None):
        got = gru_sequence_bwd(dy, dl, x, h0, w, b, y)
        for g, want in zip(got, gru_sequence_backward_reference(dy, dl, x, h0, w, b, y)):
            torch.testing.assert_close(g, want, rtol=0, atol=0)
    assert gru_sequence_bwd.launches == before
    zeros = gru_sequence_backward_reference(dy, torch.zeros_like(dh_last), x, h0, w, b, y)
    for g, want in zip(gru_sequence_backward_reference(dy, None, x, h0, w, b, y), zeros):
        torch.testing.assert_close(g, want, rtol=0, atol=0)


def test_bf16_weights_under_a_gradient_raise(rng):
    x, h0, w, b = (torch.from_numpy(a) for a in _inputs(rng, 2, 3, 2, 4)[:4])
    with pytest.raises(NotImplementedError, match="bfloat16"):
        gru_sequence(x.requires_grad_(), h0, w, b, weight_dtype=torch.bfloat16)
    with torch.no_grad():  # the bf16 forward itself runs
        assert gru_sequence(x, h0, w, b, weight_dtype=torch.bfloat16)[0].shape == (2, 3, 2, 4)


@pytest.mark.parametrize("case", ["dy_shape", "dh_last_shape", "meta_device"])
def test_gru_sequence_bwd_rejects(rng, case):
    x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in _inputs(rng, 2, 4, 2, 3))
    y = torch.zeros_like(dy)
    if case == "dy_shape":
        dy = dy[:, :-1]
    elif case == "dh_last_shape":
        dh_last = dh_last[:1]
    else:  # neither cpu nor cuda: no path runs the plain version instead
        x, h0, w, b, dy, dh_last, y = (a.to("meta") for a in (x, h0, w, b, dy, dh_last, y))
    with pytest.raises(ValueError):
        gru_sequence_bwd(dy, dh_last, x, h0, w, b, y)


def test_launcher_refuses_cpu_tensors(rng):
    """The backward kernel's launcher never runs the plain version: on CPU
    tensors it raises, and counts nothing."""
    x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in _inputs(rng, 2, 3, 2, 4))
    before = gru_sequence_bwd.launches, gru_sequence_bwd.resident_launches
    for launch in (launch_gru_bwd, gru_kernel.launch_gru_bwd_resident, gru_kernel.launch_gru_bwd_streamed):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch(x, x.clone(), dy, h0, dy, dh_last, w, torch.empty_like(x), torch.empty_like(x),
                   torch.empty_like(h0))
    assert (gru_sequence_bwd.launches, gru_sequence_bwd.resident_launches) == before
    assert "gru_bwd" in {p.stem for p in gru_kernel._build.SRC_DIR.glob("*.cu")}


def _layer_state(variables):
    return {k.replace("/", ".").replace(".scale", ".weight"): torch.from_numpy(np.array(v))
            for k, v in flatten_tree(variables["params"]).items()}


def _jax_grads(module, variables, x, h0, dy, dh):
    """jax.grad of sum(y * dy) + sum(h * dh) in the parameters and the input."""
    def loss(params, xin):
        y, state = module.apply({"params": params}, xin, h0)
        hs = state if isinstance(state, tuple) else (state,)
        return jnp.sum(y * dy) + sum(jnp.sum(s * d) for s, d in zip(hs, dh))

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    return {k.replace("/", ".").replace(".scale", ".weight"): np.asarray(v)
            for k, v in flatten_tree(gp).items()}, np.asarray(gx)


def _torch_grads(module, x, h0, dy, dh):
    xt = torch.from_numpy(x).requires_grad_()
    y, state = module(xt, h0)
    hs = state if isinstance(state, tuple) else (state,)
    loss = (y * torch.from_numpy(dy)).sum() + sum((s * torch.from_numpy(d)).sum() for s, d in zip(hs, dh))
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, (xt, *params))
    return dict(zip(names, (g.numpy() for g in grads[1:]))), grads[0].numpy()


@pytest.mark.parametrize("recurrence", ["function", "plain"])
def test_grouped_gru_layer_gradients_match_jax(rng, recurrence):
    b, t, i, hid, g = 3, 9, 12, 16, 4
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    h0 = rng.standard_normal((b, g, hid // g)).astype(np.float32)
    dy = rng.standard_normal((b, t, hid)).astype(np.float32)
    dh = (rng.standard_normal((b, g, hid // g)).astype(np.float32),)
    jl = JaxGroupedGRULayer(hid, g)
    variables = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want_p, want_x = _jax_grads(jl, variables, x, jnp.asarray(h0), jnp.asarray(dy), tuple(map(jnp.asarray, dh)))
    layer = GroupedGRULayer(i, hid, g)
    layer.load_state_dict(_layer_state(variables), strict=True)
    layer.recurrence = gru_sequence if recurrence == "function" else gru_scan
    got_p, got_x = _torch_grads(layer, x, torch.from_numpy(h0), dy, dh)
    np.testing.assert_allclose(got_x, want_x, rtol=1e-5, atol=1e-5)
    assert got_p.keys() == want_p.keys() == {"w_ih", "w_hh", "b_ih", "b_hh"}
    for name, want in want_p.items():
        np.testing.assert_allclose(got_p[name], want, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("recurrence", ["function", "plain"])
def test_ggru_bottleneck_gradients_match_jax(rng, recurrence):
    b, t, d, g = 2, 7, 16, 4
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    state = tuple(rng.standard_normal((b, g, d // g)).astype(np.float32) for _ in range(2))
    dy = rng.standard_normal((b, t, d)).astype(np.float32)
    dh = tuple(rng.standard_normal((b, g, d // g)).astype(np.float32) for _ in range(2))
    jm = JaxGGRU(groups=g)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.3, a.shape).astype(np.float32), variables)
    want_p, want_x = _jax_grads(jm, variables, x, tuple(map(jnp.asarray, state)), jnp.asarray(dy),
                                tuple(map(jnp.asarray, dh)))
    module = GGRUBottleneck(d, g)
    module.load_state_dict(_layer_state(variables), strict=True)
    for bank in (module.bank1, module.bank2):
        bank.recurrence = gru_sequence if recurrence == "function" else gru_scan
    got_p, got_x = _torch_grads(module, x, tuple(map(torch.from_numpy, state)), dy, dh)
    np.testing.assert_allclose(got_x, want_x, rtol=1e-5, atol=1e-5)
    assert got_p.keys() == want_p.keys() and len(want_p) == 12
    for name, want in want_p.items():
        np.testing.assert_allclose(got_p[name], want, rtol=1e-5, atol=1e-5, err_msg=name)


def test_cuda_route_with_stand_in_kernels_matches_autograd(rng, monkeypatch):
    """gru_sequence under a gradient down the CUDA route (hp as one product,
    one backward launch, dw_hh and db_hh from its dhp) on CPU tensors, with
    the launchers replaced by stand-ins that run the kernels' plain versions
    into the outputs: the gradients match autograd through the plain
    recurrence, each direction is one counted launch, and the backward takes
    route A's launcher where ``backward_plan`` fits (a cluster of 1 at H = 6;
    16 blocks at H = 384, where the card runs 7 such clusters at once) and
    route B's where it is None (H = 384 where the card would run no 16-block
    cluster; H = 6 with the plan patched to None)."""
    def stand_in_forward(x, h0, w, b, weight_dtype=None):
        gru_sequence.launches += 1
        return gru_sequence_reference(x, h0, w, b, weight_dtype)

    def stand_in_backward(route):
        def launch(x_proj, hp, y, h0, dy, dh_last, w_hh, dx_proj, dhp, dh0):
            assert all(t.is_contiguous() for t in (x_proj, hp, y, h0, dy, w_hh, dx_proj, dhp, dh0))
            h_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
            torch.testing.assert_close(hp, torch.einsum("btgh,gkh->btgk", h_prev, w_hh) + b_hh_seen[0])
            for out, want in zip((dx_proj, dhp, dh0), gru_backward_walk_reference(
                    dy, dh_last, x_proj, h0, w_hh, b_hh_seen[0], y)):
                out.copy_(want)
            h = h0.shape[-1]
            routes.append(f"resident CS={(bwd_cluster_fit(h) or scatter_fit(h))[0]}" if route == "resident"
                          else route)
            gru_sequence_bwd.launches += 1
            gru_sequence_bwd.resident_launches += route == "resident"
        return launch

    monkeypatch.setattr(gru_kernel, "_runs_plain", lambda x: False)
    monkeypatch.setattr(gru_kernel, "launch_resident", stand_in_forward)
    monkeypatch.setattr(gru_kernel, "launch_streamed", stand_in_forward)
    monkeypatch.setattr(gru_kernel, "launch_gru_bwd_resident", stand_in_backward("resident"))
    monkeypatch.setattr(gru_kernel, "launch_gru_bwd_streamed", stand_in_backward("row-tiled"))
    for shape, clusters, route in (((5, 7, 2, 6), 7, "resident CS=1"), ((3, 4, 1, 384), 7, "resident CS=16"),
                                   ((3, 4, 1, 384), 0, "row-tiled"), ((5, 7, 2, 6), 7, "row-tiled")):
        x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in _inputs(rng, *shape, np.float64))
        b_hh_seen = [b]
        monkeypatch.setattr(gru_kernel, "co_resident_bwd_clusters", lambda device, h, n=clusters: n)
        monkeypatch.setattr(gru_kernel, "co_resident_clusters", lambda device, h, dtype=None: 7)  # the forward's
        if route == "row-tiled" and shape[3] == 6:  # a shape a cluster of up to 8 holds, its plan patched away
            monkeypatch.setattr(gru_kernel, "resident_bwd_plan", lambda *shape, **kw: None)
        routes = []
        before = gru_sequence.launches, gru_sequence_bwd.launches, gru_sequence_bwd.resident_launches
        results = []
        for fn in (gru_sequence, gru_sequence_reference):
            leaves = [a.clone().requires_grad_() for a in (x, h0, w, b)]
            y, h_last = fn(*leaves)
            results.append(torch.autograd.grad((y * dy).sum() + (h_last * dh_last).sum(), leaves))
        assert routes == [route]
        resident = route.startswith("resident")
        assert (gru_sequence.launches - before[0], gru_sequence_bwd.launches - before[1],
                gru_sequence_bwd.resident_launches - before[2]) == (1, 1, int(resident))
        for name, got, want in zip(("dx_proj", "dh0", "dw_hh", "db_hh"), *results):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-10, msg=f"{route} {shape}: {name}")


WAVE_ROWS = MAX_CLUSTER_WAVES * H100_CLUSTERS * 8  # the most rows a 16-block launch takes over T > 1 at G = 1
HOP_ROWS = HOP_CLUSTER_WAVES * H100_CLUSTERS * 8  # and at T = 1


@pytest.mark.parametrize("shape, want", [
    ((128, 1001, 4, 176), (2, 88, 8, 219696)),  # config 2: 128 blocks of 352 threads
    ((32, 1001, 4, 176), (2, 88, 8, 219696)),  # the CRUSE+DF step's batch
    ((3, 5, 2, 33), (1, 36, 8, 22224)),
    ((5, 6, 2, 200), (4, 52, 8, 172848)),
    ((3, 5, 2, 256), (8, 32, 8, 172080)),
    ((3, 5, 2, 350), None),  # no cluster of up to 8 holds it, and 16 blocks of 24 units would leave one without
    ((2, 4, 1, 512), (16, 32, 8, 229392)),  # the row-tiled backward's largest H: 16 blocks hold it
    ((8, 188, 1, 512), (16, 32, 8, 229392)),  # FullSubNet's full band in its step: one cluster of 16
    ((2056, 188, 1, 384), None),  # its sub band: 257 clusters of 16 would take 37 waves of 7
    ((16, 626, 1, 384), (16, 24, 8, 172048)),
    ((WAVE_ROWS, 188, 1, 512), (16, 32, 8, 229392)),  # the wave rule's boundary: 56 clusters, 8 waves of 7
    ((WAVE_ROWS + 1, 188, 1, 512), None),
    ((WAVE_ROWS // 2, 188, 2, 512), (16, 32, 8, 229392)),
    ((WAVE_ROWS // 2 + 1, 188, 2, 512), None),
    ((HOP_ROWS, 1, 1, 512), (16, 32, 8, 229392)),  # at T = 1, 2 waves
    ((HOP_ROWS + 1, 1, 1, 512), None),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) and len(v) == 4 else None)
def test_resident_bwd_plan(shape, want):
    """The smallest cluster of up to 8 whose block holds its [3H][U] slice
    (rows padded to 2 mod 4 chunks), the dhp tile and its two mbarriers
    within SHARED_LIMIT, every block owning a unit; else the 16-block fit
    (``scatter_fit``: H rows of its units' three gates, the partial carries
    [2][16][U][8] and two mbarriers) where the launch's clusters take at most
    MAX_CLUSTER_WAVES (HOP_CLUSTER_WAVES at T = 1) waves of the 7 an H100
    runs at once; None where the row-tiled backward runs, at ``bwd_row_tile``'s
    R."""
    plan = resident_bwd_plan(*shape)
    assert plan == want
    b, t, g, h = shape
    small = [cs for cs in CLUSTER_SIZES if resident_bwd_bytes(h, -(-h // (4 * cs)) * 4, BWD_TILE_ROWS) <= SHARED_LIMIT
             and bwd_fit_at(h, cs) is not None]
    if plan is None:
        assert not small and bwd_rows_fit(h, bwd_row_tile(b, g, h))
        waves = HOP_CLUSTER_WAVES if t == 1 else MAX_CLUSTER_WAVES
        assert scatter_fit(h) is None or g * -(-b // 8) > waves * H100_CLUSTERS
        return
    cs, u, rows, nbytes = plan
    assert rows == BWD_TILE_ROWS and u % 4 == 0 and u * cs >= h > (cs - 1) * u
    if cs == BWD_SCATTER_CS:
        assert not small and g * -(-b // rows) <= (HOP_CLUSTER_WAVES if t == 1 else MAX_CLUSTER_WAVES) * H100_CLUSTERS
        assert u <= 32 and nbytes == h * 16 * -(-(3 * u // 4) // 8) * 8 + 2 * 16 * u * rows * 4 + 16 <= SHARED_LIMIT
        return
    slice_bytes = 3 * h * 16 * (u // 4 + (6 - u // 4 % 4) % 4)
    assert nbytes == slice_bytes + 2 * (rows // 8) * (24 * h + 4) * 4 + 16 <= SHARED_LIMIT
    assert bwd_threads(u, rows) <= BWD_MAX_THREADS
    for smaller in CLUSTER_SIZES[:CLUSTER_SIZES.index(cs)]:
        assert resident_bwd_bytes(h, -(-h // (4 * smaller)) * 4, rows) > SHARED_LIMIT


@pytest.mark.parametrize("b, g, h, want", [
    (8 * 257, 1, 384, 16),  # FullSubNet's sub band in its step: 129 blocks of 16 rows
    (16 * 257, 1, 384, 16),  # 32 rows would leave the ring one stage
    (8, 1, 512, 8), (257, 1, 512, 8),  # 16 rows of H = 512: 2 stages; the tie goes to the larger on one wave
    (128, 4, 176, 8), (4096, 4, 176, 32), (3, 2, 5, 8), (45, 1, 177, 8),
    (2048 * 257, 1, 384, 16),  # R = 8 takes as few waves, but 65,792 blocks: past the grid's limit
])
def test_bwd_row_tile(b, g, h, want):
    """Route B's R: of the tiles whose block (2 j halves x R / 8 row groups x
    Hp / 8 unit groups, at most 384 threads) holds the dhp tile [3H][R] and a
    ring of 2 or more stages of 32 j rows, the fewest rows times waves of 132
    blocks (of the tiles whose grid stays within 65,535 blocks); R = 8 fits
    every H up to 512."""
    assert bwd_row_tile(b, g, h) == want
    assert all(bwd_rows_fit(hh, 8) for hh in (1, 5, 176, 177, 384, 500, 512))
    hp = -(-h // 8) * 8
    for r in ROW_TILES:
        stages = min(8, (SHARED_LIMIT - 3 * h * r * 4) // (BWD_ROWS_CHUNK * hp * 4 + 16))
        threads = -(-2 * (r // 8) * (hp // 8) // 32) * 32
        assert bwd_rows_stages(h, r) == stages
        assert bwd_rows_fit(h, r) == (threads <= 384 and stages >= 2)
    waves = {r: -(-g * -(-b // r) // 132) * r for r in ROW_TILES if bwd_rows_fit(h, r) and -(-b // r) <= 65535}
    assert waves[want] == min(waves.values())


@pytest.mark.parametrize("h, cs, rows, want", [
    (176, 1, 8, None), (176, 2, 8, (2, 88, 8, 219696)), (176, 4, 8, (4, 44, 8, 152112)),
    (176, 8, 8, (8, 24, 8, 84528)),
    (33, 2, 8, (2, 20, 8, 15888)), (33, 4, 8, None), (33, 8, 8, None),  # (CS - 1) U >= H: a block with no unit
    (5, 2, 8, (2, 4, 8, 1488)), (5, 4, 8, None), (300, 8, 8, (8, 40, 8, 201648)), (350, 8, 8, None),
    (1, 1, 8, (1, 4, 8, 336)),
    (176, 2, 16, None), (176, 4, 16, (4, 44, 16, 185936)),  # the sweep's copy of the source at R = 16
    (512, 16, 8, (16, 32, 8, 229392)), (500, 16, 8, (16, 32, 8, 224784)),  # 16 blocks: the other layout
    (384, 16, 8, (16, 24, 8, 172048)), (350, 16, 8, None), (256, 16, 8, (16, 16, 8, 81936)), (176, 16, 8, None),
    (33, 16, 8, None), (512, 16, 16, None), (520, 16, 8, None),
])
def test_bwd_fit_at(h, cs, rows, want):
    """A cluster size's fit: its bytes and threads within the limits, and a
    unit in every block; the plan is the smallest cluster size that has one."""
    fit = bwd_fit_at(h, cs, rows)
    assert fit == want
    if fit is not None:
        u = fit[1]
        nbytes = (h * scatter_stride(u) * 16 + 2 * 16 * u * rows * 4 + 16 if cs == BWD_SCATTER_CS
                  else resident_bwd_bytes(h, u, rows))
        assert fit[3] == nbytes <= SHARED_LIMIT and (cs - 1) * u < h <= cs * u
    if rows == BWD_TILE_ROWS:
        smallest = next((f for f in (bwd_fit_at(h, c) for c in CLUSTER_SIZES) if f), None)
        assert bwd_cluster_fit(h) == smallest and (smallest is None or smallest[0] <= (cs if fit else 8))


def test_resident_launcher_refuses_a_cluster_without_a_fit(rng):
    """A forced cluster size raises, before any device check, where the
    weight does not fit, where a block would own no unit (H = 33 in 8 blocks
    of U = 8: blocks 5 to 7 have none; in 16 of U = 4) or where the size is not
    built; a size that fits goes on to the launch's own checks (here: CPU
    tensors). H = 350 fits no cluster of up to 8, and 16 blocks of 24 units
    would leave one without."""
    x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in _inputs(rng, 2, 3, 1, 33))
    args = (x, x.clone(), dy, h0, dy, dh_last, w, torch.empty_like(x), torch.empty_like(x), torch.empty_like(h0))
    before = gru_sequence_bwd.launches, gru_sequence_bwd.resident_launches
    for cs in (4, 8, 3, 16):  # at 16: U = 4, blocks 9 to 15 have none
        with pytest.raises(ValueError, match="unit in every block"):
            gru_kernel.launch_gru_bwd_resident(*args, cs=cs)
    for cs in (1, 2):
        with pytest.raises(ValueError, match="CUDA tensors"):
            gru_kernel.launch_gru_bwd_resident(*args, cs=cs)
    big = (torch.from_numpy(a) for a in _inputs(rng, 1, 2, 1, 350))
    x, h0, w, b, dy, dh_last = big
    with pytest.raises(ValueError, match="unit in every block"):
        gru_kernel.launch_gru_bwd_resident(x, x.clone(), dy, h0, dy, dh_last, w, torch.empty_like(x),
                                           torch.empty_like(x), torch.empty_like(h0))
    assert (gru_sequence_bwd.launches, gru_sequence_bwd.resident_launches) == before


@pytest.mark.parametrize("g, h, cs", [(2, 8, 1), (3, 10, 4), (2, 5, 4), (1, 13, 2), (2, 7, 8)])
def test_packed_weight_bwd_matches_indexing(rng, g, h, cs):
    """[g, c, j, u] is w_hh[g, j, c * U + u]; the padding is zero."""
    w = torch.from_numpy(rng.standard_normal((g, 3 * h, h)).astype(np.float32))
    packed = packed_weight_bwd(w, cs)
    u = -(-h // (4 * cs)) * 4
    assert packed.shape == (g, cs, 3 * h, u) and packed.dtype == torch.float32 and packed.is_contiguous()
    want = torch.zeros(g, cs, 3 * h, u)
    for c in range(cs):
        for unit in range(u):
            if c * u + unit < h:
                want[:, c, :, unit] = w[:, :, c * u + unit]
    torch.testing.assert_close(packed, want, rtol=0, atol=0)


def test_packed_weight_bwd_cache_invalidates():
    """The resident backward's copy of w_hh is made once per weight and
    cluster size, and made again after any in-place write (an optimiser
    step, ``load_state_dict``)."""
    layer = GroupedGRULayer(8, 32, 2)  # H = 16 a group: U = 8 at CS = 2
    layer.reset_parameters(torch.Generator().manual_seed(0))
    w = layer.w_hh
    first = packed_weight_bwd(w, 2)
    assert packed_weight_bwd(w, 2) is first
    assert packed_weight_bwd(w, 1) is not first
    first = packed_weight_bwd(w, 2)
    new_state = {k: v + 1.0 for k, v in layer.state_dict().items()}
    layer.load_state_dict(new_state)
    again = packed_weight_bwd(w, 2)
    assert again is not first
    torch.testing.assert_close(again[:, 0, :, 0], new_state["w_hh"][:, :, 0], rtol=0, atol=0)
    with torch.no_grad():
        w.mul_(2.0)
    torch.testing.assert_close(packed_weight_bwd(w, 2)[:, 1, :, 1], w.detach()[:, :, 8 + 1], rtol=0, atol=0)
    with torch.inference_mode():  # inference tensors have no version counter: no cache
        frozen = torch.ones(2, 6, 2)
        assert packed_weight_bwd(frozen, 2) is not packed_weight_bwd(frozen, 2)


def _backward_by_slices(dy, dh_last, x_proj, h0, w_hh, b_hh, y, cs, parts=BWD_PARTS):
    """The resident backward kernel's decomposition in plain PyTorch: each
    step the gates of every (row, unit) give the dhp tile, which every block
    of the cluster sees; block c adds the carry of the units [c * U, (c + 1) *
    U) from its slice of the packed weight, each sum over j taken in `parts`
    interleaved partial sums that are then added pairwise, after the direct
    term dh z. Returns (dx_proj, dhp, dh0), as the walk does."""
    hdim = h0.shape[-1]
    packed = packed_weight_bwd(w_hh, cs)  # [G, CS, 3H, U]
    u = packed.shape[-1]
    carry = torch.zeros_like(h0) if dh_last is None else dh_last
    dx, dp = [None] * x_proj.shape[1], [None] * x_proj.shape[1]
    for t in range(x_proj.shape[1] - 1, -1, -1):
        h_prev = h0 if t == 0 else y[:, t - 1]
        hp = torch.einsum("bgh,gkh->bgk", h_prev, w_hh) + b_hh
        xr, xz, xn = x_proj[:, t].split(hdim, dim=-1)
        hr, hz, hn = hp.split(hdim, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh = dy[:, t] + carry
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dz = dh * (h_prev - n) * z * (1.0 - z)
        dr = dn * hn * r * (1.0 - r)
        dx[t] = torch.cat([dr, dz, dn], dim=-1)
        dp[t] = tile = torch.cat([dr, dz, dn * r], dim=-1)  # [B, G, 3H]: what every block holds
        new = []
        for c in range(cs):
            units = range(c * u, min(hdim, (c + 1) * u))
            if not len(units):
                continue
            sums = [torch.einsum("bgj,gju->bgu", tile[:, :, p::parts], packed[:, c, p::parts]) for p in range(parts)]
            while len(sums) > 1:
                sums = [a + b for a, b in zip(sums[::2], sums[1::2])]
            new.append((dh * z)[..., units.start:units.stop] + sums[0][..., :len(units)])
        carry = torch.cat(new, dim=-1)
    return torch.stack(dx, dim=1), torch.stack(dp, dim=1), carry


@pytest.mark.parametrize("shape, cs", [((3, 9, 2, 8), 1), ((3, 9, 2, 8), 2), ((2, 6, 3, 10), 4),
                                       ((9, 4, 1, 13), 2), ((2, 5, 2, 5), 4), ((2, 5, 1, 37), 8)])
def test_backward_by_unit_slices_matches_walk_and_jax(rng, shape, cs):
    arrays = _inputs(rng, *shape)
    (_, _), vjp = jax.vjp(jax_gru_scan, *(jnp.asarray(a) for a in arrays[:4]))
    want_dx, want_dh0 = (np.asarray(v) for v in vjp((jnp.asarray(arrays[4]), jnp.asarray(arrays[5])))[:2])
    x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in arrays)
    y, _ = gru_sequence_reference(x, h0, w, b)
    got = _backward_by_slices(dy, dh_last, x, h0, w, b, y, cs)
    for name, g, ref in zip(("dx_proj", "dhp", "dh0"), got, gru_backward_walk_reference(dy, dh_last, x, h0, w, b, y)):
        torch.testing.assert_close(g, ref, rtol=0, atol=1e-5, msg=name)
    np.testing.assert_allclose(got[0].numpy(), want_dx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), want_dh0, rtol=0, atol=1e-5)
    zero = _backward_by_slices(dy, None, x, h0, w, b, y, cs)  # dh_last None: zeros
    for g, ref in zip(zero, gru_backward_walk_reference(dy, None, x, h0, w, b, y)):
        torch.testing.assert_close(g, ref, rtol=0, atol=1e-5)


def _gates(dy_t, carry, x_t, h_prev, w_hh, b_hh):
    """One step's gates as the kernels take them: (dx_proj, dhp, direct) of
    every (row, unit) from the carry, with hp from the saved state."""
    hdim = h_prev.shape[-1]
    hp = torch.einsum("bgh,gkh->bgk", h_prev, w_hh) + b_hh
    xr, xz, xn = x_t.split(hdim, dim=-1)
    hr, hz, hn = hp.split(hdim, dim=-1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    dh = dy_t + carry
    dn = dh * (1.0 - z) * (1.0 - n * n)
    dz = dh * (h_prev - n) * z * (1.0 - z)
    dr = dn * hn * r * (1.0 - r)
    return torch.cat([dr, dz, dn], dim=-1), torch.cat([dr, dz, dn * r], dim=-1), dh * z


def _backward_by_j_slices(dy, dh_last, x_proj, h0, w_hh, b_hh, y, cs=BWD_SCATTER_CS):
    """Route A at 16 blocks (``gru_bwd_scatter_kernel``) in plain PyTorch, in
    its order of sums: block c holds the forward's packed slice of its U
    units' three gates, ``packed_weight(w_hh, f32, cs)[:, c]`` ([H][3][U]),
    finishes the gates of its units into its dhp tile [3U] (tile row q U + u),
    and forms a partial carry of every unit k over its 3U rows j, summed in
    the order of j; the owner of unit k adds the cs partials in block order
    after its direct term dh z. Returns (dx_proj, dhp, dh0), as the walk."""
    hdim = h0.shape[-1]
    packed = packed_weight(w_hh, torch.float32, cs).to(w_hh.dtype)  # [G, CS, H, 3, U]
    u = packed.shape[-1]
    slices = packed.reshape(*packed.shape[:3], 3 * u)  # [G, CS, k, j = gate * U + unit]
    carry = torch.zeros_like(h0) if dh_last is None else dh_last
    dx, dp = [None] * x_proj.shape[1], [None] * x_proj.shape[1]
    for t in range(x_proj.shape[1] - 1, -1, -1):
        h_prev = h0 if t == 0 else y[:, t - 1]
        dx[t], dp[t], direct = _gates(dy[:, t], carry, x_proj[:, t], h_prev, w_hh, b_hh)
        partials = []
        for c in range(cs):
            own = [q * hdim + c * u + v for q in range(3) for v in range(u)]  # the block's rows j, in tile order
            tile = torch.stack([dp[t][..., j] if j % hdim >= c * u and j % hdim < hdim else torch.zeros_like(
                dp[t][..., 0]) for j in own], dim=-1)  # [B, G, 3U]: padding units' rows are zero
            part = torch.zeros_like(h0)
            for j in range(3 * u):  # the kernel's running sum over j
                part = part + slices[None, :, c, :, j] * tile[..., j, None]
            partials.append(part)
        carry = direct
        for part in partials:  # the owner adds the blocks' partials in block order
            carry = carry + part
    return torch.stack(dx, dim=1), torch.stack(dp, dim=1), carry


def _backward_by_j_chunks(dy, dh_last, x_proj, h0, w_hh, b_hh, y, rows):
    """Route B (``gru_bwd_rows_kernel``) in plain PyTorch, in its order of
    sums: blocks of ``rows`` batch rows (the last padded with zero rows, whose
    outputs are dropped); each step the gates give the dhp tile [3H] of every
    row, and a lane pair's two halves of j (even and odd rows j, taken in
    chunks of ``BWD_ROWS_CHUNK``) are summed apart, the lower lane's own units
    starting from the direct term dh z and the upper lane's from zero (and
    the other way round for the upper lane's units), then added. Returns
    (dx_proj, dhp, dh0), as the walk."""
    b, t_len, g, h3 = x_proj.shape
    hdim = h3 // 3
    pad = -b % rows

    def padded(a):
        return torch.cat([a, a.new_zeros((pad, *a.shape[1:]))]) if pad else a

    dy_p, x_p, h0_p, y_p = map(padded, (dy, x_proj, h0, y))
    carry = torch.zeros_like(h0_p) if dh_last is None else padded(dh_last)
    dx, dp = [None] * t_len, [None] * t_len
    w = padded_weight_bwd(w_hh)[..., :hdim]  # [G, 3H, H], the rows as the ring streams them
    lower = (torch.arange(hdim) // 4) % 2 == 0  # units k8 .. k8 + 3 of each 8: the lower lane's
    for t in range(t_len - 1, -1, -1):
        h_prev = h0_p if t == 0 else y_p[:, t - 1]
        dx[t], dp[t], direct = _gates(dy_p[:, t], carry, x_p[:, t], h_prev, w_hh, b_hh)
        halves = [torch.where(lower, direct, 0.0), torch.where(lower, 0.0, direct)]
        for c0 in range(0, h3, BWD_ROWS_CHUNK):
            for j in range(c0, min(h3, c0 + BWD_ROWS_CHUNK)):
                halves[j % 2] = halves[j % 2] + w[None, :, j, :] * dp[t][..., j, None]
        carry = torch.where(lower, halves[0] + halves[1], halves[1] + halves[0])
    return torch.stack(dx, dim=1)[:b], torch.stack(dp, dim=1)[:b], carry[:b]


def _check_against_walk_and_jax(rng, shape, emulate):
    arrays = _inputs(rng, *shape)
    (_, _), vjp = jax.vjp(jax_gru_scan, *(jnp.asarray(a) for a in arrays[:4]))
    want_dx, want_dh0 = (np.asarray(v) for v in vjp((jnp.asarray(arrays[4]), jnp.asarray(arrays[5])))[:2])
    x, h0, w, b, dy, dh_last = (torch.from_numpy(a) for a in arrays)
    y, _ = gru_sequence_reference(x, h0, w, b)
    got = emulate(dy, dh_last, x, h0, w, b, y)
    for name, g, ref in zip(("dx_proj", "dhp", "dh0"), got, gru_backward_walk_reference(dy, dh_last, x, h0, w, b, y)):
        torch.testing.assert_close(g, ref, rtol=0, atol=1e-5, msg=name)
    np.testing.assert_allclose(got[0].numpy(), want_dx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), want_dh0, rtol=0, atol=1e-5)
    zero = emulate(dy, None, x, h0, w, b, y)  # dh_last None: zeros
    for g, ref in zip(zero, gru_backward_walk_reference(dy, None, x, h0, w, b, y)):
        torch.testing.assert_close(g, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 6, 2, 64), (2, 5, 1, 64), (9, 4, 1, 61), (4, 3, 3, 62)],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_by_j_slices_matches_walk_and_jax(rng, shape):
    """Route A's reduce-scatter at 16 blocks of U = 4 units, each owning units
    (H = 61 and 62: the last block 1 and 2 of them, its padding rows zero),
    against the walk and jax.vjp of gru_scan, with dh_last nonzero and None."""
    h = shape[3]
    fit = scatter_fit(h)
    assert fit is not None and fit[0] == BWD_SCATTER_CS and (BWD_SCATTER_CS - 1) * fit[1] < h
    _check_against_walk_and_jax(rng, shape, _backward_by_j_slices)


@pytest.mark.parametrize("shape, rows", [((3, 7, 2, 5), 8), ((19, 4, 1, 12), 16), ((9, 5, 2, 16), 8),
                                         ((33, 3, 1, 11), 32), ((2, 1, 3, 4), 8)],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_backward_by_j_chunks_matches_walk_and_jax(rng, shape, rows):
    """Route B's order of sums (B off the row tile, H off the 8-unit pairs
    and the 4-unit halves, 3H off the 32-row chunks, T = 1) against the walk
    and jax.vjp of gru_scan, with dh_last nonzero and None."""
    assert bwd_rows_fit(shape[3], rows)
    _check_against_walk_and_jax(rng, shape, lambda *args: _backward_by_j_chunks(*args, rows=rows))


@pytest.mark.parametrize("g, h", [(2, 5), (1, 8), (3, 12), (1, 16), (1, 384)])
def test_padded_weight_bwd_matches_indexing(rng, g, h):
    """Route B's weight: [g, j, k] is w_hh[g, j, k], zero for k >= H, rows of
    a multiple of 8 units; w_hh itself where it already is that, else a copy
    cached on the weight."""
    w = torch.from_numpy(rng.standard_normal((g, 3 * h, h)).astype(np.float32))
    got = padded_weight_bwd(w)
    hp = -(-h // 8) * 8
    assert got.shape == (g, 3 * h, hp) and got.dtype == torch.float32 and got.is_contiguous()
    torch.testing.assert_close(got[..., :h], w, rtol=0, atol=0)
    assert not got[..., h:].any()
    assert (got is w) == (hp == h) and padded_weight_bwd(w) is got
