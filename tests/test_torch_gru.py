"""Port parity: the grouped-GRU recurrence and layers of cruse_tpu_torch
against cruse_tpu, on the CPU (the wrapper's plain version).

Inputs come from a numpy seed and go through both packages. Tolerances:
1e-5 for float32 (two float32 implementations of the same sums); 1e-3 for
bf16 recurrent weights, because bf16 rounds at other places in the two
frameworks.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.nn.gru import GGRUBottleneck as JaxGGRU
from cruse_tpu.nn.gru import GroupedGRULayer as JaxGroupedGRULayer
from cruse_tpu.nn.gru import channel_shuffle as jax_channel_shuffle
from cruse_tpu.nn.gru import gru_scan as jax_gru_scan
from cruse_tpu.ops.gru_kernel import gru_sequence_pallas

from cruse_tpu_torch.nn.gru import GGRUBottleneck, GroupedGRULayer, channel_shuffle, gru_scan
from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops import gru_kernel
from cruse_tpu_torch.ops.gru_kernel import (
    RESIDENT_MIN_T, SHARED_LIMIT, gru_sequence, gru_sequence_reference, packed_weight, resident_plan,
    transposed_weight)


def _gru_inputs(rng, b, t, g, h):
    return (rng.standard_normal((b, t, g, 3 * h)).astype(np.float32),
            rng.standard_normal((b, g, h)).astype(np.float32),
            (rng.standard_normal((g, 3 * h, h)) * 0.3).astype(np.float32),
            (rng.standard_normal((g, 3 * h)) * 0.1).astype(np.float32))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("t", [10, 13])
def test_reference_matches_gru_scan(rng, t):
    args = _gru_inputs(rng, 2, t, 2, 8)
    y_ref, h_ref = jax_gru_scan(*_jax(args))
    y, h = gru_sequence_reference(*_torch(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5)


@pytest.mark.parametrize("t", [10, 13])  # 13: the TPU kernel pads its tail to 16
def test_reference_matches_pallas_interpret(rng, t):
    args = _gru_inputs(rng, 3, t, 2, 8)
    y_pal, h_pal = gru_sequence_pallas(*_jax(args), interpret=True)
    y, h = gru_sequence(*_torch(args))  # CPU tensors: the plain version
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pal), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_pal), atol=1e-5)


def test_bf16_weights_match_pallas_interpret(rng):
    args = _gru_inputs(rng, 2, 13, 2, 8)
    y_pal, h_pal = gru_sequence_pallas(*_jax(args), interpret=True, weight_dtype=jnp.bfloat16)
    y, h = gru_sequence(*_torch(args), weight_dtype=torch.bfloat16)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pal), atol=1e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_pal), atol=1e-3)
    # and bf16 really is applied: it moves the result off the f32 recurrence
    y32, _ = gru_sequence(*_torch(args))
    assert np.abs(y.numpy() - y32.numpy()).max() > 1e-5


def test_wrapper_on_cpu_counts_no_launch(rng):
    args = _torch(_gru_inputs(rng, 2, 5, 2, 4))
    before = gru_sequence.launches
    y, h = gru_sequence(*args)
    y_ref, h_ref = gru_scan(*args)
    assert gru_sequence.launches == before
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(h, h_ref, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["h0_shape", "w_hh_shape", "weight_dtype", "meta_device"])
def test_wrapper_rejects(rng, case):
    x, h0, w, b = _torch(_gru_inputs(rng, 2, 5, 2, 4))
    kwargs = {}
    if case == "h0_shape":
        h0 = h0[:, :1]
    elif case == "w_hh_shape":
        w = w[:, :, :3]
    elif case == "weight_dtype":
        kwargs["weight_dtype"] = torch.float16
    else:  # neither cpu nor cuda: no path runs the plain version instead
        x, h0, w, b = (a.to("meta") for a in (x, h0, w, b))
    with pytest.raises(ValueError):
        gru_sequence(x, h0, w, b, **kwargs)


def test_transposed_weight_cache_invalidates():
    """The kernel's [G, H, 3H] copy of w_hh is made once per weight and made
    again after any in-place write (load_state_dict included) or for another
    dtype."""
    from cruse_tpu_torch.ops.gru_kernel import transposed_weight

    layer = GroupedGRULayer(8, 8, 2)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    w = layer.w_hh
    first = transposed_weight(w, torch.float32)
    assert transposed_weight(w, torch.float32) is first
    torch.testing.assert_close(first, w.detach().transpose(1, 2), rtol=0, atol=0)
    assert transposed_weight(w, torch.bfloat16).dtype == torch.bfloat16
    new_state = {k: v + 1.0 for k, v in layer.state_dict().items()}
    layer.load_state_dict(new_state)
    again = transposed_weight(w, torch.float32)
    assert again is not first
    torch.testing.assert_close(again, new_state["w_hh"].transpose(1, 2), rtol=0, atol=0)
    with torch.no_grad():
        w.mul_(2.0)
    torch.testing.assert_close(transposed_weight(w, torch.float32), w.detach().transpose(1, 2),
                               rtol=0, atol=0)
    with torch.inference_mode():  # inference tensors have no version counter: no cache
        frozen = torch.ones(2, 6, 2)
        assert transposed_weight(frozen, torch.float32) is not transposed_weight(frozen, torch.float32)


@pytest.mark.parametrize("shape, dtype, cs, units", [
    ((256, 1001, 4, 176), None, 2, 88),  # config 1: a cluster of 2, 88 units a block
    # bf16 weights would fit one block (186 KB), but a block holds at most 96
    # units (4 threads a unit), so config 1 takes a cluster of 2 here too
    ((256, 1001, 4, 176), torch.bfloat16, 2, 88),
    ((8, 1, 4, 176), None, 2, 88),  # the streaming hop
    ((3, 7, 3, 50), None, 1, 52),  # units rounded up to a multiple of 4
    ((3, 7, 2, 177), None, 2, 92),  # an odd split: 92 + 85 units
    ((5, 6, 2, 200), None, 4, 52),
    ((5, 6, 2, 256), None, 4, 64),
    ((3, 5, 2, 350), None, 8, 44),
    ((3, 5, 2, 384), torch.bfloat16, 8, 48),
    ((3, 5, 2, 384), None, 16, 24),  # f32: no cluster of 8 holds [384][3][48]; 16 blocks at 16 rows do
    ((13, 5, 2, 500), torch.bfloat16, 16, 32),
])
def test_resident_plan(shape, dtype, cs, units):
    plan = resident_plan(*shape, dtype)
    assert plan[:2] == (cs, units) and plan.rows == 16
    h, itemsize = shape[3], 2 if dtype == torch.bfloat16 else 4
    assert plan[2] == -(-h * 3 * units * itemsize // 16) * 16 + 2 * h * 16 * 4 <= SHARED_LIMIT == 232448
    assert cs * units >= h > (cs - 1) * units  # every block of the cluster owns a unit
    # and no smaller cluster would do
    smaller = [c for c in gru_kernel.CLUSTER_SIZES if c < cs]
    for c in smaller:
        u = -(-h // (4 * c)) * 4
        assert h * 3 * u * itemsize + 2 * h * 16 * 4 > SHARED_LIMIT or u > gru_kernel.MAX_UNITS


@pytest.mark.parametrize("shape, dtype", [
    ((16 * 64, 5, 1, 384), None),  # float32 fits 16 blocks at 16 rows, but 64 clusters take 10 waves of 7
    ((3, 5, 2, 600), None), ((16 * 64, 5, 1, 500), torch.bfloat16),  # no cluster holds it; 64 clusters of 16
    ((256, RESIDENT_MIN_T - 1, 4, 176), None),  # fewer steps than the resident kernel's least
])
def test_resident_plan_none_takes_streamed_kernel(shape, dtype):
    """The row-tiled kernel takes these; with 12 co-resident clusters (8
    waves of them) the launches that fit 16 blocks take the resident kernel."""
    assert resident_plan(*shape, dtype) is None
    if shape[3] != 600 and shape[1] >= RESIDENT_MIN_T:
        assert resident_plan(*shape, dtype, clusters=12).cs == 16


def test_resident_min_t_routes(monkeypatch):
    """Below the least T the plan is None whatever fits; from it on, the fit."""
    monkeypatch.setattr(gru_kernel, "RESIDENT_MIN_T", 3)
    assert resident_plan(256, 2, 4, 176) is None
    assert resident_plan(256, 3, 4, 176) == gru_kernel.cluster_fit(176) == (2, 88, 208384, 16)


@pytest.mark.parametrize("g, h, cs", [(2, 8, 1), (3, 10, 4), (2, 5, 4), (1, 13, 2), (2, 7, 8), (1, 70, 16),
                                      (2, 33, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weight_matches_indexing(rng, g, h, cs, dtype):
    """[g, c, k, gate, u] is w_hh[g, gate * H + c * U + u, k]; the padding is zero."""
    w = torch.from_numpy(rng.standard_normal((g, 3 * h, h)).astype(np.float32))
    packed = packed_weight(w, dtype, cs)
    u = -(-h // (4 * cs)) * 4
    assert packed.shape == (g, cs, h, 3, u) and packed.dtype == dtype and packed.is_contiguous()
    want = torch.zeros(g, cs, h, 3, u)
    for c in range(cs):
        for gate in range(3):
            for unit in range(u):
                if c * u + unit < h:
                    want[:, c, :, gate, unit] = w[:, gate * h + c * u + unit, :]
    torch.testing.assert_close(packed.float(), want.to(dtype).float(), rtol=0, atol=0)


def test_packed_weight_cache_invalidates():
    """The resident kernel's copy of w_hh is made once per weight, dtype and
    cluster size, and made again after any in-place write."""
    layer = GroupedGRULayer(8, 8, 2)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    w = layer.w_hh
    first = packed_weight(w, torch.float32, 2)
    assert packed_weight(w, torch.float32, 2) is first
    assert packed_weight(w, torch.float32, 1) is not first
    assert packed_weight(w, torch.bfloat16, 2).dtype == torch.bfloat16
    first = packed_weight(w, torch.float32, 2)
    new_state = {k: v + 1.0 for k, v in layer.state_dict().items()}
    layer.load_state_dict(new_state)
    again = packed_weight(w, torch.float32, 2)
    assert again is not first
    torch.testing.assert_close(again[:, 0, :, 0, 0], new_state["w_hh"][:, 0, :], rtol=0, atol=0)
    with torch.no_grad():
        w.mul_(2.0)
    torch.testing.assert_close(packed_weight(w, torch.float32, 2)[:, 0, :, 1, 1],
                               w.detach()[:, 4 + 1, :], rtol=0, atol=0)
    with torch.inference_mode():  # inference tensors have no version counter: no cache
        frozen = torch.ones(2, 6, 2)
        assert packed_weight(frozen, torch.float32, 2) is not packed_weight(frozen, torch.float32, 2)


def _recurrence_by_slices(x_proj, h0, w_hh, b_hh, cs, parts=8):
    """The resident kernel's decomposition in plain PyTorch: block c of the
    cluster computes the units [c * U, (c + 1) * U) from its slice of the packed
    weight, each sum over k taken in `parts` interleaved partial sums that are
    then added pairwise, and the blocks' units together are the next state."""
    g, h3, h = w_hh.shape
    packed = packed_weight(w_hh, torch.float32, cs)  # [G, CS, K, 3, U]
    u = packed.shape[-1]
    state, ys = h0, []
    for t in range(x_proj.shape[1]):
        new = []
        for c in range(cs):
            units = range(c * u, min(h, (c + 1) * u))
            if not len(units):
                continue
            sums = [torch.einsum("bgk,gkju->bgju", state[:, :, p::parts], packed[:, c, p::parts])
                    for p in range(parts)]
            while len(sums) > 1:
                sums = [a + b for a, b in zip(sums[::2], sums[1::2])]
            hp = sums[0][..., :len(units)] + b_hh.reshape(g, 3, h)[:, :, units.start:units.stop]
            xg = x_proj[:, t].reshape(-1, g, 3, h)[..., units.start:units.stop]
            r = torch.sigmoid(xg[:, :, 0] + hp[:, :, 0])
            z = torch.sigmoid(xg[:, :, 1] + hp[:, :, 1])
            n = torch.tanh(xg[:, :, 2] + r * hp[:, :, 2])
            new.append((1.0 - z) * n + z * state[..., units.start:units.stop])
        state = torch.cat(new, dim=-1)
        ys.append(state)
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("shape, cs", [((3, 9, 2, 8), 1), ((3, 9, 2, 8), 2), ((2, 6, 3, 10), 4),
                                       ((17, 4, 1, 13), 2), ((2, 5, 2, 5), 4), ((2, 5, 1, 37), 8),
                                       # 16 blocks at 16 rows (8 k parts), and at 8 rows (16 k parts)
                                       ((5, 6, 1, 70), (16, 16)), ((11, 5, 2, 40), (16, 8))])
def test_recurrence_by_unit_slices_matches_reference_and_jax(rng, shape, cs):
    cs, rows = cs if isinstance(cs, tuple) else (cs, 16)
    args = _gru_inputs(rng, *shape)
    y, h = _recurrence_by_slices(*_torch(args), cs, parts=8 if rows == 16 else 16)
    y_ref, h_ref = gru_sequence_reference(*_torch(args))
    y_jax, h_jax = jax_gru_scan(*_jax(args))
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_jax), atol=1e-5)


def _recurrence_by_row_tiles(x_proj, h0, w_hh, b_hh, rows, weight_dtype=None, chunk=gru_kernel.ROWS_CHUNK):
    """The row-tiled kernel's walk in plain PyTorch: the batch in tiles of
    `rows` rows (the last padded with zero rows), each tile on its own for
    all T steps; a step's sums over k taken in order, k after k, chunk after
    chunk of the padded transposed weight [G, H, 3 Hp], the state read at
    the weight's precision and kept exact."""
    b, t, g, h3 = x_proj.shape
    h = h3 // 3
    w_t = transposed_weight(w_hh, weight_dtype or torch.float32).float()  # [G, H, 3 Hp]
    padded = w_t.shape[-1] // 3
    tiles = -(-b // rows)
    xs = torch.nn.functional.pad(x_proj, (0, 0, 0, 0, 0, 0, 0, tiles * rows - b))
    states = torch.nn.functional.pad(h0, (0, 0, 0, 0, 0, tiles * rows - b))
    bias = b_hh.reshape(g, 3, h)
    ys = torch.empty(tiles * rows, t, g, h)
    for tile in range(tiles):
        span = slice(tile * rows, (tile + 1) * rows)
        state = states[span]
        for step in range(t):
            q = state if weight_dtype is None else state.to(weight_dtype).float()
            acc = torch.zeros(rows, g, 3 * padded)
            for c in range(0, h, chunk):
                for k in range(c, min(c + chunk, h)):
                    acc = acc + q[:, :, k, None] * w_t[None, :, k]
            hp = acc.reshape(rows, g, 3, padded)[..., :h]
            xg = xs[span, step].reshape(rows, g, 3, h)
            r = torch.sigmoid(xg[:, :, 0] + (hp[:, :, 0] + bias[:, 0]))
            z = torch.sigmoid(xg[:, :, 1] + (hp[:, :, 1] + bias[:, 1]))
            n = torch.tanh(xg[:, :, 2] + r * (hp[:, :, 2] + bias[:, 2]))
            state = (1.0 - z) * n + z * state
            ys[span, step] = state
    return ys[:b], ys[:b, -1]


@pytest.mark.parametrize("shape, rows", [((13, 7, 1, 12), 8), ((21, 5, 1, 20), 16), ((33, 4, 1, 9), 32),
                                         ((5, 6, 1, 17), 8), ((19, 3, 2, 12), 16)])
def test_row_tiled_walk_matches_reference_and_pallas(rng, shape, rows):
    """Ragged B (a last tile with few live rows), H off a chunk of k rows
    and off the 4-unit groups (H = 17, 9: padded units), G = 1 and 2."""
    args = _gru_inputs(rng, *shape)
    y, h = _recurrence_by_row_tiles(*_torch(args), rows, chunk=8)
    y_ref, h_ref = gru_sequence_reference(*_torch(args))
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), atol=1e-5)
    y_pal, h_pal = gru_sequence_pallas(*_jax(args), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pal), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_pal), atol=1e-5)


def test_row_tiled_walk_bf16_weights_matches_reference(rng):
    """bf16 weights: the walk rounds the state at the product only (the tile
    keeps it exact) and matches the plain version's bf16 math."""
    args = _torch(_gru_inputs(rng, 11, 6, 1, 13))
    y, h = _recurrence_by_row_tiles(*args, 8, weight_dtype=torch.bfloat16)
    y_ref, h_ref = gru_sequence_reference(*args, weight_dtype=torch.bfloat16)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("h, dtype, padded", [(12, torch.float32, 12), (13, torch.float32, 16),
                                              (12, torch.bfloat16, 16), (384, torch.bfloat16, 384)])
def test_transposed_weight_pads_units(rng, h, dtype, padded):
    """[g, k, gate * Hp + j] is w_hh[g, gate * H + j, k]; units H .. Hp - 1 are
    zero, so that a k row is whole 16-byte chunks."""
    w = torch.from_numpy(rng.standard_normal((2, 3 * h, h)).astype(np.float32))
    got = transposed_weight(w, dtype)
    assert got.shape == (2, h, 3 * padded) and got.dtype == dtype and got.is_contiguous()
    assert gru_kernel.padded_units(h, dtype) == padded
    want = torch.zeros(2, h, 3, padded)
    want[..., :h] = w.reshape(2, 3, h, h).permute(0, 3, 1, 2)
    torch.testing.assert_close(got.float(), want.reshape(2, h, -1).to(dtype).float(), rtol=0, atol=0)


@pytest.mark.parametrize("b, g, h, rows", [
    (16 * 257, 1, 384, 32),  # FullSubNet's sub band offline: 129 blocks
    (8 * 257, 1, 384, 16),  # in its train step (and the 8-slot server): 129 blocks
    (257, 1, 384, 8),  # its hop at B=1
    (16 * 257, 1, 512, 16),  # H = 512: 32 rows would need 512 consumer threads
    (3, 2, 176, 8), (256, 4, 176, 8),  # few blocks: the smallest tile
])
def test_row_tile(b, g, h, rows):
    """The tile with the fewest rows x waves of 132 blocks, the largest of
    those that tie; every tile of ROW_TILES that fits H is a candidate."""
    assert gru_kernel.row_tile(b, g, h) == rows
    assert gru_kernel.rows_fit(h, rows)
    waves = -(-g * -(-b // rows) // gru_kernel.NUM_SMS)
    for other in gru_kernel.ROW_TILES:
        if gru_kernel.rows_fit(h, other):
            assert -(-g * -(-b // other) // gru_kernel.NUM_SMS) * other >= waves * rows


@pytest.mark.parametrize("h, rows, dtype, threads, stages, fits", [
    (384, 32, None, 384, 2, True),  # the sub band: 2 stages of 73,744 B beside a 49,152 B tile
    (384, 8, None, 96, 2, True),  # its hop
    (512, 16, None, 256, 2, True),  # 2 x 98,320 + 32,768 = 229,408 B
    (512, 32, None, 512, 1, False),  # too many threads, and 1 stage beside a 64 KB tile
    (177, 8, torch.bfloat16, 64, 8, True),  # bf16 pads 177 to 184 units; at most 8 stages
])
def test_rows_fit(h, rows, dtype, threads, stages, fits):
    """Threads, ring depth and shared memory of the row-tiled kernel, as
    csrc/gru_sequence.cu's launch_rows computes them."""
    assert gru_kernel.rows_threads(h, rows, dtype) == threads
    assert gru_kernel.rows_stages(h, rows, dtype) == stages
    stage = 16 * 3 * gru_kernel.padded_units(h, dtype) * (2 if dtype == torch.bfloat16 else 4) + 16
    assert stages == min(8, (SHARED_LIMIT - h * rows * 4) // stage)  # the ring, then the [H][R] f32 tile
    assert gru_kernel.rows_fit(h, rows, dtype) is fits
    assert fits is (stages >= 2 and threads <= 384)
    assert not gru_kernel.rows_fit(513, 8) and not gru_kernel.rows_fit(h, 4, dtype)


def test_launchers_refuse_cpu_tensors(rng):
    """The two launchers never run the plain version: on CPU tensors they raise."""
    args = _torch(_gru_inputs(rng, 2, 3, 2, 4))
    for launch in (gru_kernel.launch_resident, gru_kernel.launch_streamed):
        before = gru_sequence.launches, gru_sequence.resident_launches
        with pytest.raises(ValueError, match="CUDA tensors only"):
            launch(*args)
        assert (gru_sequence.launches, gru_sequence.resident_launches) == before
    with pytest.raises(ValueError, match="no tile of 4 rows"):  # R outside ROW_TILES
        gru_kernel.launch_streamed(*args, rows=4)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    cmd = _build.nvcc_command("nvcc", _build.SRC_DIR / "gru_sequence.cu", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
    assert "--use_fast_math" not in cmd
    with pytest.raises(RuntimeError, match="source missing"):
        _build.load_library("no_such_kernel")


def _layer_params(variables):
    p = variables["params"]
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def test_grouped_gru_layer_matches_jax(rng):
    b, t, i, hid, g = 2, 9, 12, 16, 4
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    h0 = rng.standard_normal((b, g, hid // g)).astype(np.float32)
    jl = JaxGroupedGRULayer(hid, g)
    variables = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_ref, h_ref = jl.apply(variables, jnp.asarray(x), jnp.asarray(h0))

    layer = GroupedGRULayer(i, hid, g)
    layer.load_state_dict(_layer_params(variables), strict=True)
    with torch.no_grad():
        y, h = layer(torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5)


def test_channel_shuffle_matches_jax(rng):
    x = rng.standard_normal((2, 3, 12)).astype(np.float32)
    np.testing.assert_array_equal(channel_shuffle(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(jax_channel_shuffle(jnp.asarray(x), 4)))


def test_ggru_bottleneck_matches_jax(rng):
    from cruse_tpu_torch.utils.weights import flatten_tree

    b, t, d, g = 2, 7, 16, 4
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    state = tuple(rng.standard_normal((b, g, d // g)).astype(np.float32) for _ in range(2))
    jm = JaxGGRU(groups=g)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # non-default LayerNorm affine, so a missed copy shows
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.3, a.shape).astype(np.float32), variables)
    y_ref, (h1_ref, h2_ref) = jm.apply(variables, jnp.asarray(x), tuple(map(jnp.asarray, state)))

    module = GGRUBottleneck(d, g)
    sd = {k.replace("/", ".").replace(".scale", ".weight"): torch.from_numpy(np.asarray(v))
          for k, v in flatten_tree(variables["params"]).items()}
    module.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y, (h1, h2) = module(torch.from_numpy(x), tuple(map(torch.from_numpy, state)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(h1.numpy(), np.asarray(h1_ref), atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h2_ref), atol=1e-5)
