"""Port parity: cruse_tpu_torch's eval TFCM (block, stack, the kernel's plain
version and its CPU wrappers) against cruse_tpu, on the CPU.

Weights cross through the weight bridge with BatchNorm statistics and PReLU
slopes perturbed on the JAX side, so a fold or a bridge that ignored them
fails. The JAX Pallas kernels run in interpret mode, as
tests/test_tfcm_kernel.py runs them. Tolerance 1e-5 max-abs: float32 nets of
the same layers, summed in another order.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cruse_tpu.models.mtfaa import TFCM as JaxTFCM
from cruse_tpu.models.mtfaa import TFCMBlock as JaxTFCMBlock
from cruse_tpu.ops.tfcm_kernel import fused_tfcm_block_eval as jax_block_eval
from cruse_tpu.ops.tfcm_kernel import fused_tfcm_stack_eval as jax_stack_eval
from cruse_tpu.ops.tfcm_kernel import tfcm_stack_params

from cruse_tpu_torch.models.mtfaa import TFCM, TFCMBlock
from cruse_tpu_torch.ops.tfcm_kernel import (
    MIN_BLOCKS_PER_SM, SMEM_BYTES, _blocking, _layer_plan, blocks_per_sm, fold_eval_params,
    fused_tfcm_block_eval, fused_tfcm_stack_eval, layer_smem_bytes, params_per_layer, tfcm_stack_reference)
from cruse_tpu_torch.utils.weights import mtfaa_state_dict_from_flax


def perturbed(variables, rng):
    """BatchNorm statistics and PReLU slopes moved off their defaults."""
    def bump(path, a):
        name = path[-1].key
        if name == "mean":
            return a + rng.standard_normal(a.shape).astype(np.float32) * 0.2
        if name == "var":
            return a + rng.uniform(0.2, 0.6, a.shape).astype(np.float32)
        if name in ("negative_slope", "scale"):
            return a + rng.uniform(0.05, 0.3, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(bump, jax.tree_util.tree_map(np.asarray, variables))


def make_pair(jax_module, torch_module, x, rng):
    variables = perturbed(jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    torch_module.load_state_dict(mtfaa_state_dict_from_flax(variables), strict=True)
    return variables, torch_module.eval()


def raw_params(variables, n_layers):
    """JAX stack params -> the port's per-block dicts (PARAM_KEYS) as tensors."""
    blocks = tfcm_stack_params(variables["params"], variables["batch_stats"], n_layers)
    return [{k: torch.from_numpy(np.array(v, np.float32)) for k, v in b.items()} for b in blocks]


@pytest.mark.parametrize("t", [19, 37, 100])
@pytest.mark.parametrize("d", [1, 4, 8])
def test_block_matches_jax(rng, d, t):
    x = rng.standard_normal((2, 6, 8, t)).astype(np.float32)
    jax_block = JaxTFCMBlock(8, d)
    variables, block = make_pair(jax_block, TFCMBlock(8, d), x, rng)
    ref, _ = jax_block.apply(variables, jnp.asarray(x), None, False)
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("t", [19, 37, 100])
def test_stack_matches_jax(rng, t):
    x = rng.standard_normal((2, 10, 12, t)).astype(np.float32)
    jax_stack = JaxTFCM(12, 4)
    variables, stack = make_pair(jax_stack, TFCM(12, 4), x, rng)
    ref, _ = jax_stack.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = stack(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("d,tc,t,c,k", [(1, 16, 37, 8, 16), (4, 16, 37, 8, 16), (8, 32, 100, 24, 64)])
def test_block_wrapper_and_reference_match_pallas(rng, d, tc, t, c, k):
    """The port's fused_tfcm_block_eval (on the CPU: the plain version) and
    tfcm_stack_reference against the JAX Pallas block kernel, interpreted."""
    x = rng.standard_normal((2, k, c, t)).astype(np.float32)
    variables = perturbed(JaxTFCMBlock(c, d).init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    p, s = variables["params"], variables["batch_stats"]
    ref = jax_block_eval(
        jnp.asarray(x), p["pconv1_kernel"], p["pconv1_bias"],
        p["bn1"]["scale"], p["bn1"]["bias"], s["bn1"]["mean"], s["bn1"]["var"],
        p["prelu1"]["negative_slope"], p["dw_kernel"], p["dw_bias"],
        p["bn2"]["scale"], p["bn2"]["bias"], s["bn2"]["mean"], s["bn2"]["var"],
        p["prelu2"]["negative_slope"], p["pconv2_kernel"], p["pconv2_bias"],
        dilation=d, t_chunk=tc, interpret=True)
    params = fold_eval_params(raw_params({"params": {"block_0": p}, "batch_stats": {"block_0": s}}, 1))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(fused_tfcm_block_eval(xt, params, dilation=d).numpy(),
                               np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(tfcm_stack_reference(xt, params, (d,)).numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("n_layers", [3, 6])
def test_stack_matches_jax_at_other_depths(rng, n_layers):
    """An odd number of layers and config 5's default depth (6): the port's
    module and its stack wrapper against the JAX module and the JAX Pallas
    stack kernel, interpreted (T=50 < 2 x 32, the last layer's 2d)."""
    x = rng.standard_normal((2, 9, 12, 50)).astype(np.float32)
    jax_stack = JaxTFCM(12, n_layers)
    variables, stack = make_pair(jax_stack, TFCM(12, n_layers), x, rng)
    ref, _ = jax_stack.apply(variables, jnp.asarray(x))
    dils = tuple(2 ** i for i in range(n_layers))
    kernel = jax_stack_eval(jnp.asarray(x), tfcm_stack_params(variables["params"], variables["batch_stats"],
                                                              n_layers), dilations=dils, t_chunk=16,
                            interpret=True)
    with torch.no_grad():
        got = stack(torch.from_numpy(x))
    wrapped = fused_tfcm_stack_eval(torch.from_numpy(x), fold_eval_params(raw_params(variables, n_layers)),
                                    dilations=dils)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(wrapped.numpy(), np.asarray(kernel), atol=1e-5)


def test_stack_wrapper_matches_pallas_with_halo_before_start(rng):
    """T=19 in time tiles of 8: a later tile's halo reaches before t=0."""
    x = rng.standard_normal((2, 16, 8, 19)).astype(np.float32)
    variables = perturbed(JaxTFCM(8, 2).init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    bp = tfcm_stack_params(variables["params"], variables["batch_stats"], 2)
    ref = jax_stack_eval(jnp.asarray(x), bp, dilations=(1, 2), t_chunk=8, interpret=True)
    got = fused_tfcm_stack_eval(torch.from_numpy(x), fold_eval_params(raw_params(variables, 2)),
                                dilations=(1, 2), t_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_wrappers_check_their_inputs_and_count_no_cpu_launch(rng):
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 12)).astype(np.float32))
    params = torch.zeros(2, params_per_layer(8))
    fused_tfcm_stack_eval.launches = fused_tfcm_block_eval.launches = 0
    fused_tfcm_stack_eval(x, params, dilations=(1, 2))
    fused_tfcm_block_eval(x, params[:1], dilation=3)
    assert fused_tfcm_stack_eval.launches == 0 and fused_tfcm_block_eval.launches == 0
    bad = [
        (x[0], params, (1, 2)),  # 3-D x
        (x.double(), params, (1, 2)),  # float64 x
        (x, params, (1,)),  # 2 layers of params for 1 dilation
        (x, params[:, :-1], (1, 2)),  # wrong parameter count for C=8
        (x, params, (1, 0)),  # dilation 0
        (x, params.double(), (1, 2)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fused_tfcm_stack_eval(args[0], args[1], dilations=args[2])
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_tfcm_stack_eval(x.to("meta"), params.to("meta"), dilations=(1, 2))


STAGES = [(64, 24, 626), (32, 32, 626), (16, 48, 626), (128, 4, 626)]  # config 5b, B=16 x 10 s


@pytest.mark.parametrize("layer", range(4))
@pytest.mark.parametrize("shape", STAGES + [(7, 4, 19)])
def test_layer_plan_fits_shared_memory(shape, layer):
    """Each layer's tile at config 5b's stage shapes (and a small ragged one)
    is chosen for its own dilation, fits shared memory, leaves two blocks an
    SM at the stage shapes, and covers whole band groups; a fixed side is
    kept; a tile that cannot fit raises."""
    k, c, t = shape
    dils = (1, 2, 4, 8)
    d = dils[layer]
    tile = _layer_plan(16, k, c, t, dils, None, None)[layer]
    p = _blocking(c)[0]
    assert 1 <= tile.kt <= k and 1 <= tile.tt <= t
    assert tile.kt % p == 0 or tile.kt == k
    assert tile.smem == layer_smem_bytes(c, tile.kt, tile.tt, d) <= SMEM_BYTES
    bands = -(-tile.kt // p) * p + 2
    assert tile.smem >= 4 * (params_per_layer(c) + bands * c * (tile.tt + 2 * d))
    if shape in STAGES:
        assert blocks_per_sm(tile.smem) >= MIN_BLOCKS_PER_SM
    fixed = _layer_plan(16, k, c, t, dils, 8, 3)[layer]
    assert (fixed.kt, fixed.tt) == (3, 8)
    with pytest.raises(ValueError, match="shared memory"):
        _layer_plan(16, k, c, t, dils, 10_000, k)


@pytest.mark.parametrize("d,blocks", [(16, 2), (32, 1), (64, 1)])
def test_layer_plan_takes_one_block_an_sm_only_where_two_do_not_fit(d, blocks):
    """At C=48 a one-layer halo of 2d frames outgrows the two-block budget
    from d=32 (config 5's last layer): the tile then takes up to a whole
    block's shared memory."""
    tile = _layer_plan(2, 16, 48, 626, (d,), None, None)[0]
    assert tile.smem <= SMEM_BYTES and min(blocks_per_sm(tile.smem), 2) == blocks


@pytest.mark.parametrize("n_layers", [1, 2, 3, 4, 6])
def test_layer_plan_buffers_ping_pong(n_layers):
    """Layer 0 reads x, each later layer reads what the one before wrote, no
    layer reads the buffer it writes, x is never written, the last layer
    writes out, and a scratch buffer appears only with two layers or more."""
    dils = tuple(2 ** i for i in range(n_layers))
    plan = _layer_plan(2, 10, 24, 100, dils, None, None)
    assert len(plan) == n_layers
    assert plan[0].src == "x" and plan[-1].dst == "out"
    assert all(tile.src != tile.dst and tile.dst in ("out", "scratch") for tile in plan)
    assert all(later.src == earlier.dst for earlier, later in zip(plan, plan[1:]))
    assert ("scratch" in {tile.dst for tile in plan}) == (n_layers > 1)


def test_folded_parameters_follow_a_change_of_weights(rng):
    """The stack keeps its folded parameters between forwards; a change of
    any weight or statistic in place (as load_state_dict makes) refolds."""
    x = torch.from_numpy(rng.standard_normal((1, 6, 8, 15)).astype(np.float32))
    stack = TFCM(8, 2).eval()
    with torch.no_grad():
        before = stack(x)
        again = stack(x)
        stack.block_1.bn2.mean.add_(0.5)
        after = stack(x)
        fresh = TFCM(8, 2).eval()
        fresh.load_state_dict(stack.state_dict())
    torch.testing.assert_close(again, before, rtol=0, atol=0)
    assert float((after - before).abs().max()) > 1e-3
    torch.testing.assert_close(after, fresh(x), rtol=0, atol=0)
