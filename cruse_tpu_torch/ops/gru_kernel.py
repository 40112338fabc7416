"""Grouped-GRU recurrence: the CUDA kernel's wrapper and its plain version.

Counterpart of ``cruse_tpu/ops/gru_kernel.py::gru_sequence_pallas``, with its
signature and layouts: ``x_proj [B, T, G, 3H]`` (input projection already
applied), ``h0 [B, G, H]``, ``w_hh [G, 3H, H]``, ``b_hh [G, 3H]``; returns
``(y [B, T, G, H], h_last [B, G, H])`` in float32, torch gate order (r, z, n).

``gru_sequence`` runs the plain version for tensors on the CPU and launches
a hand-written kernel (``csrc/gru_sequence.cu``, one launch for all T steps)
for tensors on a CUDA device; on a CUDA device it launches or raises. The
source holds two kernels, and the shape decides which one runs
(``resident_plan``), with the card's count of co-resident 16-block clusters
(``co_resident_clusters``, asked once a device and width) where a cluster of
16 is the only fit:

- route A, the resident kernel, keeps the recurrent weight in the shared
  memory of a cluster of 1, 2, 4 or 8 thread blocks at 16 batch rows a
  cluster (CRUSE's H = 176: 2 blocks) or, where none of those holds it, of a
  non-portable cluster of 16 blocks at 16 rows or else 8 (FullSubNet's full
  band, H = 512 in f32: 16 blocks x 8 rows), for all T steps. It takes every
  shape whose slice fits a block's shared memory, from ``RESIDENT_MIN_T``
  steps on, and a cluster of 16 only where the launch's clusters run in few
  waves (``HOP_CLUSTER_WAVES`` at T = 1, ``MAX_CLUSTER_WAVES`` over more steps);
- route B, the row-tiled kernel, gives a block R = 8, 16 or 32 rows
  (``row_tile``) and all H units of one group and streams the weight from L2
  through a ring in shared memory every step (``rows_stages`` stages of
  ``ROWS_CHUNK`` k rows). It takes the rest (hidden size
  per group up to ``MAX_HIDDEN``; FullSubNet's sub band, its 257 bins folded
  into the batch, at R = 32).

``gru_sequence.launches`` counts every kernel launch,
``gru_sequence.resident_launches`` those of the resident kernel.

The forward is the custom op ``torch.ops.cruse_tpu_torch.gru_sequence``
(``gru_sequence_op``), so that ``torch.export`` can trace a model that runs
it. Its implementation runs the plain version on CPU tensors and the routed
launch on CUDA tensors; its fake implementation gives the outputs' shapes.
The plan, the weight layouts cached on ``w_hh`` and the launch counters run
inside the implementation, on tensors with storage.

Under a gradient (grad enabled and an input that requires it)
``gru_sequence`` is an ``autograd.Function`` (f32 weights only): its forward
is the same routed kernel, and its backward takes ``hp = h_prev . w_hh^T +
b_hh`` for all t as one batched product, launches a backward kernel
(``csrc/gru_bwd.cu``, one launch for all T steps) for ``dx_proj``, ``dhp`` and
``dh0``, and takes ``dw_hh`` and ``db_hh`` from ``dhp`` as two more products.
That source holds three kernels, and ``resident_bwd_plan`` (``backward_plan``
on a card) decides which one runs:

- route A, the resident backward, keeps w_hh in the shared memory of a
  cluster for all T steps: a cluster of 1, 2, 4 or 8 blocks, each holding its
  units' columns of w_hh and the whole dhp tile, wherever one fits (config 2's
  H = 176: 2 blocks); else a non-portable cluster of 16 blocks, each holding
  its units' rows of w_hh and reduce-scattering the carry's partial sums
  (FullSubNet's full band, H = 512 f32: 16 blocks x 8 rows, the forward's
  ``packed_weight``), where the launch's clusters run in few waves of the
  card's co-resident ones (``co_resident_bwd_clusters``), as in the forward;
- route B, the row-tiled backward, gives a block R = 8, 16 or 32 rows
  (``bwd_row_tile``) and all H units of a group and streams w_hh from L2
  through a ring in shared memory every step. It takes the rest (FullSubNet's
  sub band at R = 16).

``gru_sequence_bwd.launches`` counts every backward launch,
``gru_sequence_bwd.resident_launches`` those of route A. The
JAX step has no kernel here: XLA differentiates ``gru_scan``. On the CPU both
directions run the plain versions (``gru_sequence_reference``,
``gru_sequence_backward_reference``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from cruse_tpu_torch.ops import _build

MAX_HIDDEN = 512  # row-tiled kernel: the largest hidden size per group (kMaxHidden in the source)
GRID_Y_LIMIT = 65535  # blocks a grid may have along y, where every launcher puts the batch's row tiles
SHARED_LIMIT = 232448  # bytes of dynamic shared memory a block may have on sm_90 (kSharedLimit)
CLUSTER_SIZES = (1, 2, 4, 8)  # 8 is the portable limit of a cluster
# resident forward: its (CS, rows a cluster) instances in the order the plan tries them, the portable
# clusters at 16 rows, then 16 blocks (non-portable) at 16 rows and at 8
RESIDENT_TILES = ((1, 16), (2, 16), (4, 16), (8, 16), (16, 16), (16, 8))
# 16-block clusters of the resident kernel that an H100 runs at once, from cudaOccupancyMaxActiveClusters
# at H = 512 and 384 in f32, forward and backward alike (chip_smoke.py prints both); the plans' default where
# it is not asked the card
H100_CLUSTERS = 7
# waves of co-resident 16-block clusters the plan lets one launch take, at T = 1 and over more steps
# (ops/gru_timing.py --sweep on an H100): a wave costs the resident kernel ~30 us to load the slices and 4.4-7.0 us
# a step, the row-tiled kernel's ~12 us and 54-102 us a step. At T = 1 a third wave lost to the row-tiled kernel at
# both of FullSubNet's widths (B = 128 at H = 512, B = 257 at 384); at T = 188, H = 384 the resident kernel won at
# 5 waves and lost at 10, and at T = 626, H = 512 it still won at 10
HOP_CLUSTER_WAVES, MAX_CLUSTER_WAVES = 2, 8
UNIT_GROUP = 4  # both forward kernels: units a thread multiplies, one 16-byte load of a gate's weights (kUnits)
MAX_UNITS = 96  # resident kernel: units a block owns, 4 threads a unit (kResidentThreads)
MAX_UNITS_8 = 64  # and at 8 rows a cluster, where a block keeps 255 registers a thread (kResident8Threads)
# the row-tiled kernel (the k-prefixed constants of csrc/gru_sequence.cu)
ROW_TILES = (32, 16, 8)  # R, the batch rows a block, largest first
ROWS_MAX_THREADS = 384  # threads, (R / 8) row groups x (Hp / 4) unit groups (kRowsMaxThreads)
ROWS_CHUNK = 16  # k rows of the weight a stage of the ring holds (kChunk)
ROWS_STAGES = (2, 8)  # stages of the ring: as many as shared memory holds beside the tile (kMinStages, kMaxStages)
NUM_SMS = 132  # an H100's SMs: the wave row_tile fills
# The least T that takes the resident kernel. Its start-up (a block loads its
# slice of the weight, up to 186 KB, into shared memory) is paid once a launch,
# and still it wins at one step: on an H100 at T = 1, G = 4, H = 176 and B = 256,
# 8, 1 the resident kernel takes 17-18 us of device time, the streamed one 45-46
# (chip_smoke.py times both; PERF.md has the table).
RESIDENT_MIN_T = 1
# The resident backward (csrc/gru_bwd.cu, the k-prefixed constants there).
BWD_TILE_ROWS = 8  # R, the batch rows a cluster (kBwdRows): at config 2 a cluster of 2, 3x as fast as
# R = 16's cluster of 4 (ops/gru_bwd_timing.py --sweep on an H100, R = 16 from a copy of the source)
BWD_PLANE_ROWS = 8  # batch rows a thread multiplies; the dhp tile holds R / 8 planes of them (kPlane)
BWD_PARTS = 16  # parts of the j range a unit group's lanes split (kParts)
BWD_MAX_THREADS = 512  # (U / 4) (R / 8) unit groups x 16 lanes (kBwdMaxThreads)
BWD_PLANE_PAD = 4  # floats after each plane of the tile (kPlanePad)
# the 16-block resident backward (gru_bwd_scatter_kernel, the kScatter constants): 16 blocks (non-portable) of
# 128 threads at 8 rows a cluster, up to 32 units a block and H <= 512
BWD_SCATTER_CS, BWD_SCATTER_ROWS, BWD_SCATTER_THREADS, BWD_SCATTER_MAX_UNITS = 16, 8, 128, 32
# the row-tiled backward: j rows of w_hh a stage of its ring holds (kRowsChunk), the units a lane pair
# multiplies, to which it pads H (kRowsUnits), and the parts of j, a lane each, of a pair (kRowsParts)
BWD_ROWS_CHUNK, BWD_ROWS_UNITS, BWD_ROWS_PARTS = 32, 8, 2
_WEIGHT_DTYPES = {None: "f32", torch.float32: "f32", torch.bfloat16: "bf16w"}


def gru_sequence_reference(x_proj, h0, w_hh, b_hh, weight_dtype=None):
    """The plain PyTorch recurrence: a Python loop over t.

    With ``weight_dtype=torch.bfloat16`` the recurrent weights and, each step,
    the state are rounded to bf16 before the product, which is then taken in
    float32 (a bf16 x bf16 product is exact in float32): the kernel's math.
    """
    hdim = h0.shape[-1]
    w = w_hh if weight_dtype is None else w_hh.to(weight_dtype).float()
    h = h0
    ys = []
    for t in range(x_proj.shape[1]):
        hq = h if weight_dtype is None else h.to(weight_dtype).float()
        hp = torch.einsum("bgh,gkh->bgk", hq, w) + b_hh
        xr, xz, xn = x_proj[:, t].split(hdim, dim=-1)
        hr, hz, hn = hp.split(hdim, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=1), h


def _h_prev(h0, y):
    """The state each step starts from: h0, then y[:, :-1]. [B, T, G, H]."""
    return torch.cat([h0[:, None], y[:, :-1]], dim=1)


def gru_backward_walk_reference(dy, dh_last, x_proj, h0, w_hh, b_hh, y):
    """The backward kernel's plain version: ``(dx_proj [B, T, G, 3H], dhp [B,
    T, G, 3H], dh0 [B, G, H])``, an explicit loop over t from T - 1 down to 0
    with the kernel's formulas (``hp`` recomputed each step from the saved
    states). ``dh_last`` None means zeros."""
    hdim = h0.shape[-1]
    carry = torch.zeros_like(h0) if dh_last is None else dh_last
    dx, dp = [None] * x_proj.shape[1], [None] * x_proj.shape[1]
    for t in range(x_proj.shape[1] - 1, -1, -1):
        h_prev = h0 if t == 0 else y[:, t - 1]
        hp = torch.einsum("bgh,gkh->bgk", h_prev, w_hh) + b_hh
        xr, xz, xn = x_proj[:, t].split(hdim, dim=-1)
        hr, hz, hn = hp.split(hdim, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh = dy[:, t] + carry
        dn_pre = dh * (1.0 - z) * (1.0 - n * n)
        dz_pre = dh * (h_prev - n) * z * (1.0 - z)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dx[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dp[t] = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
        carry = dh * z + torch.einsum("bgk,gkh->bgh", dp[t], w_hh)
    return torch.stack(dx, dim=1), torch.stack(dp, dim=1), carry


def gru_sequence_backward_reference(dy, dh_last, x_proj, h0, w_hh, b_hh, y):
    """The plain backward of ``gru_sequence_reference`` (f32 weights): from the
    gradients ``dy [B, T, G, H]`` and ``dh_last [B, G, H]`` (None: zeros) of its
    outputs and the saved ``y``, ``(dx_proj, dh0, dw_hh, db_hh)``;
    ``dw_hh = sum_{b,t} dhp_t (x) h_prev`` and ``db_hh = sum dhp_t``."""
    dx_proj, dhp, dh0 = gru_backward_walk_reference(dy, dh_last, x_proj, h0, w_hh, b_hh, y)
    dw_hh = torch.einsum("btgk,btgh->gkh", dhp, _h_prev(h0, y))
    return dx_proj, dh0, dw_hh, dhp.sum(dim=(0, 1))


def _check_shapes(x_proj, h0, w_hh, b_hh, weight_dtype):
    if weight_dtype not in _WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be None, torch.float32 or torch.bfloat16, "
                         f"got {weight_dtype}")
    if x_proj.dim() != 4:
        raise ValueError(f"x_proj must be [B, T, G, 3H], got {tuple(x_proj.shape)}")
    b, t, g, h3 = x_proj.shape
    h = h3 // 3
    expected = {"h0": (b, g, h), "w_hh": (g, h3, h), "b_hh": (g, h3)}
    for name, tensor in (("h0", h0), ("w_hh", w_hh), ("b_hh", b_hh)):
        if tuple(tensor.shape) != expected[name]:
            raise ValueError(f"{name} must be {expected[name]} for x_proj "
                             f"{tuple(x_proj.shape)}, got {tuple(tensor.shape)}")
    if h3 % 3 or b < 1 or t < 1:
        raise ValueError(f"x_proj {tuple(x_proj.shape)}: need B, T >= 1 and 3H gates")
    if x_proj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_sequence runs on cpu or cuda tensors, got {x_proj.device}")


class ResidentFit(NamedTuple):
    """A resident-forward instance at one hidden size: ``cs`` blocks a
    cluster of ``units`` hidden units each, ``nbytes`` of shared memory a
    block, ``rows`` batch rows a cluster."""
    cs: int
    units: int
    nbytes: int
    rows: int


def cluster_fit(h, weight_dtype=None):
    """The first of ``RESIDENT_TILES`` whose block holds its slice of the
    weight, ``[H][3][U]`` with ``U = ceil(H / CS)`` units rounded up to a
    multiple of ``UNIT_GROUP``, plus the double-buffered state tile
    ``[2][H][rows]`` in float32, within ``SHARED_LIMIT``, with at most
    ``MAX_UNITS`` units a block (``MAX_UNITS_8`` at 8 rows) (a
    ``ResidentFit``); None where none does."""
    itemsize = 2 if weight_dtype == torch.bfloat16 else 4
    for cs, rows in RESIDENT_TILES:
        u = -(-h // (cs * UNIT_GROUP)) * UNIT_GROUP
        nbytes = -(-h * 3 * u * itemsize // 16) * 16 + 2 * h * rows * 4
        if nbytes <= SHARED_LIMIT and u <= (MAX_UNITS if rows == 16 else MAX_UNITS_8):
            return ResidentFit(cs, u, nbytes, rows)
    return None


def resident_plan(b, t, g, h, weight_dtype=None, clusters=H100_CLUSTERS):
    """``cluster_fit`` of the resident kernel where this shape takes it, None
    where the row-tiled kernel runs: too few steps, no cluster holds the
    weight, or a cluster of 16 whose launch, ``g * ceil(b / rows)`` clusters,
    would take more waves of the ``clusters`` the card runs at once
    (``co_resident_clusters``; 0 where it schedules none: then never) than
    ``HOP_CLUSTER_WAVES`` at T = 1 or ``MAX_CLUSTER_WAVES`` over more steps.
    b and g otherwise only size the grid: ``CS * g`` by ``ceil(b / rows)``
    blocks."""
    if t < RESIDENT_MIN_T or min(b, g, h) < 1:
        return None
    fit = cluster_fit(h, weight_dtype)
    waves = HOP_CLUSTER_WAVES if t == 1 else MAX_CLUSTER_WAVES
    if fit is not None and fit.cs > CLUSTER_SIZES[-1] and g * -(-b // fit.rows) > waves * clusters:
        return None
    return fit


def padded_units(h: int, weight_dtype=None) -> int:
    """The row-tiled kernel's units of a weight row, H rounded up to a
    multiple of 4 (f32) or 8 (bf16), so that a k row of the three gates is a
    whole number of 16-byte chunks."""
    m = 8 if weight_dtype == torch.bfloat16 else 4
    return -(-h // m) * m


def rows_threads(h: int, rows: int, weight_dtype=None) -> int:
    """Threads of a row-tiled block: (R / 8) row groups x (Hp / 4) unit
    groups, rounded up to warps."""
    return -(-(rows // 8) * (padded_units(h, weight_dtype) // UNIT_GROUP) // 32) * 32


def _rows_stage_bytes(h: int, weight_dtype=None) -> int:
    """A stage of the row-tiled kernel's ring, ``[ROWS_CHUNK][3][Hp]``
    weights, with its two mbarriers."""
    itemsize = 2 if weight_dtype == torch.bfloat16 else 4
    return ROWS_CHUNK * 3 * padded_units(h, weight_dtype) * itemsize + 16


def rows_stages(h: int, rows: int, weight_dtype=None) -> int:
    """The row-tiled kernel's ring depth: as many stages as ``SHARED_LIMIT``
    holds beside the state tile ``[H][R]`` f32, at most ``ROWS_STAGES[1]``."""
    return min(ROWS_STAGES[1], max(0, SHARED_LIMIT - h * rows * 4) // _rows_stage_bytes(h, weight_dtype))


def rows_fit(h: int, rows: int, weight_dtype=None) -> bool:
    """Whether a row-tiled block of ``rows`` rows fits at hidden size h: at
    most ``ROWS_MAX_THREADS`` threads and a ring of ``ROWS_STAGES[0]`` or more."""
    return (rows in ROW_TILES and 1 <= h <= MAX_HIDDEN and rows_threads(h, rows, weight_dtype) <= ROWS_MAX_THREADS
            and rows_stages(h, rows, weight_dtype) >= ROWS_STAGES[0])


def _fewest_waves(b: int, g: int, fits: list, sms: int) -> int:
    """Of the row tiles that fit (and keep the grid within ``GRID_Y_LIMIT``
    blocks, where one does), the one with the fewest rows times waves of
    ``sms`` blocks (a block an SM, its step counted in proportion to its
    rows), the largest of those that tie, since each block reads the whole
    weight every step."""
    fits = [r for r in fits if -(-b // r) <= GRID_Y_LIMIT] or fits
    return min(fits, key=lambda r: (-(-g * -(-b // r) // sms) * r, -r))


def row_tile(b: int, g: int, h: int, weight_dtype=None, sms: int = NUM_SMS) -> int:
    """R of the row-tiled kernel for this shape (``_fewest_waves`` of the
    tiles that fit). At FullSubNet's sub band, B = 4112: R = 32, 129 blocks;
    B = 2056: 16, 129; B = 257: 8, 33."""
    fits = [r for r in ROW_TILES if rows_fit(h, r, weight_dtype)]
    if not fits:
        raise ValueError(f"no row tile of {ROW_TILES} fits hidden size per group {h} (at most {MAX_HIDDEN})")
    return _fewest_waves(b, g, fits, sms)


def bwd_padded_units(h: int) -> int:
    """The row-tiled backward's units of a weight row: H rounded up to a
    multiple of ``BWD_ROWS_UNITS``, a lane pair's units."""
    return -(-h // BWD_ROWS_UNITS) * BWD_ROWS_UNITS


def bwd_rows_threads(h: int, rows: int) -> int:
    """Threads of a row-tiled backward block: 2 halves of j x (R / 8) row
    groups x (Hp / 8) unit groups, rounded up to warps."""
    return -(-BWD_ROWS_PARTS * (rows // 8) * (bwd_padded_units(h) // BWD_ROWS_UNITS) // 32) * 32


def bwd_rows_stages(h: int, rows: int) -> int:
    """The row-tiled backward's ring depth: as many stages of
    ``[BWD_ROWS_CHUNK][Hp]`` f32 (with their two mbarriers) as
    ``SHARED_LIMIT`` holds beside the dhp tile ``[3H][R]`` f32, at most
    ``ROWS_STAGES[1]``."""
    stage = BWD_ROWS_CHUNK * bwd_padded_units(h) * 4 + 16
    return min(ROWS_STAGES[1], max(0, SHARED_LIMIT - 3 * h * rows * 4) // stage)


def bwd_rows_fit(h: int, rows: int) -> bool:
    """Whether a row-tiled backward block of ``rows`` rows fits at hidden size
    h: at most ``ROWS_MAX_THREADS`` threads and a ring of ``ROWS_STAGES[0]``
    or more stages."""
    return (rows in ROW_TILES and 1 <= h <= MAX_HIDDEN and bwd_rows_threads(h, rows) <= ROWS_MAX_THREADS
            and bwd_rows_stages(h, rows) >= ROWS_STAGES[0])


def bwd_row_tile(b: int, g: int, h: int, sms: int = NUM_SMS) -> int:
    """R of the row-tiled backward for this shape (``_fewest_waves`` of the
    tiles that fit; R = 8 fits every H up to ``MAX_HIDDEN``). At
    FullSubNet's sub band in the step, B = 2056: R = 16, 129 blocks."""
    fits = [r for r in ROW_TILES if bwd_rows_fit(h, r)]
    if not fits:
        raise ValueError(f"no row tile of {ROW_TILES} fits hidden size per group {h} (at most {MAX_HIDDEN})")
    return _fewest_waves(b, g, fits, sms)


def slice_stride(u: int) -> int:
    """The resident backward's row of the weight slice in shared memory, in
    16-byte chunks: ``U / 4`` rounded up to 2 mod 4, so that a quarter warp's
    8 lanes (4 consecutive rows x 2 unit groups) read 8 bank groups."""
    return u // 4 + (6 - u // 4 % 4) % 4


def resident_bwd_bytes(h: int, u: int, rows: int = BWD_TILE_ROWS) -> int:
    """Shared memory of a resident-backward block: the weight slice, ``3H``
    rows of ``slice_stride(U)`` chunks, plus the double-buffered dhp tile,
    ``[2][R / 8][3H][8]`` floats, each plane padded by ``BWD_PLANE_PAD``, and
    its two 8-byte mbarriers."""
    planes = rows // BWD_PLANE_ROWS
    return 3 * h * slice_stride(u) * 16 + 2 * planes * (3 * h * BWD_PLANE_ROWS + BWD_PLANE_PAD) * 4 + 16


def bwd_threads(u: int, rows: int = BWD_TILE_ROWS) -> int:
    """Threads of a resident-backward block: 16 lanes a (unit group, plane)."""
    return -(-(u // UNIT_GROUP) * (rows // BWD_PLANE_ROWS) // 2) * 32


def bwd_fit_at(h: int, cs: int, rows: int = BWD_TILE_ROWS):
    """``(CS, U, R, shared-memory bytes)`` of the resident backward with a
    cluster of ``cs`` blocks: each holds its slice of the weight, ``[3H][U]``
    with ``U = ceil(H / CS)`` units rounded up to a multiple of ``UNIT_GROUP``,
    plus the dhp tile of ``rows`` rows. None where that exceeds
    ``SHARED_LIMIT`` or ``BWD_MAX_THREADS``, or where a block would own no
    hidden unit (``(CS - 1) U >= H``: it would leave while its peers still
    send into its tile). ``rows`` other than ``BWD_TILE_ROWS`` is for a copy
    of the source built with that R (the sweep). At ``cs`` = 16 it is
    ``scatter_fit``, the 16-block kernel's other layout, at its 8 rows."""
    if cs == BWD_SCATTER_CS:
        return scatter_fit(h) if rows == BWD_SCATTER_ROWS else None
    u = -(-h // (cs * UNIT_GROUP)) * UNIT_GROUP
    nbytes = resident_bwd_bytes(h, u, rows)
    if nbytes > SHARED_LIMIT or bwd_threads(u, rows) > BWD_MAX_THREADS or (cs - 1) * u >= h:
        return None
    return cs, u, rows, nbytes


def bwd_cluster_fit(h: int):
    """``bwd_fit_at`` of the smallest cluster size that has one; None where no
    cluster of up to ``CLUSTER_SIZES[-1]`` blocks holds the weight."""
    return next(filter(None, (bwd_fit_at(h, cs) for cs in CLUSTER_SIZES)), None)


def scatter_stride(u: int) -> int:
    """The 16-block backward's k row of the slice in shared memory, in
    16-byte chunks: ``3U / 4`` rounded up to a multiple of 8, so that the XOR
    swizzle by ``k & 7`` stays inside the row."""
    return -(-(3 * u // 4) // 8) * 8


def scatter_fit(h: int):
    """``(16, U, R, shared-memory bytes)`` of the 16-block resident backward
    at hidden size h: block c holds the rows of its ``U = ceil(H / 16)`` units
    (rounded up to a multiple of ``UNIT_GROUP``, at most
    ``BWD_SCATTER_MAX_UNITS``), ``H`` rows of ``scatter_stride(U)`` chunks,
    plus the double-buffered partial carries ``[2][16][U][R]`` f32 and two
    8-byte mbarriers. None where that exceeds ``SHARED_LIMIT`` or a block
    would own no unit (``15 U >= H``: its peers would send it nothing and it
    would wait). H = 512: ``(16, 32, 8, 229392)``."""
    u = -(-h // (BWD_SCATTER_CS * UNIT_GROUP)) * UNIT_GROUP
    rows = BWD_SCATTER_ROWS
    nbytes = h * scatter_stride(u) * 16 + 2 * BWD_SCATTER_CS * u * rows * 4 + 16
    if u > BWD_SCATTER_MAX_UNITS or (BWD_SCATTER_CS - 1) * u >= h or nbytes > SHARED_LIMIT:
        return None
    return BWD_SCATTER_CS, u, rows, nbytes


def resident_bwd_plan(b, t, g, h, clusters=H100_CLUSTERS):
    """Route A's fit where this shape takes the resident backward, None where
    the row-tiled backward runs: ``bwd_cluster_fit`` (a cluster of up to 8
    blocks) wherever one holds the weight, which b, t and g do not change
    (they only size the grid: ``CS * g`` by ``ceil(b / R)`` blocks); else
    ``scatter_fit`` (16 blocks) where the launch's ``g * ceil(b / R)``
    clusters take at most ``HOP_CLUSTER_WAVES`` at T = 1, ``MAX_CLUSTER_WAVES``
    over more steps, waves of the ``clusters`` the card runs at once
    (``co_resident_bwd_clusters``; 0: never), the forward's rule."""
    if min(b, t, g, h) < 1:
        return None
    fit = bwd_cluster_fit(h)
    if fit is not None:
        return fit
    fit = scatter_fit(h)
    waves = HOP_CLUSTER_WAVES if t == 1 else MAX_CLUSTER_WAVES
    if fit is None or g * -(-b // fit[2]) > waves * clusters:
        return None
    return fit


@functools.lru_cache(maxsize=None)
def _kernels() -> dict:
    """Build and load the library once and declare its entries' prototypes."""
    lib = _build.load_library("gru_sequence")
    kernels = {}
    for suffix in set(_WEIGHT_DTYPES.values()):
        for name, ints in ((f"gru_sequence_{suffix}", 5), (f"gru_resident_{suffix}", 6)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            kernels[name] = fn
    fn = lib.gru_resident_clusters
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    kernels["gru_resident_clusters"] = fn
    return kernels


@functools.lru_cache(maxsize=None)
def co_resident_clusters(device: torch.device, h: int, weight_dtype=None) -> int:
    """How many clusters of the resident kernel's instance at hidden size h
    (``cluster_fit``: 16 blocks) the card runs at once, from
    ``cudaOccupancyMaxActiveClusters`` at its block size and shared memory;
    asked once a device and width. 0 where the card schedules none."""
    fit = cluster_fit(h, weight_dtype)
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _kernels()["gru_resident_clusters"](int(weight_dtype == torch.bfloat16), h, fit.cs, fit.rows,
                                                  ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {err} "
                           f"(H={h}, CS={fit.cs}, rows={fit.rows})")
    return count.value


def forward_plan(b, t, g, h, weight_dtype, device: torch.device):
    """``resident_plan`` on a CUDA device: the card's own count of
    co-resident clusters where the fit is a cluster of 16."""
    fit = cluster_fit(h, weight_dtype)
    if fit is None or fit.cs <= CLUSTER_SIZES[-1]:
        return resident_plan(b, t, g, h, weight_dtype)
    return resident_plan(b, t, g, h, weight_dtype, co_resident_clusters(device, h, weight_dtype))


@functools.lru_cache(maxsize=None)
def co_resident_bwd_clusters(device: torch.device, h: int) -> int:
    """How many clusters of the 16-block resident backward at hidden size h
    (``scatter_fit``) the card runs at once, from
    ``cudaOccupancyMaxActiveClusters``; asked once a device and width. 0
    where the card schedules none."""
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _bwd_kernels()["gru_bwd_scatter_clusters"](h, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {err} (backward, H={h}, CS=16)")
    return count.value


def backward_plan(b, t, g, h, device: torch.device):
    """``resident_bwd_plan`` on a CUDA device: the card's own count of
    co-resident clusters where the only fit is the 16-block one."""
    if bwd_cluster_fit(h) is not None or scatter_fit(h) is None:
        return resident_bwd_plan(b, t, g, h)
    return resident_bwd_plan(b, t, g, h, co_resident_bwd_clusters(device, h))


def _cached_layout(w_hh: torch.Tensor, slot: str, key: tuple, make) -> torch.Tensor:
    """``make()``, kept on the weight tensor itself under ``slot`` and made
    again only when the tensor's storage (``data_ptr``), its version counter
    (bumped by every in-place write, ``load_state_dict`` included) or ``key``
    changes, so a streaming step (T = 1) does not lay the same weight out
    again on every hop. Inference tensors have no version counter and are
    not cached."""
    if w_hh.is_inference():
        return make()
    key = (w_hh.data_ptr(), w_hh._version, *key)
    cached = getattr(w_hh, slot, None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, make())
        setattr(w_hh, slot, cached)
    return cached[1]


def transposed_weight(w_hh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w_hh [G, 3H, H]`` as the row-tiled kernel reads it, ``[G, H, 3 * Hp]``
    in ``dtype``: ``[g, k, gate * Hp + j]`` is ``w_hh[g, gate * H + j, k]``,
    zero for ``j >= H`` (``Hp = padded_units(H, dtype)``; where ``Hp = H`` it
    is ``w_hh`` transposed) (cached on the weight, see ``_cached_layout``)."""
    def make():
        g, h3, h = w_hh.shape
        w = w_hh.reshape(g, 3, h, h)  # [g, gate, unit, k]
        w = torch.nn.functional.pad(w, (0, 0, 0, padded_units(h, dtype) - h))
        return w.permute(0, 3, 1, 2).reshape(g, h, -1).contiguous().to(dtype)

    return _cached_layout(w_hh, "_gru_transposed", (dtype,), make)


def packed_weight(w_hh: torch.Tensor, dtype: torch.dtype, cs: int) -> torch.Tensor:
    """``w_hh [G, 3H, H]`` as the resident kernel reads it: ``[G, CS, H, 3, U]``
    in ``dtype`` with ``U = ceil(H / CS)`` rounded up to a multiple of
    ``UNIT_GROUP``; ``[g, c, k, gate, u]`` is ``w_hh[g, gate * H + c * U + u, k]``,
    zero where ``c * U + u >= H`` (cached on the weight, see ``_cached_layout``)."""
    def make():
        g, h3, h = w_hh.shape
        u = -(-h // (cs * UNIT_GROUP)) * UNIT_GROUP
        w = w_hh.reshape(g, 3, h, h)  # [g, gate, unit, k]
        w = torch.nn.functional.pad(w, (0, 0, 0, cs * u - h))
        return w.reshape(g, 3, cs, u, h).permute(0, 2, 4, 1, 3).contiguous().to(dtype)

    return _cached_layout(w_hh, "_gru_packed", (dtype, cs), make)


def packed_weight_bwd(w_hh: torch.Tensor, cs: int) -> torch.Tensor:
    """``w_hh [G, 3H, H]`` as the resident backward reads it: ``[G, CS, 3H, U]``
    float32 with ``U = ceil(H / CS)`` rounded up to a multiple of ``UNIT_GROUP``;
    ``[g, c, j, u]`` is ``w_hh[g, j, c * U + u]``, zero where ``c * U + u >= H``
    (cached on the weight, see ``_cached_layout``)."""
    def make():
        g, h3, h = w_hh.shape
        u = -(-h // (cs * UNIT_GROUP)) * UNIT_GROUP
        w = torch.nn.functional.pad(w_hh, (0, cs * u - h))  # [g, j, unit]
        return w.reshape(g, h3, cs, u).permute(0, 2, 1, 3).contiguous().float()

    return _cached_layout(w_hh, "_gru_packed_bwd", (cs,), make)


def padded_weight_bwd(w_hh: torch.Tensor) -> torch.Tensor:
    """``w_hh [G, 3H, H]`` as the row-tiled backward streams it: ``[G, 3H,
    Hp]`` float32, each row padded with zeros to ``Hp = bwd_padded_units(H)``
    units, a lane pair's 8 a whole number of 16-byte chunks; ``w_hh`` itself
    where it already is (H a multiple of 8, 16-byte aligned), else a copy
    cached on the weight (see ``_cached_layout``)."""
    g, h3, h = w_hh.shape
    if bwd_padded_units(h) == h and w_hh.data_ptr() % 16 == 0:
        return w_hh

    def make():
        return torch.nn.functional.pad(w_hh, (0, bwd_padded_units(h) - h)).float().contiguous()

    return _cached_layout(w_hh, "_gru_padded_bwd", (), make)


def grid_rows(b: int, rows: int) -> int:
    """The blocks a launch puts along the grid's y axis for B batch rows,
    ``rows`` to a block (``row_tile`` for the row-tiled forward, the fit's
    rows for the resident forward, ``bwd_row_tile`` for the row-tiled
    backward, R of the fit for the resident backward): ``ceil(B / rows)``. Raises
    ``ValueError`` past ``GRID_Y_LIMIT``: FullSubNet folds its sub-band units
    into the batch, so a pool of 2,048 slots at 257 bins would ask for 65,792
    blocks of 8 rows."""
    blocks = -(-b // rows)
    if blocks > GRID_Y_LIMIT:
        raise ValueError(f"B={b} needs {blocks} blocks of {rows} rows along the grid's y axis, "
                         f"> {GRID_Y_LIMIT}, the launch's limit")
    return blocks


def _check_launch(x_proj, h0, w_hh, b_hh, weight_dtype, rows):
    """What both kernels ask of their tensors, and the grid of ``rows`` batch
    rows a block (``grid_rows``); returns (B, T, G, H)."""
    tensors = {"x_proj": x_proj, "h0": h0, "w_hh": w_hh, "b_hh": b_hh}
    device = x_proj.device
    if device.type != "cuda":
        raise ValueError(f"the kernels launch on CUDA tensors only, got {device}")
    for name, tensor in tensors.items():
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, x_proj on {device}")
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise RuntimeError("the forward kernels' launchers record no gradient: call gru_sequence, "
                           "whose backward is a kernel too, or launch under torch.no_grad()")
    b, t, g, h3 = x_proj.shape
    grid_rows(b, rows)
    return b, t, g, h3 // 3


@functools.lru_cache(maxsize=None)
def _bwd_kernels() -> dict:
    lib = _build.load_library("gru_bwd")
    kernels = {}
    for name, ints in (("gru_bwd_rows_f32", 5), ("gru_bwd_resident_f32", 5), ("gru_bwd_scatter_f32", 4)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        kernels[name] = fn
    fn = lib.gru_bwd_scatter_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    kernels["gru_bwd_scatter_clusters"] = fn
    return kernels


def _run(entry: str, x_proj, h0, weight, b_hh, ints: tuple):
    """Launch one entry of the library on x_proj's stream; raises if the
    launch is refused. Returns (y, h_last)."""
    b, t, g, h = ints[:4]
    device = x_proj.device
    fn = _kernels()[entry]
    y = torch.empty((b, t, g, h), dtype=torch.float32, device=device)
    h_last = torch.empty((b, g, h), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(x_proj.data_ptr(), h0.data_ptr(), weight.data_ptr(), b_hh.data_ptr(),
                 y.data_ptr(), h_last.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with CUDA error {err} "
                           f"(B, T, G, H[, CS] = {ints})")
    gru_sequence.launches += 1
    return y, h_last


def launch_streamed(x_proj, h0, w_hh, b_hh, weight_dtype=None, rows=None):
    """The row-tiled kernel on CUDA tensors, whatever the shape's plan says,
    at ``rows`` batch rows a block (default ``row_tile``'s); raises where that
    tile does not fit the hidden size."""
    _check_shapes(x_proj, h0, w_hh, b_hh, weight_dtype)
    b, t, g, h3 = x_proj.shape
    h = h3 // 3
    rows = row_tile(b, g, h, weight_dtype) if rows is None else rows
    if not rows_fit(h, rows, weight_dtype):
        raise ValueError(f"the row-tiled kernel takes no tile of {rows} rows at hidden size per group {h} "
                         f"(R in {ROW_TILES}, H <= {MAX_HIDDEN}, {ROWS_MAX_THREADS} threads, {SHARED_LIMIT} B)")
    b, t, g, h = _check_launch(x_proj, h0, w_hh, b_hh, weight_dtype, rows)
    w_t = transposed_weight(w_hh, weight_dtype or torch.float32)
    return _run(f"gru_sequence_{_WEIGHT_DTYPES[weight_dtype]}", x_proj, h0, w_t, b_hh, (b, t, g, h, rows))


def launch_resident(x_proj, h0, w_hh, b_hh, weight_dtype=None):
    """The resident kernel on CUDA tensors, whatever T and however many
    clusters; raises where no cluster holds the weight."""
    _check_shapes(x_proj, h0, w_hh, b_hh, weight_dtype)
    fit = cluster_fit(x_proj.shape[-1] // 3, weight_dtype)
    if fit is None:
        raise ValueError(f"no cluster of up to {RESIDENT_TILES[-1][0]} blocks holds the recurrent "
                         f"weight of hidden size per group {x_proj.shape[-1] // 3} in shared memory")
    b, t, g, h = _check_launch(x_proj, h0, w_hh, b_hh, weight_dtype, fit.rows)
    w_packed = packed_weight(w_hh, weight_dtype or torch.float32, fit.cs)
    out = _run(f"gru_resident_{_WEIGHT_DTYPES[weight_dtype]}", x_proj, h0, w_packed, b_hh,
               (b, t, g, h, fit.cs, fit.rows))
    gru_sequence.resident_launches += 1
    return out


def _check_bwd_launch(x_proj, hp, y, h0, dy, dh_last, w_hh, dx_proj, dhp, dh0, rows):
    """What both backward kernels ask of their tensors, and the grid of
    ``rows`` batch rows a block (``grid_rows``); returns (B, T, G, H)."""
    b, t, g, h3 = x_proj.shape
    h = h3 // 3
    shapes = {"x_proj": (b, t, g, h3), "hp": (b, t, g, h3), "y": (b, t, g, h), "h0": (b, g, h),
              "dy": (b, t, g, h), "dh_last": (b, g, h), "w_hh": (g, h3, h), "dx_proj": (b, t, g, h3),
              "dhp": (b, t, g, h3), "dh0": (b, g, h)}
    tensors = dict(zip(shapes, (x_proj, hp, y, h0, dy, dh_last, w_hh, dx_proj, dhp, dh0)))
    for name, tensor in tensors.items():
        if tensor is None and name == "dh_last":
            continue
        if tensor.device.type != "cuda" or tensor.device != x_proj.device:
            raise ValueError(f"the backward kernels launch on CUDA tensors of one device only, "
                             f"{name} is on {tensor.device}")
        if tuple(tensor.shape) != shapes[name] or tensor.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shapes[name]}, got {tensor.dtype} {tuple(tensor.shape)}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    grid_rows(b, rows)
    return b, t, g, h


def _run_bwd(entry: str, x_proj, hp, y, h0, dy, dh_last, weight, dx_proj, dhp, dh0, ints: tuple) -> None:
    """Launch one backward entry on x_proj's stream; raises if the launch is refused."""
    pointers = [None if x is None else x.data_ptr() for x in (x_proj, hp, y, h0, dy, dh_last, weight,
                                                               dx_proj, dhp, dh0)]
    stream = torch.cuda.current_stream(x_proj.device).cuda_stream
    with torch.cuda.device(x_proj.device):
        err = _bwd_kernels()[entry](*pointers, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with CUDA error {err} (B, T, G, H[, CS] = {ints})")
    gru_sequence_bwd.launches += 1


def launch_gru_bwd_streamed(x_proj, hp, y, h0, dy, dh_last, w_hh, dx_proj, dhp, dh0, rows=None) -> None:
    """Route B, the row-tiled backward kernel, on CUDA tensors, whatever the
    shape's plan says, at ``rows`` batch rows a block (default
    ``bwd_row_tile``'s), into ``dx_proj``, ``dhp`` ([B, T, G, 3H]) and
    ``dh0`` ([B, G, H]); ``hp`` is ``h_prev . w_hh^T + b_hh`` for all t and
    ``dh_last`` None means zeros. Raises where that tile does not fit the
    hidden size. Counted in ``gru_sequence_bwd.launches``."""
    b, t, g, h3 = x_proj.shape
    h = h3 // 3
    rows = bwd_row_tile(b, g, h) if rows is None else rows
    if not bwd_rows_fit(h, rows):
        raise ValueError(f"the row-tiled backward takes no tile of {rows} rows at hidden size per group {h} "
                         f"(R in {ROW_TILES}, H <= {MAX_HIDDEN}, {ROWS_MAX_THREADS} threads, {SHARED_LIMIT} B)")
    b, t, g, h = _check_bwd_launch(x_proj, hp, y, h0, dy, dh_last, w_hh, dx_proj, dhp, dh0, rows)
    _run_bwd("gru_bwd_rows_f32", x_proj, hp, y, h0, dy, dh_last, padded_weight_bwd(w_hh), dx_proj, dhp, dh0,
             (b, t, g, h, rows))


def launch_gru_bwd_resident(x_proj, hp, y, h0, dy, dh_last, w_hh, dx_proj, dhp, dh0, cs=None) -> None:
    """Route A, the resident backward kernel, on CUDA tensors, whatever the
    shape's plan says, with the arguments of ``launch_gru_bwd_streamed``;
    raises where no cluster holds the weight. ``cs`` (default: the smallest
    cluster of up to 8 that fits, else 16) forces a cluster size, so that
    every instance can be checked and timed; it raises where ``bwd_fit_at``
    has no fit. Counted in
    ``gru_sequence_bwd.launches`` and ``.resident_launches``."""
    h = x_proj.shape[-1] // 3
    if cs is None:
        fit = bwd_cluster_fit(h) or scatter_fit(h)
    else:
        fit = bwd_fit_at(h, cs) if cs in (*CLUSTER_SIZES, BWD_SCATTER_CS) else None
    if fit is None:
        raise ValueError(f"no cluster of {(*CLUSTER_SIZES, BWD_SCATTER_CS) if cs is None else cs} blocks holds the "
                         f"recurrent weight of hidden size per group {h} in shared memory with a unit in every block")
    b, t, g, h = _check_bwd_launch(x_proj, hp, y, h0, dy, dh_last, w_hh, dx_proj, dhp, dh0, fit[2])
    if fit[0] == BWD_SCATTER_CS:
        _run_bwd("gru_bwd_scatter_f32", x_proj, hp, y, h0, dy, dh_last, packed_weight(w_hh, torch.float32, fit[0]),
                 dx_proj, dhp, dh0, (b, t, g, h))
    else:
        _run_bwd("gru_bwd_resident_f32", x_proj, hp, y, h0, dy, dh_last, packed_weight_bwd(w_hh, fit[0]),
                 dx_proj, dhp, dh0, (b, t, g, h, fit[0]))
    gru_sequence_bwd.resident_launches += 1


def launch_gru_bwd(x_proj, hp, y, h0, dy, dh_last, w_hh, dx_proj, dhp, dh0) -> None:
    """The routed backward launcher: route A where ``backward_plan`` fits,
    route B elsewhere (both launch or raise), with the arguments of
    ``launch_gru_bwd_streamed``."""
    b, t, g, h3 = x_proj.shape
    resident = backward_plan(b, t, g, h3 // 3, x_proj.device) is not None
    launch = launch_gru_bwd_resident if resident else launch_gru_bwd_streamed
    launch(x_proj, hp, y, h0, dy, dh_last, w_hh, dx_proj, dhp, dh0)


def gru_sequence_bwd(dy, dh_last, x_proj, h0, w_hh, b_hh, y):
    """The recurrence's backward (f32 weights): ``(dx_proj, dh0, dw_hh,
    db_hh)``, with the signature of ``gru_sequence_backward_reference``, which
    it runs for CPU tensors. On CUDA tensors: ``hp`` for all t as one batched
    product, one launch of the backward kernel that ``backward_plan`` picks
    (``launch_gru_bwd``), then ``dw_hh`` and ``db_hh`` from its ``dhp``."""
    _check_shapes(x_proj, h0, w_hh, b_hh, None)
    if dy.shape != y.shape or y.shape != (*x_proj.shape[:3], h0.shape[-1]):
        raise ValueError(f"dy and y must be {(*x_proj.shape[:3], h0.shape[-1])}, "
                         f"got {tuple(dy.shape)} and {tuple(y.shape)}")
    if dh_last is not None and dh_last.shape != h0.shape:
        raise ValueError(f"dh_last must be {tuple(h0.shape)}, got {tuple(dh_last.shape)}")
    if _runs_plain(x_proj):
        return gru_sequence_backward_reference(dy, dh_last, x_proj, h0, w_hh, b_hh, y)
    h_prev = _h_prev(h0, y)
    hp = torch.einsum("btgh,gkh->btgk", h_prev, w_hh).add_(b_hh).contiguous()
    dx_proj, dhp, dh0 = torch.empty_like(x_proj), torch.empty_like(hp), torch.empty_like(h0)
    launch_gru_bwd(x_proj, hp, y, h0, dy, dh_last, w_hh, dx_proj, dhp, dh0)
    del hp
    return dx_proj, dh0, torch.einsum("btgk,btgh->gkh", dhp, h_prev), dhp.sum(dim=(0, 1))


gru_sequence_bwd.launches = 0
gru_sequence_bwd.resident_launches = 0


def _runs_plain(x_proj) -> bool:
    """The plain versions run for CPU tensors only; other tensors go to the
    kernels' launchers, which take CUDA tensors and raise on any other."""
    return x_proj.device.type == "cpu"


def _forward_impl(x_proj: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  weight_dtype: Optional[torch.dtype] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward on tensors with storage: the plain version on CPU tensors,
    on CUDA tensors the kernel that ``forward_plan`` picks (it launches or
    raises)."""
    if _runs_plain(x_proj):
        y, h_last = gru_sequence_reference(x_proj, h0, w_hh, b_hh, weight_dtype)
        return y.contiguous(), h_last.contiguous()
    b, t, g, h3 = x_proj.shape
    resident = forward_plan(b, t, g, h3 // 3, weight_dtype, x_proj.device) is not None
    launch = launch_resident if resident else launch_streamed
    return launch(x_proj, h0, w_hh, b_hh, weight_dtype)


# the forward as the traceable op torch.ops.cruse_tpu_torch.gru_sequence
gru_sequence_op = torch.library.custom_op("cruse_tpu_torch::gru_sequence", _forward_impl, mutates_args=(),
                                          device_types=("cpu", "cuda"))


@gru_sequence_op.register_fake
def _gru_sequence_fake(x_proj, h0, w_hh, b_hh, weight_dtype=None):
    """Shapes only, for tracing (``torch.export``) on tensors without storage."""
    b, t, g, h3 = x_proj.shape
    return x_proj.new_empty((b, t, g, h3 // 3)), x_proj.new_empty((b, g, h3 // 3))


def _forward(x_proj, h0, w_hh, b_hh, weight_dtype):
    return torch.ops.cruse_tpu_torch.gru_sequence(x_proj, h0, w_hh, b_hh, weight_dtype)


class _GruSequence(torch.autograd.Function):
    """The recurrence under a gradient: the routed forward kernel, and
    ``gru_sequence_bwd`` as its backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x_proj, h0, w_hh, b_hh):
        y, h_last = _forward(x_proj, h0, w_hh, b_hh, None)
        ctx.save_for_backward(x_proj, h0, w_hh, b_hh, y)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x_proj, h0, w_hh, b_hh, y = ctx.saved_tensors
        dy = torch.zeros_like(y) if dy is None else dy.contiguous()
        dh_last = None if dh_last is None else dh_last.contiguous()
        grads = gru_sequence_bwd(dy, dh_last, x_proj, h0, w_hh, b_hh, y)
        return tuple(grad if needed else None for grad, needed in zip(grads, ctx.needs_input_grad))


def gru_sequence(x_proj, h0, w_hh, b_hh, weight_dtype=None):
    """Grouped GRU recurrence over the whole sequence (see the module doc).

    ``weight_dtype=torch.bfloat16`` holds the recurrent weights in bf16 with
    float32 accumulation, like ``gru_sequence_pallas(weight_dtype=bf16)``;
    it has no backward. Under a gradient the call is differentiable in all
    four inputs.
    """
    _check_shapes(x_proj, h0, w_hh, b_hh, weight_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, h0, w_hh, b_hh)):
        if weight_dtype == torch.bfloat16:
            raise NotImplementedError("gru_sequence with weight_dtype=torch.bfloat16 has no backward "
                                      "(only float32 weights are ported for training)")
        return _GruSequence.apply(x_proj, h0, w_hh, b_hh)
    return _forward(x_proj, h0, w_hh, b_hh, weight_dtype)


gru_sequence.launches = 0
gru_sequence.resident_launches = 0
