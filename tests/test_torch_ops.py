"""The port's plain kernel versions against the JAX package's Pallas
kernels (run with ``interpret=True``, as tests/test_ops/ run them) and
against the lax specs the JAX package runs on the CPU.

The same numpy inputs, made from a seed, go through both sides in fp32.
Tolerances are those of tests/test_ops/: 1e-5 for LayerNorm and window
attention, 1e-4 for the 3x3 conv and RoIAlign.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.ops.conv3x3 import conv3x3_fwd, conv3x3_reference as jax_conv
from swindet_tpu.ops.layer_norm import (layer_norm as jax_ln,
                                        layer_norm_reference as jax_ln_ref)
from swindet_tpu.ops.roi_align import multilevel_roi_align as jax_roi
from swindet_tpu.ops.roi_align_pallas import multilevel_roi_align_pallas
from swindet_tpu.ops.window_attention import window_attention_reference \
    as jax_wattn_ref
from swindet_tpu.ops.window_attention_v3 import (_wattn3_fwd_impl,
                                                 window_attention_v3
                                                 as jax_wattn)
from swindet_tpu.models.backbones.swin import (relative_position_index,
                                               shifted_window_attn_mask)

from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.ops import (conv3x3, conv3x3_reference, layer_norm,
                                   layer_norm_reference,
                                   multilevel_roi_align, roi_align,
                                   window_attention_reference,
                                   window_attention_v3)
from swindet_tpu_torch.ops.conv3x3 import (BOX_SHAPES, DW_WAVES, box_shape,
                                           dw_chunk, hwio)
from swindet_tpu_torch.ops.layer_norm import (LN_BLOCKS_PER_SM, LN_PER_LANE,
                                              LN_THREADS, ln_geometry)
from swindet_tpu_torch.ops.roi_align import (_bwd_items, adaptive_grid,
                                             map_roi_levels)
from swindet_tpu_torch.ops.window_attention_v3 import (
    FWD_MAX_HEADS, SMEM_LIMIT, TC_HEAD_DIMS, TC_ROWS, bwd_geometry,
    fwd_geometry, kernel_symbol, tc_bwd_smem, tc_fwd_smem, uses_tensor_cores)
from swindet_tpu_torch.ops.window_attention_v4 import (
    DW_KC, TC_MAX_CLUSTER, dw_split_rows, fwd_geometry as v4_fwd_geometry,
    kernel_symbol as v4_kernel_symbol, tc_bwd_smem as v4_bwd_smem,
    tc_fwd_smem as v4_fwd_smem, uses_tensor_cores as v4_uses_tensor_cores)

from chip_smoke import LN_SHAPES

cap_torch_threads()

T = torch.from_numpy


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------ layer norm
@pytest.mark.parametrize('shape', [(2, 7, 9, 96), (37, 192), (5, 768)])
def test_layer_norm_matches_pallas(shape):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    s = rs.randn(shape[-1]).astype(np.float32)
    b = rs.randn(shape[-1]).astype(np.float32)
    want = jax_ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                  interpret=True)
    got = layer_norm_reference(T(x), T(s), T(b))
    _close(got, want, 1e-5)
    _close(got, jax_ln_ref(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)),
           1e-5)
    # on a CPU tensor the dispatching wrapper is the plain version
    assert torch.equal(layer_norm(T(x), T(s), T(b)), got)


# (rows, C) of Swin-T's 32 norms on an 800x1344 canvas at batch 1 and a
# training batch's 2 (chip_smoke.py LN_SHAPES), Swin-B's widths (C 4/3 of
# Swin-T's), and ragged row counts (one row, a partial tile, a partial
# last block)
LN_GEOMETRY_CASES = [(r * b, c) for b in (1, 2) for r, c in LN_SHAPES] + [
    (300, 2048), (1, 96), (37, 192), (1049, 768), (67201, 96)] + [
    (r, c * 4 // 3) for r, c in LN_SHAPES if c < 1536]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('rows,cols', LN_GEOMETRY_CASES)
def test_ln_geometry_covers_every_row_once(dtype, rows, cols):
    """The vector LayerNorm kernel's launch (csrc/layer_norm.cu, laid out
    in LnPlan): the lanes of a group hold every 16-byte chunk of a row
    once, the warps' row tiles cover every row once and nothing past the
    end, a lane holds at most 8 chunks of x (or one row where that has
    more: fp32 C 1536 and 2048), and the grid puts a block on
    every SM that has a tile and no more than LN_BLOCKS_PER_SM."""
    plan = ln_geometry(rows, cols, dtype, 132)
    vec = 16 // dtype.itemsize
    g, k = plan.group, plan.per_lane
    assert g in (1, 2, 4, 8, 16, 32) and k in LN_PER_LANE[dtype]
    assert sorted(l + j * g for l in range(g) for j in range(k)) \
        == list(range(cols // vec))
    assert plan.rows_per_thread * k <= max(8, k)
    slots = 32 // g
    tiles = -(-rows // plan.tile_rows)
    warps = LN_THREADS // 32
    assert min(tiles, 132) <= plan.blocks <= LN_BLOCKS_PER_SM * 132
    seen = np.zeros(tiles * plan.tile_rows, np.int64)
    for b in range(plan.blocks):
        for w in range(warps):
            for t in range(b + w * plan.blocks, tiles, warps * plan.blocks):
                base = t * plan.tile_rows
                for r in range(plan.rows_per_thread):
                    seen[base + r * slots:base + r * slots + slots] += 1
    assert (seen[:rows] == 1).all() and (seen[rows:] <= 1).all()


@pytest.mark.parametrize('dtype,cols', [
    (torch.bfloat16, 33), (torch.bfloat16, 36), (torch.float32, 30),
    (torch.bfloat16, 40), (torch.float32, 20), (torch.bfloat16, 3072),
    (torch.bfloat16, 4096)])
def test_ln_geometry_leaves_other_widths_to_the_first_kernel(dtype, cols):
    """Widths that are no multiple of the 16-byte vector, or whose lanes
    would hold a chunk count the kernel is not built for in that dtype (5;
    bf16 12 and 16, which no Swin config reaches), keep the first
    kernel."""
    assert ln_geometry(1000, cols, dtype, 132) is None


# ------------------------------------------------------ window attention
def _attn_inputs(b_, c, nh, shift, seed=0):
    rs = np.random.RandomState(seed)
    n = 49
    qkv = rs.randn(b_, n, 3 * c).astype(np.float32)
    table = (rs.randn(169, nh) * 0.5).astype(np.float32)
    bias = table[relative_position_index(7, 7).reshape(-1)] \
        .reshape(n, n, nh).transpose(2, 0, 1).copy()
    mask = shifted_window_attn_mask(14, 21, 7, 3) if shift else None
    return qkv, bias, mask


@pytest.mark.parametrize('shift', [False, True])
@pytest.mark.parametrize('c,nh', [(96, 3), (64, 2)])
def test_window_attention_matches_pallas(shift, c, nh):
    # 2 images x (2 x 3) windows of a 14 x 21 map
    qkv, bias, mask = _attn_inputs(12, c, nh, shift)
    want = jax_wattn(jnp.asarray(qkv), jnp.asarray(bias),
                     None if mask is None else jnp.asarray(mask), nh,
                     interpret=True)
    got = window_attention_reference(
        T(qkv), T(bias), None if mask is None else T(mask), nh)
    _close(got, want, 1e-5)
    spec = jax_wattn_ref(jnp.asarray(qkv), jnp.asarray(bias),
                         None if mask is None else jnp.asarray(mask), nh)
    _close(got, spec, 1e-5)
    assert torch.equal(window_attention_v3(
        T(qkv), T(bias), None if mask is None else T(mask), nh), got)


@pytest.mark.parametrize('shift', [False, True])
def test_bf16_window_attention_matches_pallas(shift):
    """bf16 qkv: the plain version rounds P to bf16 before P v and the
    output once, as the Pallas kernel does (and the tensor-core kernel
    after it). Both round the output from fp32 sums taken in different
    orders, and a probability on a rounding boundary may round the other
    way: held at the card's bf16 tolerance, 2e-2 (one bf16 unit of an
    output, 2^-8 relative, and a flipped probability's 2^-9 times |v|)."""
    qkv, bias, mask = _attn_inputs(12, 96, 3, shift, seed=2)
    qb = jnp.asarray(qkv, jnp.bfloat16)
    jmask = jnp.asarray(mask if shift else np.zeros((1, 49, 49), np.float32))
    want = _wattn3_fwd_impl(qb, jnp.asarray(bias), jmask, 3, True)
    tq = T(np.asarray(qb, np.float32)).bfloat16()
    got = window_attention_reference(tq, T(bias),
                                     None if mask is None else T(mask), 3)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 2e-2)


# window counts of one request at stages 1-4 of an 800x1344 canvas, and
# heads: the forward runs these, the backward twice the windows
MAIN_ATTN_STAGES = [(1392, 3), (360, 6), (96, 12), (24, 24)]


@pytest.mark.parametrize('windows,heads', MAIN_ATTN_STAGES)
def test_tc_attention_grids_fill_the_card(windows, heads):
    """Rows 2 and 7's tensor-core grids at the main path's shapes: every
    (window, head) pair is covered once, a block's shared memory fits the
    card, and each grid makes 2 (forward) or 4 (backward) blocks for each
    of 132 SMs."""
    group = fwd_geometry(windows, heads, 132)
    assert 1 <= group <= FWD_MAX_HEADS and heads % group == 0
    pairs = sorted((w, g * group + h) for w in range(windows)
                   for g in range(heads // group) for h in range(group))
    assert pairs == [(w, h) for w in range(windows) for h in range(heads)]
    assert windows * (heads // group) >= 2 * 132
    assert tc_fwd_smem(32, group, 49, True) <= SMEM_LIMIT

    b_ = 2 * windows
    per = bwd_geometry(b_, heads, 132)
    blocks = -(-b_ // per)
    covered = [w for blk in range(blocks)
               for w in range(blk * per, min(blk * per + per, b_))]
    assert covered == list(range(b_))
    assert blocks * heads >= 4 * 132


@pytest.mark.parametrize('hd', TC_HEAD_DIMS)
def test_tc_attention_smem_fits_every_shape(hd):
    """The largest blocks the wrappers can ask for fit in an H100 SM's
    227 KB: three heads of 64 tokens with a mask, and the backward's."""
    assert tc_fwd_smem(hd, FWD_MAX_HEADS, TC_ROWS, True) <= SMEM_LIMIT
    assert tc_bwd_smem(hd) <= SMEM_LIMIT
    # few windows: one head a forward block, one window a backward block
    assert fwd_geometry(2, 6, 132) == 1 and bwd_geometry(3, 2, 132) == 1


@pytest.mark.parametrize('dtype,hd,want', [
    (torch.bfloat16, 32, True), (torch.bfloat16, 16, True),
    (torch.bfloat16, 48, True), (torch.bfloat16, 64, True),
    (torch.bfloat16, 8, False), (torch.bfloat16, 24, False),
    (torch.float32, 32, False), (torch.float32, 64, False)])
def test_tc_attention_routing(dtype, hd, want):
    """bf16 with hd a multiple of 16 up to 64 takes the tensor-core
    kernels; fp32 and any other head width the SIMT kernels."""
    assert uses_tensor_cores(dtype, hd) is want


# window counts of a training batch of 2 at stages 1-4 of an 800x1344
# canvas, and heads: the training forward (row 6) and the backward run these
TRAIN_ATTN_STAGES = [(2 * w, h) for w, h in MAIN_ATTN_STAGES]


@pytest.mark.parametrize('windows,heads', TRAIN_ATTN_STAGES)
def test_tc_fwd_p_grid_and_smem_at_the_training_shapes(windows, heads):
    """Row 6's tensor-core forward at the training batch's shapes: its
    grid fills 2 blocks for each of 132 SMs, and with the P staging a
    block takes no more shared memory than row 2's, so two blocks (each
    with the 1 KB the card reserves a block) still fit an SM's 228 KB."""
    group = fwd_geometry(windows, heads, 132)
    assert heads % group == 0
    assert windows * (heads // group) >= 2 * 132
    for masked in (False, True):
        smem = tc_fwd_smem(32, group, 49, masked, save_p=True)
        assert smem == tc_fwd_smem(32, group, 49, masked)
        assert 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize('windows,heads', MAIN_ATTN_STAGES)
def test_swin_tc_block_smem_at_the_main_stages(windows, heads):
    """Row 15's tensor-core block at the windows of one 800x1344 map:
    no mask tile, the window's 49 region ids (a byte each) in its place,
    so two blocks (each with the 1 KB the card reserves a block) fit an
    SM's 228 KB."""
    group = fwd_geometry(windows, heads, 132)
    smem = tc_fwd_smem(32, group, 49, False, regions=True)
    assert smem == tc_fwd_smem(32, group, 49, False) + 49
    assert smem < tc_fwd_smem(32, group, 49, True)
    assert 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize('hd', TC_HEAD_DIMS)
@pytest.mark.parametrize('heads', [1, 2, 3])
def test_tc_fwd_p_smem_fits_every_shape(hd, heads):
    """With the P staging (16 rows of N fp32 values for each of a head's
    four warps, over the k tiles, the bias and the mask) a block fits
    232,448 B at every head width, head group and N up to 64, and covers
    both the forward's tiles and tables and the staging."""
    for n in range(1, TC_ROWS + 1):
        for masked in (False, True):
            smem = tc_fwd_smem(hd, heads, n, masked, save_p=True)
            assert smem <= SMEM_LIMIT
            assert smem >= tc_fwd_smem(hd, heads, n, masked)
            tiles = 2 * 3 * heads * TC_ROWS * (hd + 8)
            assert smem >= tiles // 3 * 2 + 4 * heads * 4 * 16 * n


@pytest.mark.parametrize('kind', ['fwd', 'fwd_p', 'bwd', 'heads', 'swin'])
@pytest.mark.parametrize('dtype,hd,want', [
    (torch.bfloat16, 32, True), (torch.bfloat16, 16, True),
    (torch.bfloat16, 64, True), (torch.bfloat16, 24, False),
    (torch.float32, 32, False), (torch.float32, 64, False)])
def test_tc_attention_kernel_symbols(kind, dtype, hd, want):
    """Each of the five wrappers (rows 2, 6, 7, 14 and 15) launches its
    tensor-core entry point exactly where uses_tensor_cores holds, and its
    SIMT one otherwise."""
    name = {'fwd': 'swindet_window_attention', 'fwd_p':
            'swindet_window_attention_fwd_p',
            'bwd': 'swindet_window_attention_bwd',
            'heads': 'swindet_window_attention_heads',
            'swin': 'swindet_swin_attention'}[kind]
    assert kernel_symbol(kind, dtype, hd) == name + ('_tc' if want else '')


# (windows of one request, C, heads) at stages 1-4 of Swin-T and Swin-B;
# the v4 forward runs these windows, its backward twice as many
V4_STAGES = [(1392, 96, 3), (360, 192, 6), (96, 384, 12), (24, 768, 24),
             (1392, 128, 4), (360, 256, 8), (96, 512, 16), (24, 1024, 32)]


@pytest.mark.parametrize('windows,c,heads', V4_STAGES)
def test_v4_tc_grids_and_smem_at_the_stage_shapes(windows, c, heads):
    """Rows 12 and 13's tensor-core kernels take every Swin-T and Swin-B
    stage in bf16 with a block in 227 KB; the forward's cluster divides
    the heads, has at most 8 blocks and fills 2 blocks for each of 132
    SMs where 8 can; the backward covers every window of a training
    batch once; each weight gradient's split is a whole number of
    32-row chunks and gives at least 2 blocks an SM where the rows
    allow."""
    hd = c // heads
    assert v4_uses_tensor_cores(torch.bfloat16, 49, c, heads)
    assert v4_fwd_smem(49, c, hd) <= SMEM_LIMIT
    assert v4_bwd_smem(49, hd) <= SMEM_LIMIT
    for b_ in (windows, 2 * windows):
        cl = v4_fwd_geometry(b_, heads, 132)
        assert heads % cl == 0 and 1 <= cl <= TC_MAX_CLUSTER
        assert b_ * cl >= 2 * 132 or cl == max(
            g for g in range(1, TC_MAX_CLUSTER + 1) if heads % g == 0)
    b_ = 2 * windows
    per = bwd_geometry(b_, heads, 132)
    covered = [w for blk in range(-(-b_ // per))
               for w in range(blk * per, min(blk * per + per, b_))]
    assert covered == list(range(b_))
    rows = b_ * 49
    for m in (3 * c, c):
        split = dw_split_rows(rows, m, c, 132)
        splits = -(-rows // split)
        assert split % DW_KC == 0 and (splits - 1) * split < rows
        tiles = -(-m // 64) * -(-c // 64)
        assert tiles * splits >= 2 * 132 or split <= 64 + DW_KC


@pytest.mark.parametrize('windows,heads,cluster', [
    (1392, 3, 1), (360, 6, 1), (96, 12, 3), (24, 24, 8), (2784, 3, 1),
    (720, 6, 1), (192, 12, 2), (48, 24, 6), (24, 32, 8), (2, 6, 6)])
def test_v4_forward_cluster(windows, heads, cluster):
    """The smallest cluster that fills the card two blocks an SM: one
    block a window at stages 1-2, the window split over 3 (request) or 2
    (training) blocks at stage 3 and over 8 or 6 at stage 4; with few
    windows the largest divisor of the heads up to 8. At Swin-T's widths
    a block of such a cluster fits three an SM (with the 1 KB the card
    reserves a block)."""
    assert v4_fwd_geometry(windows, heads, 132) == cluster
    assert 3 * (v4_fwd_smem(49, 32 * heads, 32, cluster) + 1024) \
        <= 228 * 1024


@pytest.mark.parametrize('dtype,n,c,heads,want', [
    (torch.bfloat16, 49, 96, 3, True), (torch.bfloat16, 16, 96, 3, True),
    (torch.bfloat16, 16, 48, 3, True), (torch.bfloat16, 64, 1024, 16, True),
    (torch.bfloat16, 49, 1024, 32, True), (torch.bfloat16, 49, 96, 12, False),
    (torch.bfloat16, 49, 96, 4, False), (torch.bfloat16, 81, 96, 3, False),
    (torch.bfloat16, 49, 1536, 24, False), (torch.bfloat16, 49, 256, 2, False),
    (torch.float32, 49, 96, 3, False), (torch.float32, 49, 768, 24, False)])
def test_v4_tc_routing(dtype, n, c, heads, want):
    """bf16 with N <= 64, hd in {16, 32, 48, 64} and both blocks within
    227 KB (every Swin stage, a 4x4 window, Swin-B's C 1,024) takes the
    tensor-core kernels; fp32, other head widths, N over 64 and C 1,536
    with hd 64 (a forward block of 280 KB) the SIMT ones."""
    assert v4_uses_tensor_cores(dtype, n, c, heads) is want
    for kind in ('fwd', 'bwd'):
        name = 'swindet_window_attention_v4' + ('_bwd' if kind == 'bwd'
                                                else '')
        assert v4_kernel_symbol(kind, dtype, n, c, heads) == \
            name + ('_tc' if want else '')


def test_v4_smem_matches_the_kernels_layout():
    """tc_fwd_smem and tc_bwd_smem (mirrored in csrc tc_fwd_smem and
    tc_bwd_smem) at Swin-T stages 1 and 4, Swin-B stage 4 and a 4x4
    window, counted by hand: the block's columns of the bf16 attention
    output (64 x (C / cluster + 8)), q, k, v tiles (64 x 40 each), the
    fp32 bias plus mask (49 x 49, 2,404 floats rounded to 16 bytes) and
    two pipeline stages of a 64-row and a 96-row chunk (40 values a
    row); the backward's q, k, v and d tiles, P and dS
    (64 x 72 each), the same table (at a 4x4 window the four warps' 16 x
    40 staging tiles, which take its room) and pipeline. The largest
    shape the kernels take, Swin-B's C 1,024 at hd 64 and N 64, fits."""
    pipe = 2 * 2 * (64 + 96) * 40
    add = 4 * 2404
    assert v4_fwd_smem(49, 96, 32) == 2 * (64 * 104 + 3 * 64 * 40) + add \
        + pipe
    assert v4_fwd_smem(49, 1024, 32) == 2 * (64 * 1032 + 3 * 64 * 40) \
        + add + pipe
    # a block of stage 4's cluster of 8 holds its 96 columns only
    assert v4_fwd_smem(49, 768, 32, 8) == v4_fwd_smem(49, 96, 32)
    assert v4_bwd_smem(49, 32) == 2 * (4 * 64 * 40 + 2 * 64 * 72) + add \
        + pipe
    assert v4_bwd_smem(16, 32) == 2 * (4 * 64 * 40 + 2 * 64 * 72) \
        + 4 * 32 * 40 + pipe
    assert v4_fwd_smem(64, 1024, 64) <= SMEM_LIMIT
    assert v4_bwd_smem(64, 64) <= SMEM_LIMIT


# ------------------------------------------------------------- conv 3x3
@pytest.mark.parametrize('relu', [False, True])
@pytest.mark.parametrize('hw', [(8, 12), (14, 14), (5, 7)])
def test_conv3x3_matches_pallas(relu, hw):
    rs = np.random.RandomState(1)
    h, w_ = hw
    x = rs.randn(2, h, w_, 128).astype(np.float32)
    w = (rs.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
    b = rs.randn(128).astype(np.float32)
    want = conv3x3_fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       relu, interpret=True)
    got = conv3x3_reference(T(x), T(w), T(b), relu)
    _close(got, want, 1e-4)
    _close(got, jax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         relu), 1e-4)
    assert torch.equal(conv3x3(T(x), T(w), T(b), relu), got)


def test_hwio_layout():
    w = torch.randn(8, 4, 3, 3)
    got = hwio(w)
    assert got.shape == (3, 3, 4, 8) and got.is_contiguous()
    assert torch.equal(got[1, 2, 3, 5], w[5, 3, 1, 2])


@pytest.mark.parametrize('hw,box', [((200, 336), (4, 16)),
                                    ((100, 168), (8, 8)),
                                    ((50, 84), (2, 32)), ((25, 42), (4, 16)),
                                    ((13, 21), (8, 8)), ((14, 14), (4, 16)),
                                    ((1, 70), (1, 64))])
def test_bf16_conv_box_shape(hw, box):
    """The tensor-core conv's 64-pixel box for each map of the main path
    (and a one-row map): the one that pads the map least."""
    h, w = hw
    got = box_shape(h, w)
    assert got == box and got[0] * got[1] == 64
    pad = lambda s: -(-h // s[0]) * s[0] * (-(-w // s[1]) * s[1])  # noqa
    assert all(pad(got) <= pad(s) for s in BOX_SHAPES)


@pytest.mark.parametrize('boxes,tiles', [(2100, 18), (1024, 18), (6, 18),
                                         (1, 9), (5000, 36)])
def test_bf16_dw_chunks_fill_the_card(boxes, tiles):
    """The filter gradient's split K: every block gets at least one box,
    the chunks cover every box once, and the blocks make at most DW_WAVES
    waves over 132 SMs (exactly 3 at 256 -> 256, 18 tiles)."""
    chunk = dw_chunk(boxes, tiles, 132)
    splits = -(-boxes // chunk)
    assert 1 <= chunk <= boxes and (splits - 1) * chunk < boxes
    assert tiles * splits <= max(tiles, DW_WAVES * 132)
    if boxes >= 22 and tiles == 18:
        assert tiles * splits == 3 * 132


# ------------------------------------------------------------- roi align
SHAPES = [(50, 84), (25, 42), (13, 21), (7, 11)]
STRIDES = (4, 8, 16, 32)


@pytest.fixture(scope='module')
def feats():
    rs = np.random.RandomState(2)
    return [rs.randn(2, h, w, 32).astype(np.float32) for h, w in SHAPES]


def _rois(rs, n, img_w=336, img_h=200):
    sizes = rs.uniform(8, 300, n)
    cx = rs.uniform(0, img_w, n)
    cy = rs.uniform(0, img_h, n)
    b = rs.randint(0, 2, n)
    rois = np.stack([b, cx - sizes / 2, cy - sizes / 2,
                     cx + sizes / 2, cy + sizes / 2], -1)
    rois[:, 1:] = np.clip(rois[:, 1:], 0, None)
    return rois.astype(np.float32)


def _check_roi(feats, rois, out_size, valid=None):
    jf = [jnp.asarray(f) for f in feats]
    jv = None if valid is None else jnp.asarray(valid)
    want = multilevel_roi_align_pallas(jf, jnp.asarray(rois), STRIDES,
                                       out_size, roi_valid=jv,
                                       interpret=True)
    tv = None if valid is None else T(valid)
    got = multilevel_roi_align([T(f) for f in feats], T(rois), STRIDES,
                               out_size, roi_valid=tv)
    _close(got, want, 1e-4)
    _close(got, jax_roi(jf, jnp.asarray(rois), STRIDES, out_size,
                        roi_valid=jv), 1e-4)
    assert torch.equal(roi_align([T(f) for f in feats], T(rois), STRIDES,
                                 out_size, roi_valid=tv), got)
    return got


@pytest.mark.parametrize('out_size', [7, 14])
def test_roi_align_matches_pallas(feats, out_size):
    _check_roi(feats, _rois(np.random.RandomState(3), 20), out_size)


def test_roi_align_border_invalid_oversize(feats):
    rois = np.array([
        [0, 0, 0, 30, 30],           # top-left corner
        [0, 300, 180, 360, 230],     # past the bottom-right border
        [1, 320, 10, 335, 190],      # tall right-edge sliver
        [1, 0, 90, 336, 96],         # full-width sliver (wide strip pass)
        [0, 100, 0, 118, 470],       # oversize: no strip pass fits it
        [0, 2, 3, 40, 300],          # taller than the canvas
        [0, 0, 0, 0, 0],             # padding roi
    ], np.float32)
    valid = np.array([True, True, True, True, True, True, False])
    got = _check_roi(feats, rois, 7, valid)
    assert got[6].abs().max() == 0


def test_roi_levels_and_adaptive_grid():
    rois = torch.tensor([[0, 0, 0, 10, 10], [0, 0, 0, 112, 112],
                         [0, 0, 0, 224, 224], [0, 0, 0, 900, 900]],
                        dtype=torch.float32)
    assert map_roi_levels(rois, 4).tolist() == [0, 1, 2, 3]
    steps, weights, g = adaptive_grid(torch.tensor([3.0, 20.0, 200.0]),
                                      7, 8)
    assert g.tolist() == [1.0, 3.0, 8.0]
    assert torch.allclose(weights.sum(1), torch.ones(3))
    assert torch.allclose(steps[1, :3], torch.tensor([0.5, 1.5, 2.5]) / 3)


# ----------------------------------------- roi align: the separable form
# The CUDA kernels (csrc/roi_align.cu) compute out = A_y . F . A_x^T per
# roi and its transpose A_y^T . g . A_x. separable_matrices builds A_y and
# A_x as they do, in fp32 with the plain version's separately rounded
# sample positions; the products are taken here in fp64, so these tests
# hold the math, and the kernels' sums are held to the plain versions on
# the card.
def separable_matrices(rois, shapes, strides, out_size, sampling_ratio=0,
                       finest_scale=56, g_max=8):
    """Per roi: its level and A_y (out, H_l), A_x (out, W_l), fp32."""
    f32 = np.float32
    lvl = map_roi_levels(torch.from_numpy(rois), len(shapes),
                         finest_scale).numpy()
    result = []
    for roi, l in zip(rois, lvl):
        scale = f32(1.0 / strides[l])
        mats = []
        for lo, hi, size in ((roi[2], roi[4], shapes[l][0]),
                             (roi[1], roi[3], shapes[l][1])):
            with np.errstate(invalid='ignore'):
                start = f32(f32(lo) * scale) - f32(0.5)
                width = f32(f32(f32(hi) * scale) - f32(0.5)) - start
                bin_ = f32(width / f32(out_size))
                g = sampling_ratio or int(min(max(
                    np.nan_to_num(np.ceil(bin_), nan=1.0), 1), g_max))
                k = (np.arange(g, dtype=f32) + f32(0.5)) / f32(g)
                pos = start + (np.arange(out_size, dtype=f32)[:, None]
                               + k[None]) * bin_                # (out, g)
                ok = (pos >= -1) & (pos <= size)
            pos = np.minimum(np.maximum(np.where(ok, pos, 0), 0),
                             f32(size - 1))
            c0 = np.floor(pos).astype(np.int64)
            c1 = np.minimum(c0 + 1, size - 1)
            frac = pos - np.floor(pos)
            inv_g = f32(1) / f32(g)
            a = np.zeros((out_size, size), f32)
            rows = np.arange(out_size)
            for j in range(g):     # sample order, as the kernels add
                m = ok[:, j]
                np.add.at(a, (rows[m], c0[m, j]), (1 - frac[m, j]) * inv_g)
                np.add.at(a, (rows[m], c1[m, j]), frac[m, j] * inv_g)
            mats.append(a)
        result.append((int(l), *mats))
    return result


def separable_roi_align(feats, rois, strides, out_size, sampling_ratio=0,
                        roi_valid=None):
    """A_y . F . A_x^T per roi; zeros for invalid rois and for rois whose
    batch index lies outside the batch, as the kernel gives."""
    shapes = [f.shape[1:3] for f in feats]
    out = np.zeros((len(rois), out_size, out_size, feats[0].shape[-1]))
    for r, (l, ay, ax) in enumerate(separable_matrices(
            rois, shapes, strides, out_size, sampling_ratio)):
        b = int(rois[r, 0])
        if (roi_valid is None or roi_valid[r]) and 0 <= b < len(feats[l]):
            out[r] = np.einsum('py,yxc,qx->pqc', ay.astype(np.float64),
                               feats[l][b], ax.astype(np.float64))
    return out


# the first five are border and oversize rois the strip passes take, then
# an invalid one; then a reversed roi (x2 < x1, y2 < y1), a full-width
# sliver and a roi past every border, on which the JAX package's strip
# passes depart from the contract (the reversed roi at 7 x 7 and 14 x 14
# by up to 4.8, the other two at 14 x 14, ROADMAP section 3 item 3), and a
# roi whose batch index is out of range
SEP_ROIS = np.array([
    [0, 0, 0, 30, 30], [0, 300, 180, 360, 230], [1, 320, 10, 335, 190],
    [0, 100, 0, 118, 470], [0, 2, 3, 40, 300], [0, 0, 0, 0, 0],
    [1, 60, 50, 20, 10], [1, 0, 90, 336, 96], [1, -100, -60, 480, 420],
    [5, 10, 10, 40, 40]], np.float32)
SEP_VALID = np.array([True] * 5 + [False, True, True, True, True])
SEP_STRIP_EXACT = slice(0, 6)


@pytest.mark.parametrize('out_size,ratio', [(7, 0), (14, 0), (7, 2)])
def test_roi_align_separable_form_matches_the_plain_version(
        feats, out_size, ratio):
    rois = np.concatenate([SEP_ROIS[:9], _rois(np.random.RandomState(6),
                                               12)])
    valid = np.concatenate([SEP_VALID[:9], np.ones(12, bool)])
    got = separable_roi_align(feats, rois, STRIDES, out_size, ratio, valid)
    want = multilevel_roi_align([T(f) for f in feats], T(rois), STRIDES,
                                out_size, ratio, roi_valid=T(valid))
    _close(got, want, 1e-4)


@pytest.mark.parametrize('out_size', [7, 14])
def test_roi_align_separable_form_matches_pallas_and_the_contract(
        feats, out_size):
    """The Pallas kernel in interpret mode on the rois where its strip
    passes keep the contract; the JAX package's exact RoIAlign on every
    roi, the reversed one, the sliver and the roi past every border among
    them, at 1e-4 as everywhere; zeros for the roi whose batch index is
    out of range."""
    got = separable_roi_align(feats, SEP_ROIS, STRIDES, out_size,
                              roi_valid=SEP_VALID)
    jf = [jnp.asarray(f) for f in feats]
    exact = SEP_STRIP_EXACT
    want = multilevel_roi_align_pallas(
        jf, jnp.asarray(SEP_ROIS[exact]), STRIDES, out_size,
        roi_valid=jnp.asarray(SEP_VALID[exact]), interpret=True)
    _close(got[exact], want, 1e-4)
    contract = jax_roi(jf, jnp.asarray(SEP_ROIS[:9]), STRIDES, out_size,
                       roi_valid=jnp.asarray(SEP_VALID[:9]))
    _close(got[:9], contract, 1e-4)
    assert np.abs(got[5]).max() == 0 and np.abs(got[9]).max() == 0


def test_roi_align_bwd_scratch_has_a_byte_per_item():
    """The backward's scratch: a byte per item, the 16 x 16-cell tiles of
    every level and image, partial ones at the edges included, times the
    64-channel chunks, a partial one included (csrc/roi_align.cu)."""
    fpn = [(2, 200, 336, 256), (2, 100, 168, 256), (2, 50, 84, 256),
           (2, 25, 42, 256)]
    assert _bwd_items(fpn) == 2 * (13 * 21 + 7 * 11 + 4 * 6 + 2 * 3) * 4
    assert _bwd_items([(1, 17, 33, 72), (1, 9, 17, 72)]) == (6 + 2) * 2


def test_roi_align_separable_matrices_rows():
    """A row of A holds at most 2 g nonzeros, which sum to the share of
    the bin's samples inside the map."""
    rois = np.array([[0, 10, 20, 150, 60], [0, -40, -40, 20, 20],
                     [0, 0, 90, 336, 96]], np.float32)
    shapes = [(50, 84), (25, 42), (13, 21), (7, 11)]
    for (l, ay, ax), roi in zip(separable_matrices(rois, shapes, STRIDES,
                                                   7), rois):
        for a in (ay, ax):
            assert ((a != 0).sum(1) <= 2 * 8).all()
            assert (a >= 0).all() and (a.sum(1) <= 1 + 1e-6).all()
    # the first roi lies inside the map: each row sums to one
    _, ay, ax = separable_matrices(rois[:1], shapes, STRIDES, 7)[0]
    np.testing.assert_allclose(ay.sum(1), 1, atol=1e-6)
    np.testing.assert_allclose(ax.sum(1), 1, atol=1e-6)
