"""The hand-written CUDA kernels K1-K9 of jwave_tpu_torch.

Tests marked ``cuda`` build and launch the kernels and hold them against
their plain torch versions (run in float64 on the same input); they need a
CUDA card and skip without one. Run them on the card with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts=''

The other tests check, on any machine, what surrounds the kernels: the
whole-row plan and the level grouping of K1/K2, K3's tile plan and its tiling run in plain torch
(K7's are in tests/test_torch_ipyramid.py, K8's and K9's in
tests/test_torch_wpt_kernel.py),
the row blocking of K4/K5, K6's shared bytes, the build's error on a
missing compiler, that CPU tensors take the plain versions, and (where JAX
is installed) the plain versions of K5/K6 and K6's gradient against the
Pallas kernels they replace, run in interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_build, cuda_modwt, cuda_pyramid, cuda_reassign, \
    cuda_wpt  # noqa: E402
from jwave_tpu_torch.ops.butterfly import synthesis_levels  # noqa: E402
from jwave_tpu_torch.transforms import ndim  # noqa: E402
from jwave_tpu_torch.utils import profiling  # noqa: E402
from jwave_tpu_torch.transforms.modwt import _modwt_base_filters  # noqa: E402

F32_BOUND = 1e-5   # f32 storage, f32 accumulation in another order than the plain version
BF16_BOUND = 1e-2  # bf16 storage rounds every stored value to 2^-9 relative


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel_err(got, ref):
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


# K1/K2 on whole rows (cuda_modwt.rows_per_block): every level in one launch
_WHOLE_ROWS = [
    ((1024, 64), "db4", 5, torch.float32),           # 16 rows a block
    ((512, 90), "db4", 5, torch.float32),            # 11 rows a block, N % 4 != 0
    ((256, 181), "db4", 5, torch.float32),           # odd N: one cycle a level
    ((24, 1448), "db4", 5, torch.float32),           # one row a block
    ((16, 2048), "db4", 5, torch.float32),           # the longest whole row
    ((1024, 64), "db4", 5, torch.bfloat16),
    ((512, 90), "db4", 5, torch.bfloat16),
    ((256, 181), "db4", 5, torch.bfloat16),
    ((24, 1448), "db4", 5, torch.bfloat16),
    ((16, 2048), "db4", 5, torch.bfloat16),
    ((1000, 90), "db4", 5, torch.float32),           # a ragged last block of 10 rows
    ((64, 64), "Haar", 13, torch.float32),           # gaps up to 64 N: one output a thread
    ((100, 100), "Discrete Meyer", 6, torch.float32),  # m = 62, gap 32 > N / 4
    ((33, 1001), "sym8", 7, torch.bfloat16),         # one row a block, 33 blocks
]


def _k1_k2_launches(shape, m, level, dtype):
    """K1's and K2's launches for one call: one on whole rows, else one a
    level group; and whether the rows run whole."""
    whole = cuda_modwt.rows_per_block(shape[1], level, torch.finfo(dtype).bits // 8) > 0
    if whole:
        return 1, 1, whole
    return (len(cuda_modwt.level_groups(shape[1], m, level)),
            len(cuda_modwt.inverse_level_groups(shape[1], m, level)), whole)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level,dtype", [
    ((64, 65536), "db4", 5, torch.float32),
    ((8, 777), "db4", 9, torch.float32),
    ((4, 256), "Discrete Meyer", 5, torch.float32),
    ((4, 8192), "Haar", 13, torch.float32),
    ((2, 20000), "Discrete Meyer", 10, torch.float32),
    ((64, 65536), "db4", 5, torch.bfloat16),
    ((3, 5000), "db4", 6, torch.float32),            # a ragged last tile whose segment wraps
    ((2, 100), "Discrete Meyer", 6, torch.float32),  # whole rows: (M-1) gap = 19.5 N
    ((2, 100), "Discrete Meyer", 6, torch.bfloat16),
    ((3, 4099), "db4", 4, torch.float32),            # unaligned N: plain-loaded piece edges
    ((8, 777), "db4", 9, torch.bfloat16),
    ((5, 1001), "sym8", 7, torch.bfloat16),
    ((4, 8192), "Haar", 13, torch.bfloat16),         # five K2 groups over f32 scratch
    ((2, 65536), "db4", 13, torch.float32),          # K2 groups staged and unstaged
    ((2, 3000), "Discrete Meyer", 6, torch.float32),  # tiles: halo 3843 > N wraps
    *_WHOLE_ROWS,
])
def test_k1_k2_match_plain(cuda, shape, wavelet, level, dtype):
    g0, h0 = _modwt_base_filters(wavelet)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(shape), dtype=dtype,
                        device=cuda)
    bound = F32_BOUND if dtype == torch.float32 else BF16_BOUND
    before = jt.ops.launch_counts()
    whole_before = profiling.counts()
    c = cuda_modwt.modwt_cascade(x, g0, h0, level)
    back = cuda_modwt.imodwt_cascade(c, g0, h0)
    torch.cuda.synchronize()
    assert c.dtype == dtype and back.dtype == dtype
    assert _rel_err(c, cuda_modwt.modwt_cascade_torch(x.double(), g0, h0, level)) <= bound
    assert _rel_err(back, cuda_modwt.imodwt_cascade_torch(c.double(), g0, h0)) <= bound
    k1, k2, whole = _k1_k2_launches(shape, len(g0), level, dtype)
    assert jt.ops.launch_counts()["K1"] == before["K1"] + k1
    assert jt.ops.launch_counts()["K2"] == before["K2"] + k2
    for k in ("K1", "K2"):
        key = f"{k}.whole_row_launches"
        assert profiling.counts()[key] == whole_before[key] + whole


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level,dtype", [
    ((64, 65536), "db4", 5, torch.float32),
    ((3, 4099), "db4", 4, torch.float32),            # N % 4 != 0: rows off 16-byte alignment
    ((8, 777), "db4", 9, torch.bfloat16),            # whole rows, N % 8 != 0 in bf16
    ((2, 100), "Discrete Meyer", 6, torch.float32),  # whole rows: taps reach 19.5 N away
    ((3, 5000), "db4", 6, torch.float32),            # a ragged last tile
    ((4, 8192), "Haar", 13, torch.float32),          # three groups over f32 scratch
    ((4, 8192), "Haar", 13, torch.bfloat16),         # the same, bf16 rows from f32 scratch
    ((2, 65536), "db4", 13, torch.float32),          # staged groups, then unstaged levels
    ((2, 3000), "Discrete Meyer", 6, torch.float32),  # tiles: a halo longer than N
    *_WHOLE_ROWS,
])
def test_k1_matches_plain(cuda, shape, wavelet, level, dtype):
    """K1 alone, one launch on whole rows or one per level group, against
    its plain version in float64. The output's memory held NaN before (the
    caching allocator hands the freed block to the wrapper), so an element
    left unstored shows."""
    g0, h0 = _modwt_base_filters(wavelet)
    x = torch.as_tensor(np.random.default_rng(10).standard_normal(shape), dtype=dtype,
                        device=cuda)
    before = jt.ops.launch_counts()["K1"]
    torch.full((shape[0], level + 1, shape[1]), float("nan"), dtype=dtype, device=cuda)
    c = cuda_modwt.modwt_cascade(x, g0, h0, level)
    torch.cuda.synchronize()
    assert c.dtype == dtype and bool(torch.isfinite(c).all())
    bound = F32_BOUND if dtype == torch.float32 else BF16_BOUND
    assert _rel_err(c, cuda_modwt.modwt_cascade_torch(x.double(), g0, h0, level)) <= bound
    k1, _, _ = _k1_k2_launches(shape, len(g0), level, dtype)
    assert jt.ops.launch_counts()["K1"] == before + k1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level", [
    ((64, 65536), "db4", 8), ((16, 4096), "sym8", 6), ((8, 1024), "Battle 23", 10),
    ((8, 4096), "Haar", 12), ((4, 262144), "db4", 10),
    ((64, 65536), "Discrete Meyer", 8),   # 62 taps: 5 tiled levels, then a tail of 3
    ((64, 65536), "db4", 16),             # levels beyond the tiled ones: a tail of 8
    ((4, 262144), "db4", 18),             # rows longer than one block could ever hold
    ((2, 1048576), "Discrete Meyer", 20), # two tiled passes over a scratch row
    ((1, 65536), "sym8", 3), ((133, 16384), "db4", 14), ((133, 8), "db4", 3),
    ((3, 65536), "db4", 0), ((3, 65536), "db4", 1),
])
def test_k3_matches_plain(cuda, shape, wavelet, level):
    fb = jt.get_filter(wavelet)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    done = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
    torch.full(shape, float("nan"), device=cuda)  # an element left unstored shows
    y = cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, done)
    torch.cuda.synchronize()
    ref = cuda_pyramid.pyramid_rows_torch(x.double(), fb.dec_lo, fb.dec_hi, done)
    assert bool(torch.isfinite(y).all())
    assert _rel_err(y, ref) <= F32_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("wavelet", ["Haar", "db4"])
def test_k3_short_rows_every_level(cuda, n, wavelet):
    fb = jt.get_filter(wavelet)
    x = torch.as_tensor(np.random.default_rng(11).standard_normal((5, n)), dtype=torch.float32,
                        device=cuda)
    for levels in range(n.bit_length()):
        y = cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, levels)
        torch.cuda.synchronize()
        ref = cuda_pyramid.pyramid_rows_torch(x.double(), fb.dec_lo, fb.dec_hi, levels)
        assert _rel_err(y, ref) <= F32_BOUND, levels


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,levels,tile,lt,tail", [
    ((6, 64), "db4", 6, 64, 4, 2),               # a halo of 105 on rows of 64: wraps twice
    ((6, 64), "db4", 6, 16, 4, 0),               # the same halo on tiles of 16, then the tail kernel
    ((6, 256), "Discrete Meyer", 5, 64, 3, 0),   # 62 taps, halo 427 > N
    ((6, 8192), "db4", 9, 1024, 6, 0),           # 8 tiles a row, head 128 left to the tail kernel
    ((6, 8192), "db4", 9, 1024, 3, 6),           # head 1024 = one tile: the tail in the launch
    ((6, 8192), "Haar", 13, 2, 1, 0),            # tiles of 2 samples
    ((6, 16), "Haar", 4, 16, 2, 2),
])
def test_k3_forced_plans(cuda, shape, wavelet, levels, tile, lt, tail):
    """Plans that :func:`k3_plan` does not choose at these sizes, to reach the
    segment's wrap, the ragged stores and the counters at small shapes."""
    fb = jt.get_filter(wavelet)
    m = len(fb.dec_lo)
    x = torch.as_tensor(np.random.default_rng(12).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    plan = cuda_pyramid.K3Plan(tile, lt, ((1 << lt) - 1) * (m - 1), tail,
                               cuda_pyramid.k3_smem_bytes(tile, lt, m))
    y = cuda_pyramid._k3(x, fb.dec_lo, fb.dec_hi, levels, plan=plan)
    torch.cuda.synchronize()
    ref = cuda_pyramid.pyramid_rows_torch(x.double(), fb.dec_lo, fb.dec_hi, levels)
    assert _rel_err(y, ref) <= F32_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k3_source_off_16_byte_alignment(cuda, offset):
    """A source 4, 8 or 12 bytes off: the segment is staged at that offset,
    or by plain loads where float2 reads would be misaligned."""
    fb = jt.get_filter("db4")
    shape = (32, 16384)
    x = torch.empty(shape[0] * shape[1] + offset, dtype=torch.float32,
                    device=cuda)[offset:].view(shape)
    x.copy_(torch.as_tensor(np.random.default_rng(13).standard_normal(shape)))
    y = cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, 9)
    torch.cuda.synchronize()
    ref = cuda_pyramid.pyramid_rows_torch(x.double(), fb.dec_lo, fb.dec_hi, 9)
    assert _rel_err(y, ref) <= F32_BOUND


@pytest.mark.cuda
def test_k3_counters_are_zero_again_after_a_launch(cuda):
    """Two calls back to back on one stream, both with a tail in the launch:
    the second finds the per-row counters as the first left them."""
    fb = jt.get_filter("db4")
    x = torch.as_tensor(np.random.default_rng(14).standard_normal((64, 65536)),
                        dtype=torch.float32, device=cuda)
    before = jt.ops.launch_counts()["K3"]
    a = cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, 16)
    b = cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, 16)
    torch.cuda.synchronize()
    assert jt.ops.launch_counts()["K3"] == before + 2  # one launch a call
    assert torch.equal(a, b)
    assert _rel_err(b, cuda_pyramid.pyramid_rows_torch(x.double(), fb.dec_lo, fb.dec_hi,
                                                       16)) <= F32_BOUND
    counters = cuda_pyramid._K3_COUNTERS[(x.device.index, 0)]
    assert int(counters.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("wavelet,shape,levels,gain", [
    ("Haar orthogonal", (16, 4096), 12, 0.5), ("db4", (64, 65536), 8, 2.0),
    ("Discrete Meyer", (8, 65536), 8, 0.75),
])
def test_k3_gain_matches_plain(cuda, wavelet, shape, levels, gain):
    """K3 with a gain folded into its taps: each level's a and d scaled."""
    fb = jt.get_filter(wavelet)
    x = torch.as_tensor(np.random.default_rng(15).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    got = cuda_pyramid.pyramid_rows(x, fb.rec_lo, fb.rec_hi, levels, gain)
    torch.cuda.synchronize()
    ref = cuda_pyramid.pyramid_rows_torch(x.double(), fb.rec_lo, fb.rec_hi, levels, gain)
    assert _rel_err(got, ref) <= F32_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level", [
    ((64, 65536), "db4", 8), ((64, 65536), "db4", 16), ((16, 4096), "sym8", 6),
    ((8, 1024), "Battle 23", 10), ((256, 1024), "Battle 23", 8), ((8, 4096), "Haar", 12),
    ((16, 4096), "Haar orthogonal", 12),  # recon_gain 0.5 folded into the taps
    ((64, 65536), "Discrete Meyer", 8),   # 62 taps: halos of 32 a level
    ((2, 1 << 22), "db4", 22),            # rows of 2^22: 512 tiles, cones of 10 samples deep down
    ((1, 65536), "sym8", 3), ((133, 16384), "db4", 14), ((133, 8), "db4", 3),
    ((3, 65536), "db4", 1), ((5, 2), "Haar", 1), ((5, 4), "db4", 2),
])
def test_k7_matches_plain(cuda, shape, wavelet, level):
    fb = jt.get_filter(wavelet)
    y = torch.as_tensor(np.random.default_rng(16).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    done = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
    before = jt.ops.launch_counts()["K7"]
    torch.full(shape, float("nan"), device=cuda)  # an element left unstored shows
    x = cuda_pyramid.ipyramid_rows(y, fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    torch.cuda.synchronize()
    ref = cuda_pyramid.ipyramid_rows_torch(y.double(), fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    assert bool(torch.isfinite(x).all())
    assert _rel_err(x, ref) <= F32_BOUND
    assert jt.ops.launch_counts()["K7"] == before + 1  # one launch a call


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("wavelet", ["Haar", "db4"])
def test_k7_short_rows_every_level(cuda, n, wavelet):
    """Rows of one tile whose heads are shorter than the filter: every cone
    is its whole head, read circularly; no level, no launch."""
    fb = jt.get_filter(wavelet)
    y = torch.as_tensor(np.random.default_rng(17).standard_normal((5, n)), dtype=torch.float32,
                        device=cuda)
    for levels in range(n.bit_length()):
        before = jt.ops.launch_counts()["K7"]
        x = cuda_pyramid.ipyramid_rows(y, fb.rec_lo, fb.rec_hi, 1.0, levels)
        torch.cuda.synchronize()
        ref = cuda_pyramid.ipyramid_rows_torch(y.double(), fb.rec_lo, fb.rec_hi, 1.0, levels)
        assert _rel_err(x, ref) <= F32_BOUND, levels
        assert jt.ops.launch_counts()["K7"] == before + (levels > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,levels,tile", [
    ((6, 64), "db4", 6, 16),               # cones that wrap at every level
    ((6, 256), "Discrete Meyer", 8, 2),    # tiles of 2 samples, 62 taps
    ((6, 8192), "Haar", 13, 4),
    ((6, 8192), "sym8", 9, 1024),
    ((3, 65536), "db4", 8, 4096), ((3, 65536), "db4", 8, 16384),
])
def test_k7_forced_plans(cuda, shape, wavelet, levels, tile):
    """Plans that :func:`k7_plan` does not choose at these sizes."""
    fb = jt.get_filter(wavelet)
    y = torch.as_tensor(np.random.default_rng(18).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    plan = cuda_pyramid.k7_plan(shape[1], levels, len(fb.rec_lo), tile)
    x = cuda_pyramid._k7(y, fb.rec_lo, fb.rec_hi, 1.0, levels, plan)
    torch.cuda.synchronize()
    ref = cuda_pyramid.ipyramid_rows_torch(y.double(), fb.rec_lo, fb.rec_hi, 1.0, levels)
    assert _rel_err(x, ref) <= F32_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level", [
    ((65536, 256), "db4", 8),      # ifwt3d's rows: 32 an item, 2048 items
    ((1000, 16), "db4", 4),        # 512 rows an item: one short item of 488
    ((37, 2048), "db4", 11),       # 4 an item: a last item of 1
    ((4097, 16), "Haar", 4),       # a short last item of 1 row
    ((3, 256), "sym8", 8),         # one short item, the generic taps
    ((9999, 2), "db4", 1),         # rows of 2: heads shorter than a group of pairs
    ((7, 4), "Haar orthogonal", 2),
    ((5, 4096), "Discrete Meyer", 12),  # rows of one tile: one an item
])
def test_k7_multi_row_blocks(cuda, shape, wavelet, level):
    """Rows of at most the tile: tile // n whole rows an item, the last one
    shorter where they do not divide the batch; one launch."""
    fb = jt.get_filter(wavelet)
    y = torch.as_tensor(np.random.default_rng(21).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    done = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
    plan = cuda_pyramid.k7_plan(shape[1], done, len(fb.rec_lo))
    assert shape[1] <= plan.tile and plan.rows == plan.tile // shape[1]
    before = jt.ops.launch_counts()["K7"]
    x = cuda_pyramid.ipyramid_rows(y, fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    torch.cuda.synchronize()
    ref = cuda_pyramid.ipyramid_rows_torch(y.double(), fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    assert bool(torch.isfinite(x).all())
    assert _rel_err(x, ref) <= F32_BOUND
    assert jt.ops.launch_counts()["K7"] == before + 1


@pytest.mark.cuda
def test_k7_persistent_item_counts(cuda):
    """The persistent grid at item counts around it: 1 item, grid - 1,
    grid + 1 (whole rows of one tile, one an item), tiles of 64 x 65536's
    plan that leave some blocks one item more than others, and a row of 2^22
    samples (512 items of one row)."""
    fb = jt.get_filter("db4")
    n = cuda_pyramid.K7_TILE
    full = n.bit_length() - 1
    plan = cuda_pyramid.k7_plan(n, full, 8)
    grid = cuda_pyramid.k7_grid(cuda, 1 << 20, n, full, 8, plan)
    big = cuda_pyramid.k7_plan(65536, 8, 8)
    tiles = 65536 // big.tile
    big_grid = cuda_pyramid.k7_grid(cuda, 1 << 20, 65536, 8, 8, big)
    rng = np.random.default_rng(22)
    for rows, cols, level in ((1, n, full), (grid - 1, n, full), (grid + 1, n, full),
                              (big_grid // tiles + 1, 65536, 8), (1, 1 << 22, 22)):
        y = torch.as_tensor(rng.standard_normal((rows, cols)), dtype=torch.float32, device=cuda)
        x = cuda_pyramid.ipyramid_rows(y, fb.rec_lo, fb.rec_hi, 1.0, level)
        torch.cuda.synchronize()
        ref = cuda_pyramid.ipyramid_rows_torch(y.double(), fb.rec_lo, fb.rec_hi, 1.0, level)
        assert _rel_err(x, ref) <= F32_BOUND, (rows, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k7_source_off_16_byte_alignment(cuda, offset):
    """A source 4, 8 or 12 bytes off: each cone is staged at its start's
    offset mod 16, its ragged edges by plain loads."""
    fb = jt.get_filter("db4")
    shape = (32, 16384)
    y = torch.empty(shape[0] * shape[1] + offset, dtype=torch.float32,
                    device=cuda)[offset:].view(shape)
    y.copy_(torch.as_tensor(np.random.default_rng(19).standard_normal(shape)))
    x = cuda_pyramid.ipyramid_rows(y, fb.rec_lo, fb.rec_hi, 1.0, 9)
    torch.cuda.synchronize()
    ref = cuda_pyramid.ipyramid_rows_torch(y.double(), fb.rec_lo, fb.rec_hi, 1.0, 9)
    assert _rel_err(x, ref) <= F32_BOUND


@pytest.mark.cuda
def test_inverse_fwt_paths_route_through_k7(cuda):
    """ifwt, the facade's reverse (1D and 3D), fwt_recompose, the in-place
    reverse and an ifwt2d that K5 does not take (rows of 32768) launch K7,
    never K5, and invert fwt."""
    x = torch.as_tensor(np.random.default_rng(20).standard_normal((8, 4096)), dtype=torch.float32,
                        device=cuda)
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "db4", device="cuda")
    vol = x.reshape(8, 64, 64).contiguous()
    wide = x.reshape(1, 32768).expand(4, -1).contiguous()
    calls = {
        "ifwt": (lambda: jt.ifwt(jt.fwt(x, "db4"), "db4"), x, 1),
        "reverse": (lambda: t.get_basic_transform().reverse(t.get_basic_transform().forward(x)),
                    x, 1),
        "3D reverse": (lambda: t.reverse(t.forward(vol)), vol, 3),
        "fwt_recompose": (lambda: jt.fwt_recompose(jt.fwt_decompose(x, "db4"), "db4"), x, 1),
        "reverse_in_place": (lambda: jt.InPlaceFastWaveletTransform("db4").reverse_in_place(
            jt.fwt(x, "db4")), x, 1),
        "ifwt2d 4x32768": (lambda: jt.ifwt2d(jt.fwt2d(wide, "db4"), "db4"), wide, 2),
    }
    for label, (fn, want, k7) in calls.items():
        jt.ops.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        assert jt.ops.launch_counts()["K7"] == k7, label
        assert jt.ops.launch_counts()["K5"] == 0, label
        assert _rel_err(got, want) <= F32_BOUND, label


# the rotated forms of K3 and K7 (whole rows, (R, N) in, (N, R) out): the
# volume's rows, rows of 64, a row count no item size divides, levels 0, 1
# and the most, db2 and sym8 (no unrolled taps), rows of 2 and 2048
ROTATED = [
    ((65536, 256), "db4", 6), ((4096, 64), "db4", 6), ((1000, 256), "db4", 8),
    ((1000, 256), "db4", 0), ((1000, 256), "db4", 1), ((4096, 64), "db2", 6),
    ((333, 128), "sym8", 7), ((77, 2048), "db4", 11), ((513, 2), "Haar", 1),
    ((37, 8), "db4", 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level", ROTATED, ids=lambda v: str(v))
def test_k3_rotated_matches_plain(cuda, shape, wavelet, level):
    fb = jt.get_filter(wavelet)
    x = torch.as_tensor(np.random.default_rng(41).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    done = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
    before = profiling.counts()
    torch.full(shape, float("nan"), device=cuda)  # an element left unstored shows
    y = cuda_pyramid.pyramid_rows_rotated(x, fb.dec_lo, fb.dec_hi, done)
    torch.cuda.synchronize()
    ref = cuda_pyramid.pyramid_rows_transposed_torch(x.double(), fb.dec_lo, fb.dec_hi, done)
    assert tuple(y.shape) == shape[::-1] and bool(torch.isfinite(y).all())
    assert _rel_err(y, ref) <= F32_BOUND
    after = profiling.counts()
    assert after["launch.K3"] == before["launch.K3"] + 1  # one launch a call
    assert after[cuda_pyramid.ROTATED_PASSES] == before[cuda_pyramid.ROTATED_PASSES] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level", ROTATED, ids=lambda v: str(v))
def test_k7_rotated_matches_plain(cuda, shape, wavelet, level):
    fb = jt.get_filter(wavelet)
    y = torch.as_tensor(np.random.default_rng(42).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    done = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
    args = (fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    before = profiling.counts()
    torch.full(shape, float("nan"), device=cuda)  # an element left unstored shows
    x = cuda_pyramid.ipyramid_rows_rotated(y, *args)
    torch.cuda.synchronize()
    ref = cuda_pyramid.ipyramid_rows_transposed_torch(y.double(), *args)
    assert tuple(x.shape) == shape[::-1] and bool(torch.isfinite(x).all())
    assert _rel_err(x, ref) <= F32_BOUND
    after = profiling.counts()
    assert after["launch.K7"] == before["launch.K7"] + 1
    assert after[cuda_pyramid.ROTATED_PASSES] == before[cuda_pyramid.ROTATED_PASSES] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2])
def test_rotated_source_off_16_byte_alignment(cuda, offset):
    """A source 4 or 8 bytes off: the producer warp loads the rows plainly."""
    fb = jt.get_filter("db4")
    shape = (300, 256)
    x = torch.empty(shape[0] * shape[1] + offset, dtype=torch.float32,
                    device=cuda)[offset:].view(shape)
    x.copy_(torch.as_tensor(np.random.default_rng(43).standard_normal(shape)))
    y = cuda_pyramid.pyramid_rows_rotated(x, fb.dec_lo, fb.dec_hi, 6)
    r = cuda_pyramid.ipyramid_rows_rotated(x, fb.rec_lo, fb.rec_hi, fb.recon_gain, 6)
    torch.cuda.synchronize()
    assert _rel_err(y, cuda_pyramid.pyramid_rows_transposed_torch(
        x.double(), fb.dec_lo, fb.dec_hi, 6)) <= F32_BOUND
    assert _rel_err(r, cuda_pyramid.ipyramid_rows_transposed_torch(
        x.double(), fb.rec_lo, fb.rec_hi, fb.recon_gain, 6)) <= F32_BOUND


def _separable(tr, v, levels, reverse=False):
    """The facade's 3D path before the rotated route: ndim over fwt/ifwt."""
    fb = tr.get_wavelet()
    if reverse:
        return ndim.reverse_3d(lambda u, lv: jt.ifwt(u, fb, lv), v, *levels)
    return ndim.forward_3d(lambda u, lv: jt.fwt(u, fb, lv), v, *levels)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,levels", [((256, 256, 256), (6, 6, 6)),
                                          ((32, 64, 128), (2, 5, 3)),
                                          ((16, 2048, 8), (4, None, 1))])
def test_fwt3d_ifwt3d_match_the_separable_path(cuda, shape, levels):
    """The facade's 3D forward and reverse on the rotated route against the
    separable path (K3/K7 in place and transposing copies), within 1e-6 of
    max|ref|: three launches of K3 (K7) and three rotated passes each."""
    tr = jt.Transform(jt.FastWaveletTransform("db4"))
    x = torch.as_tensor(np.random.default_rng(44).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    jt.ops.reset_launch_counts()
    passes = profiling.counts()[cuda_pyramid.ROTATED_PASSES]
    y = tr.forward(x, *levels)
    r = tr.reverse(y, *levels)
    torch.cuda.synchronize()
    launches = jt.ops.launch_counts()
    assert launches["K3"] == launches["K7"] == 3 and sum(launches.values()) == 6
    assert profiling.counts()[cuda_pyramid.ROTATED_PASSES] == passes + 6
    assert _rel_err(y, _separable(tr, x, levels)) <= 1e-6
    assert _rel_err(r, _separable(tr, y, levels, reverse=True)) <= 1e-6
    assert _rel_err(r, x) <= F32_BOUND


@pytest.mark.cuda
def test_volume_gradients_match_the_separable_path(cuda):
    """The gradient of a loss through the route's forward and reverse (the
    rotated passes' adjoints, K7 and K3 on the transposed gradient) against
    the separable path's."""
    tr = jt.Transform(jt.FastWaveletTransform("db4"))
    rng = np.random.default_rng(45)
    x = torch.as_tensor(rng.standard_normal((32, 64, 128)), dtype=torch.float32, device=cuda)
    w = torch.as_tensor(rng.standard_normal((32, 64, 128)), dtype=torch.float32, device=cuda)
    levels = (2, 5, 3)
    grads = []
    for route in (True, False):
        xg = x.clone().requires_grad_()
        if route:
            y = tr.forward(xg, *levels)
            loss = ((tr.reverse(y * w, *levels) * w).sum() + (y * y).sum())
        else:
            y = _separable(tr, xg, levels)
            loss = ((_separable(tr, y * w, levels, reverse=True) * w).sum() + (y * y).sum())
        grads.append(torch.autograd.grad(loss, xg)[0])
    torch.cuda.synchronize()
    assert _rel_err(grads[0], grads[1]) <= F32_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level,gain,offset", [
    ((2048, 2048), "db4", 6, 1.0, 0), ((512, 1024), "Haar", 3, 1.0, 0),
    ((64, 16384), "sym8", 4, 1.0, 0),
    ((6, 512), "db4", 5, 1.0, 0),                   # one ragged block of 6 rows: scalar stores
    ((13, 1024), "sym8", 6, 1.0, 0),                # a ragged last block of 5 rows
    ((64, 2), "Haar", 1, 1.0, 0),                   # rows of 2: staged by plain loads
    ((128, 256), "db4", 0, 1.0, 0),                 # no level: staging and store alone
    ((256, 512), "Haar orthogonal", 9, 0.5, 0),     # gain != 1 down to one sample
    ((32, 1024), "db4", 5, 1.0, 1),                 # a source 4 bytes off 16-byte alignment
    ((16, 16384), "db4", 8, 1.0, 0),                # one row a block
])
def test_k4_matches_plain(cuda, shape, wavelet, level, gain, offset):
    fb = jt.get_filter(wavelet)
    x = torch.empty(shape[0] * shape[1] + offset, dtype=torch.float32,
                    device=cuda)[offset:].view(shape)
    x.copy_(torch.as_tensor(np.random.default_rng(2).standard_normal(shape)))
    before = jt.ops.launch_counts()["K4"]
    y = cuda_pyramid.pyramid_rows_transposed(x, fb.dec_lo, fb.dec_hi, level, gain)
    torch.cuda.synchronize()
    ref = cuda_pyramid.pyramid_rows_transposed_torch(x.double(), fb.dec_lo, fb.dec_hi, level,
                                                     gain)
    assert tuple(y.shape) == (shape[1], shape[0])
    assert _rel_err(y, ref) <= F32_BOUND
    assert jt.ops.launch_counts()["K4"] == before + 1


@pytest.mark.cuda
def test_main_path_routes_through_the_kernels(cuda):
    jt.ops.reset_launch_counts()
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((8, 4096)),
                        dtype=torch.float32, device=cuda)
    back = jt.imodwt(jt.modwt(x, "Daubechies 4", 5), "Daubechies 4")
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "db4", device="cuda")
    rows = t.get_basic_transform().forward(x)
    img = t.forward(x[:, :512].contiguous().reshape(64, 64))
    torch.cuda.synchronize()
    assert float((back - x).abs().max()) < 1e-4
    assert rows.is_cuda and img.is_cuda
    launches = jt.ops.launch_counts()
    assert {k: launches[k] for k in ("K1", "K2", "K3", "K4", "K5", "K7")} == {
        "K1": 1, "K2": 1, "K3": 1, "K4": 2, "K5": 0, "K7": 0}


def _grad_of(fn, x, w):
    """d/dx sum(fn(x) * w) by autograd."""
    x = x.detach().requires_grad_()
    return torch.autograd.grad((fn(x) * w).sum(), x)[0]


def _routes(op, wavelet, shape, levels):
    """(the public entry, the same operator on the wrappers, which run the
    kernels' plain versions on CPU tensors) and the module and key of the
    K-name of the kernel the backward launches."""
    fb = jt.get_filter(wavelet)
    g0, h0 = _modwt_base_filters(wavelet)

    def done(n, lvl):
        return cuda_pyramid.levels_done(n, fb.transform_wavelength, lvl)

    if op == "modwt":
        return (lambda a: jt.modwt(a, wavelet, levels),
                lambda a: cuda_modwt.modwt_cascade(a, g0, h0, levels),
                "K2")
    if op == "imodwt":
        return (lambda a: jt.imodwt(a, wavelet), lambda a: cuda_modwt.imodwt_cascade(a, g0, h0),
                "K1")
    if op == "fwt":
        return (lambda a: jt.fwt(a, wavelet, levels),
                lambda a: cuda_pyramid.pyramid_rows(a, fb.dec_lo, fb.dec_hi,
                                                    done(shape[1], levels)),
                "K7")
    if op == "ifwt":
        return (lambda a: jt.ifwt(a, wavelet, levels),
                lambda a: cuda_pyramid.ipyramid_rows(a, fb.rec_lo, fb.rec_hi, fb.recon_gain,
                                                     done(shape[1], levels)),
                "K3")
    lr, lc = levels
    if op == "fwt2d":
        def plain(a):
            y = cuda_pyramid.pyramid_rows_transposed(a, fb.dec_lo, fb.dec_hi, done(shape[1], lc))
            return cuda_pyramid.pyramid_rows_transposed(y, fb.dec_lo, fb.dec_hi,
                                                        done(shape[0], lr))
        return (lambda a: jt.fwt2d(a, wavelet, lr, lc), plain,
                "K5")
    args = (fb.rec_lo, fb.rec_hi, fb.recon_gain)

    def plain(a):
        y = cuda_pyramid.ipyramid_rows_transposed(a, *args, done(shape[1], lc))
        return cuda_pyramid.ipyramid_rows_transposed(y, *args, done(shape[0], lr))
    return (lambda a: jt.ifwt2d(a, wavelet, lr, lc), plain,
            "K4")


@pytest.mark.cuda
@pytest.mark.parametrize("op,wavelet,shape,levels", [
    ("modwt", "db4", (8, 4096), 5), ("modwt", "Haar", (4, 8192), 13),
    ("imodwt", "db4", (8, 6, 4096), 5),
    ("fwt", "db4", (8, 65536), 8),
    ("modwt", "db4", (512, 181), 5), ("imodwt", "db4", (512, 6, 181), 5),  # whole rows
    ("fwt", "Battle 23", (8, 1024), 10), ("ifwt", "db4", (8, 65536), 8),
    ("ifwt", "Haar orthogonal", (8, 4096), 12), ("ifwt", "Battle 23", (8, 1024), 10),
    ("fwt2d", "db4", (256, 1024), (3, 5)),
    ("fwt2d", "Haar orthogonal", (128, 64), (5, 2)), ("ifwt2d", "db4", (256, 1024), (3, 5)),
    ("ifwt2d", "Haar orthogonal", (256, 256), (6, 6)),
])
def test_kernel_gradients_match_plain(cuda, op, wavelet, shape, levels):
    """Gradients of the entry points through K1-K5 and K7 on CUDA f32 against
    the same operators on the plain versions in float64; bound 1e-5 of
    max|ref|. The backward launches the adjoint kernel: modwt's K2, imodwt's
    K1, fwt's K7, ifwt's K3, fwt2d's K5, ifwt2d's K4."""
    rng = np.random.default_rng(4)
    entry, plain, launched = _routes(op, wavelet, shape, levels)
    x = torch.tensor(rng.standard_normal(shape))
    with torch.no_grad():
        w = torch.tensor(rng.standard_normal(tuple(plain(x).shape)))
    xc, wc = x.to(cuda, torch.float32).requires_grad_(), w.to(cuda, torch.float32)
    loss = (entry(xc) * wc).sum()
    before = jt.ops.launch_counts()[launched]
    (g,) = torch.autograd.grad(loss, xc)
    torch.cuda.synchronize()
    assert g.is_cuda and g.dtype == torch.float32 and tuple(g.shape) == shape
    assert _rel_err(g.cpu(), _grad_of(plain, x, w)) <= F32_BOUND
    assert jt.ops.launch_counts()[launched] >= before + 1  # in the backward alone


@pytest.mark.cuda
@pytest.mark.parametrize("wavelet,shape,levels,gain", [
    ("Haar orthogonal", (256, 256), 1, 0.5), ("Haar orthogonal", (256, 256), 4, 0.5),
    ("Haar orthogonal", (64, 1024), 8, 0.5), ("db4", (2048, 2048), 6, 1.0),
    ("sym8", (64, 16384), 4, 2.0),
])
def test_k4_gain_matches_plain(cuda, wavelet, shape, levels, gain):
    fb = jt.get_filter(wavelet)
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    got = cuda_pyramid.pyramid_rows_transposed(x, fb.rec_lo, fb.rec_hi, levels, gain)
    torch.cuda.synchronize()
    ref = cuda_pyramid.pyramid_rows_transposed_torch(x.double(), fb.rec_lo, fb.rec_hi, levels,
                                                     gain)
    assert tuple(got.shape) == (shape[1], shape[0])
    assert _rel_err(got, ref) <= F32_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level", [
    ((2048, 2048), "db4", 6), ((512, 1024), "Haar", 3), ((64, 16384), "sym8", 4),
    ((256, 1024), "Battle 23", 8), ((64, 64), "Haar orthogonal", 6), ((16384, 64), "db4", 3),
    ((128, 256), "db4", 0),
    ((100, 2048), "db4", 6),            # a ragged last block of 4 rows (16-byte stores)
    ((37, 512), "sym8", 5),             # rows not a multiple of 4: scalar stores
    ((64, 2), "Haar", 1),               # rows of 2: staged by plain loads
    ((64, 4), "Haar", 2),               # rows of 4: one 16-byte row a copy
    ((8, 16384), "db4", 6),             # one row a block
    ((40000, 16), "Haar", 4),           # 5000 row blocks, more than fit the card at once
])
def test_k5_matches_plain(cuda, shape, wavelet, level):
    fb = jt.get_filter(wavelet)
    y = torch.as_tensor(np.random.default_rng(5).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    done = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
    before = jt.ops.launch_counts()["K5"]
    got = cuda_pyramid.ipyramid_rows_transposed(y, fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    torch.cuda.synchronize()
    ref = cuda_pyramid.ipyramid_rows_transposed_torch(y.double(), fb.rec_lo, fb.rec_hi,
                                                      fb.recon_gain, done)
    assert tuple(got.shape) == (shape[1], shape[0])
    assert _rel_err(got, ref) <= F32_BOUND
    assert jt.ops.launch_counts()["K5"] == before + 1
    if shape[0] & (shape[0] - 1):
        return  # fwt2d and ifwt2d take power-of-two extents only
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    lr = min(level, shape[0].bit_length() - 1)
    back = jt.ifwt2d(jt.fwt2d(x, wavelet, lr, level), wavelet, lr, level)
    torch.cuda.synchronize()
    ref2 = jt.ifwt2d(jt.fwt2d(x.double(), wavelet, lr, level), wavelet, lr, level)
    assert _rel_err(back, ref2) <= F32_BOUND
    assert jt.ops.launch_counts()["K5"] == before + 3


#: (frames, height, width, bank, levels) of a grouped K4/K5 pass over the
#: frames' rows of width, in groups of height
_GROUPED = [
    (8, 2048, 2048, "db4", 6),       # the cell's pass: 2048 blocks of 8 rows
    (3, 64, 128, "Haar", 5),         # an odd frame count
    (5, 16, 256, "sym8", 4),         # groups of 16, two blocks a group
    (7, 4, 32, "db4", 3),            # groups of 4 under the 8 rows a block: blocks of 4
    (3, 2, 1024, "Haar", 6),         # groups of 2: scalar stores
    (1, 512, 64, "db4", 6),          # one group: the matrix's plain transpose
    (4, 256, 1024, "Battle 23", 5),  # non-square frames
]


@pytest.mark.cuda
@pytest.mark.parametrize("frames,height,width,wavelet,level", _GROUPED)
def test_grouped_k4_k5_match_plain_and_each_frame_alone(cuda, frames, height, width, wavelet,
                                                         level):
    """K4 and K5 on (F H, W) rows in groups of H against their plain versions
    (1e-5 of max|ref|), and, bit for bit, against the same kernel on each
    frame alone (one group, the matrix's launch): the grouping moves the
    stores and nothing else. One launch and one rotated pass each."""
    fb = jt.get_filter(wavelet)
    done = cuda_pyramid.levels_done(width, fb.transform_wavelength, level)
    x = torch.as_tensor(np.random.default_rng(frames * width + level).standard_normal(
        (frames * height, width)), dtype=torch.float32, device=cuda)
    k4 = (cuda_pyramid.pyramid_rows_transposed, cuda_pyramid.pyramid_rows_transposed_torch,
          (fb.dec_lo, fb.dec_hi, done, 1.0))
    k5 = (cuda_pyramid.ipyramid_rows_transposed, cuda_pyramid.ipyramid_rows_transposed_torch,
          (fb.rec_lo, fb.rec_hi, fb.recon_gain, done))
    for name, (kernel, plain, args) in (("K4", k4), ("K5", k5)):
        before = jt.ops.launch_counts()[name]
        passes = profiling.counts()[cuda_pyramid.ROTATED_PASSES]
        got = kernel(x, *args, group=height)
        torch.cuda.synchronize()
        assert jt.ops.launch_counts()[name] == before + 1
        assert profiling.counts()[cuda_pyramid.ROTATED_PASSES] == passes + 1
        assert tuple(got.shape) == (frames * width, height)
        assert _rel_err(got, plain(x.double(), *args, group=height)) <= F32_BOUND
        each = got.view(frames, width, height)
        for f in range(frames):
            alone = kernel(x[f * height:(f + 1) * height], *args)
            assert torch.equal(each[f], alone), (name, f)
        assert torch.equal(kernel(x, *args, group=x.shape[0]), kernel(x, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,levels", [((8, 2048, 2048), (6, 6)), ((3, 64, 128), (2, 5)),
                                          ((2, 3, 16, 32), (None, None)),
                                          ((5, 256, 64), (4, 6))])
def test_fwt2d_stack_route_launches_and_matches_the_separable_path(cuda, shape, levels):
    """The FWT facade's ``forward_2d``/``reverse_2d`` on a stack: two K4 and
    two K5 launches, four rotated passes, no K3, K7 or transposing copy;
    against the separable path (K3/K7 in place and the copies) within 1e-6
    of max|ref|, and the round trip within 1e-5."""
    tr = jt.FastWaveletTransform("Daubechies 4")
    fb = tr.get_wavelet()
    x = torch.as_tensor(np.random.default_rng(sum(shape)).standard_normal(shape),
                        dtype=torch.float32, device=cuda)
    jt.ops.reset_launch_counts()
    before = profiling.counts()
    y = tr.forward_2d(x, *levels)
    r = tr.reverse_2d(y, *levels)
    torch.cuda.synchronize()
    after = profiling.counts()
    launches = jt.ops.launch_counts()
    assert (launches["K4"], launches["K5"]) == (2, 2) and sum(launches.values()) == 4
    assert after[cuda_pyramid.ROTATED_PASSES] - before[cuda_pyramid.ROTATED_PASSES] == 4
    assert after["ndim.transposes"] == before["ndim.transposes"]
    assert y.shape == r.shape == x.shape and y.is_contiguous() and r.is_contiguous()
    sep_y = ndim.forward_2d(lambda v, lv: jt.fwt(v, fb, lv), x, *levels)
    sep_r = ndim.reverse_2d(lambda v, lv: jt.ifwt(v, fb, lv), y, *levels)
    assert _rel_err(y, sep_y) <= 1e-6 and _rel_err(r, sep_r) <= 1e-6
    assert _rel_err(r, x) <= F32_BOUND


@pytest.mark.cuda
def test_fwt2d_of_a_matrix_is_two_k4_passes_bit_for_bit(cuda):
    """One matrix takes the grouped route with one group: the same two K4
    (K5) launches as two passes of the wrapper with no group, bit for bit."""
    fb = jt.get_filter("Daubechies 4")
    x = torch.as_tensor(np.random.default_rng(31).standard_normal((2048, 2048)),
                        dtype=torch.float32, device=cuda)
    y = jt.fwt2d(x, fb, 6, 5)
    want = cuda_pyramid.pyramid_rows_transposed(
        cuda_pyramid.pyramid_rows_transposed(x, fb.dec_lo, fb.dec_hi, 5), fb.dec_lo, fb.dec_hi, 6)
    assert torch.equal(y, want)
    args = (fb.rec_lo, fb.rec_hi, fb.recon_gain)
    want = cuda_pyramid.ipyramid_rows_transposed(
        cuda_pyramid.ipyramid_rows_transposed(y, *args, 5), *args, 6)
    assert torch.equal(jt.ifwt2d(y, fb, 6, 5), want)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward_2d", "reverse_2d"])
def test_fwt2d_stack_gradients_match_the_torch_path(cuda, inverse):
    """The gradient of a weighted sum through the grouped route (K4's
    backward is K5 in groups on the gradient transposed back within each
    frame, and the other way round) against the same through the separable
    torch path in float64 on the CPU; bound 1e-5 of max|ref|."""
    rng = np.random.default_rng(32 + inverse)
    x = torch.tensor(rng.standard_normal((3, 64, 128)))
    w = torch.tensor(rng.standard_normal((3, 64, 128)))
    tr = jt.FastWaveletTransform("Daubechies 4")
    fb = tr.get_wavelet()
    xc = x.to(cuda, torch.float32).requires_grad_()
    fn = tr.reverse_2d if inverse else tr.forward_2d
    jt.ops.reset_launch_counts()
    (g,) = torch.autograd.grad((fn(xc, 2, 5) * w.to(cuda, torch.float32)).sum(), xc)
    torch.cuda.synchronize()
    assert jt.ops.launch_counts()["K5" if inverse else "K4"] == 2
    assert jt.ops.launch_counts()["K4" if inverse else "K5"] == 2  # the backward's
    xd = x.clone().requires_grad_()
    sep = (ndim.reverse_2d(lambda v, lv: jt.ifwt(v, fb, lv), xd, 2, 5) if inverse
           else ndim.forward_2d(lambda v, lv: jt.fwt(v, fb, lv), xd, 2, 5))
    (want,) = torch.autograd.grad((sep * w).sum(), xd)
    assert _rel_err(g.cpu(), want) <= F32_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("g,s,n,k,lo,hi", [
    (8, 64, 65536, 64, -3, 67), (2, 12, 300, 20, -3, 23), (3, 16, 1000, 200, -3, 203),
])
def test_k6_matches_plain(cuda, g, s, n, k, lo, hi):
    rng = np.random.default_rng(7)
    c = torch.as_tensor(rng.standard_normal((g, s, n)) + 1j * rng.standard_normal((g, s, n)),
                        dtype=torch.complex64, device=cuda)
    kk = torch.as_tensor(rng.integers(lo, hi + 1, (g, s, n)), dtype=torch.int32, device=cuda)
    before = jt.ops.launch_counts()["K6"]
    got = cuda_reassign.reassign(c, kk, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.complex64 and tuple(got.shape) == (g, k, n)
    ref = cuda_reassign.reassign_torch(c.to(torch.complex128), kk, k)
    assert _rel_err(torch.view_as_real(got), torch.view_as_real(ref)) <= F32_BOUND
    assert jt.ops.launch_counts()["K6"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("g,s,n,k,lo,hi,offset", [
    (2, 9, 1026, 63, -3, 66, 0),     # N % 4 != 0: the ring takes plain loads, the plane bulk stores
    (2, 5, 777, 65, -3, 68, 0),      # N odd: plain loads and stores; two bin chunks
    (3, 7, 100, 20, -3, 23, 0),      # N < 128: one ragged tile
    (2, 1, 512, 5, -3, 8, 0),        # S = 1
    (2, 13, 4096, 64, -3, 67, 0),    # S not a multiple of the stage's rows
    (2, 64, 4096, 1, -1, 1, 0),      # one bin
    (3, 16, 1000, 200, -3, 203, 0),  # four bin chunks
    (1, 33, 8192, 128, 0, 128, 0),   # two whole chunks
    (2, 5, 4096, 8, 8, 20, 0),       # every index dropped: zeros
    (2, 5, 4096, 8, -9, -1, 0),      # every index negative
    (2, 13, 4096, 64, -3, 67, 1),    # views 8 and 4 bytes off 16-byte alignment
])
def test_k6_edges_match_plain_and_repeat_bitwise(cuda, g, s, n, k, lo, hi, offset):
    rng = np.random.default_rng(6)
    c = torch.empty(g * s * n + offset, dtype=torch.complex64, device=cuda)[offset:].view(g, s, n)
    c.copy_(torch.as_tensor(rng.standard_normal((g, s, n)) + 1j * rng.standard_normal((g, s, n))))
    kk = torch.empty(g * s * n + offset, dtype=torch.int32, device=cuda)[offset:].view(g, s, n)
    kk.copy_(torch.as_tensor(rng.integers(lo, hi + 1, (g, s, n))))
    torch.full((g, k, n), float("nan"), dtype=torch.complex64, device=cuda)
    got = cuda_reassign.reassign(c, kk, k)
    again = cuda_reassign.reassign(c, kk, k)
    torch.cuda.synchronize()
    ref = cuda_reassign.reassign_torch(c.to(torch.complex128), kk, k)
    assert tuple(got.shape) == (g, k, n) and bool(torch.isfinite(torch.view_as_real(got)).all())
    scale = float(ref.abs().max())
    err = float((got.to(torch.complex128) - ref).abs().max())
    assert err <= F32_BOUND * scale if scale else err == 0.0
    # ascending s in every column, no atomics: two runs agree to the bit
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(again))


@pytest.mark.cuda
def test_k6_gradient_is_the_gather(cuda):
    rng = np.random.default_rng(8)
    c = torch.as_tensor(rng.standard_normal((2, 12, 300)) + 1j * rng.standard_normal((2, 12, 300)),
                        dtype=torch.complex64, device=cuda).requires_grad_()
    kk = torch.as_tensor(rng.integers(-2, 23, (2, 12, 300)), dtype=torch.int32, device=cuda)
    w = torch.as_tensor(rng.standard_normal((2, 20, 300)), dtype=torch.float32, device=cuda)
    (cuda_reassign.reassign(c, kk, 20).abs() ** 2 * w).sum().backward()
    c2 = c.detach().cpu().requires_grad_()
    (cuda_reassign.reassign(c2, kk.cpu(), 20).abs() ** 2 * w.cpu()).sum().backward()
    assert _rel_err(torch.view_as_real(c.grad.cpu()), torch.view_as_real(c2.grad)) <= F32_BOUND


@pytest.mark.cuda
def test_ssq_and_ifwt2d_route_through_k5_k6(cuda):
    jt.ops.reset_launch_counts()
    fs = 1000.0
    t = np.arange(2048) / fs
    x = torch.as_tensor(np.cos(2 * np.pi * 50.0 * t), dtype=torch.float32, device=cuda)
    sc = jt.generate_log_scales(0.002, 0.2, 64)
    res = jt.ssq_cwt(x, sc, jt.MorletWavelet(1, 1), fs)
    ref = jt.ssq_cwt(x, sc, jt.MorletWavelet(1, 1), fs, reassign="scatter")
    img = jt.ifwt2d(torch.zeros((64, 64), device=cuda), "db4")
    torch.cuda.synchronize()
    assert res.Tx.is_cuda and res.Tx.dtype == torch.complex64
    assert _rel_err(torch.view_as_real(res.Tx), torch.view_as_real(ref.Tx)) <= F32_BOUND
    ridge = float(res.ridge()[512:1536].median())
    assert abs(ridge - 50.0) / 50.0 < 0.05
    assert img.is_cuda
    assert jt.ops.launch_counts()["K6"] == 1
    assert jt.ops.launch_counts()["K5"] == 2


@pytest.mark.cuda
def test_convolutions_are_true_float32_by_default(cuda):
    """With no call to the dial, a cuDNN path (the synthesis butterflies that
    ifwt takes where K7 does not) agrees with float64 to 1e-5: TF32's 10-bit
    mantissa would miss by orders of magnitude."""
    assert jt.config.conv_precision() == "highest"
    y = torch.as_tensor(np.random.default_rng(0).standard_normal((8, 4096)), dtype=torch.float32,
                        device=cuda)
    fb = jt.get_filter("db4")
    got = synthesis_levels(y, fb.rec_lo, fb.rec_hi, 8)
    assert _rel_err(got, synthesis_levels(y.double(), fb.rec_lo, fb.rec_hi, 8)) <= F32_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "level by level", "interleaved"])
def test_wpt_on_the_card_matches_float64(cuda, mode):
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((8, 4096)), dtype=torch.float32,
                        device=cuda)
    kw = {"fused": {}, "level by level": {"fused": False},
          "interleaved": {"layout": "interleaved"}}[mode]
    jt.ops.reset_launch_counts()
    y = jt.wpt(x, "db4", 6, **kw)
    back = jt.iwpt(y, "db4", 6, **kw)
    torch.cuda.synchronize()
    assert y.is_cuda and y.dtype == torch.float32
    assert _rel_err(y, jt.wpt(x.double(), "db4", 6, **kw)) <= F32_BOUND
    assert _rel_err(back, x) <= F32_BOUND
    launches = jt.ops.launch_counts()
    assert not any(launches[k] for k in ("K1", "K2", "K3", "K4", "K5", "K7"))
    fused = int(mode != "level by level")  # one K8 and one K9 launch a fused chunk
    assert (launches["K8"], launches["K9"]) == (fused, fused)


#: (shape, bank, levels): the main shape; every chunk of wpt at full depth
#: on 65536 (65536 L6 tiled, 1024 L6 and 16 L4 whole rows); packets
#: shorter than the cone (16 at L4: 105 taps mod 16; 8 at L3); 62 taps
#: (L3); Haar (no halo at L6) and Haar orthogonal (gain 0.5 a level); the
#: generic taps (sym8, db2); one level (c = 1); rows of 2; row counts around
#: the item grouping (a short last item); a long row of 2^20; banks of odd
#: length outside the builder (Battle 23, CDF 9/7)
WPT_CASES = [
    ((64, 65536), "db4", 6), ((64, 1024), "db4", 6), ((256, 16), "db4", 4),
    ((3, 8), "db4", 3), ((5, 4096), "Discrete Meyer", 3), ((5, 65536), "Discrete Meyer", 3),
    ((4, 8192), "Haar", 6), ((4, 8192), "Haar orthogonal", 6), ((7, 2048), "sym8", 5),
    ((9, 16384), "sym8", 4), ((1000, 16), "db2", 4), ((133, 4096), "db4", 1),
    ((9999, 2), "Haar", 1), ((257, 512), "db4", 6), ((3, 1 << 20), "db4", 6),
    ((3, 4096), "Battle 23", 4), ((5, 65536), "CDF 9/7", 6),  # odd banks
    ((16384, 2048), "db4", 6),  # the 2D packet cell's rows: 8 frames of 2048^2
]


@pytest.mark.cuda
@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("shape,wavelet,levels", WPT_CASES, ids=lambda v: str(v))
def test_wpt_kernels_match_plain(cuda, shape, wavelet, levels, interleaved):
    """K8 and K9 (with the bank's synthesis pair and recon_gain) against
    their plain versions in float64 on the same input; one launch each."""
    fb = jt.get_filter(wavelet)
    x = torch.as_tensor(np.random.default_rng(23).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    before = jt.ops.launch_counts()
    torch.full(shape, float("nan"), device=cuda)  # an element left unstored shows
    y = cuda_wpt.wpt_rows(x, fb.dec_lo, fb.dec_hi, levels, interleaved=interleaved)
    z = cuda_wpt.iwpt_rows(x, fb.rec_lo, fb.rec_hi, levels, fb.recon_gain, interleaved)
    torch.cuda.synchronize()
    ref_y = cuda_wpt.wpt_analysis_torch(x.double(), fb.dec_lo, fb.dec_hi, levels, 1.0, interleaved)
    ref_z = cuda_wpt.wpt_synthesis_torch(x.double(), fb.rec_lo, fb.rec_hi, levels, fb.recon_gain,
                                         interleaved)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(z).all())
    assert _rel_err(y, ref_y) <= F32_BOUND
    assert _rel_err(z, ref_z) <= F32_BOUND
    launches = jt.ops.launch_counts()
    assert (launches["K8"], launches["K9"]) == (before["K8"] + 1, before["K9"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,levels,tile", [
    ((6, 8192), "db4", 6, 512),        # 8 positions a subband: 16 items a row
    ((6, 4096), "db4", 3, 64),         # cones that wrap, 64 items a row
    ((6, 2048), "Discrete Meyer", 2, 32),
    ((6, 4096), "Haar", 5, 256), ((6, 65536), "db4", 6, 16384),
    ((6, 1024), "sym8", 4, 2048),      # whole rows, two an item
])
def test_wpt_kernels_forced_plans(cuda, shape, wavelet, levels, tile):
    """Plans that :func:`wpt_plan` does not choose at these sizes, both
    layouts."""
    fb = jt.get_filter(wavelet)
    x = torch.as_tensor(np.random.default_rng(24).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    m = len(fb.dec_lo)
    for inter in (False, True):
        y = cuda_wpt._k8(x, fb.dec_lo, fb.dec_hi, levels, 1.0, inter,
                         cuda_wpt.wpt_plan(shape[1], levels, m, False, tile))
        z = cuda_wpt._k9(x, fb.rec_lo, fb.rec_hi, levels, 0.5, inter,
                         cuda_wpt.wpt_plan(shape[1], levels, m, True, tile))
        torch.cuda.synchronize()
        ref_y = cuda_wpt.wpt_analysis_torch(x.double(), fb.dec_lo, fb.dec_hi, levels, 1.0, inter)
        ref_z = cuda_wpt.wpt_synthesis_torch(x.double(), fb.rec_lo, fb.rec_hi, levels, 0.5, inter)
        assert _rel_err(y, ref_y) <= F32_BOUND, inter
        assert _rel_err(z, ref_z) <= F32_BOUND, inter


@pytest.mark.cuda
def test_wpt_kernels_persistent_grid(cuda):
    """K8 and K9's one wave of persistent blocks at the edges of its grid,
    both layouts: whole-row items (rows of 1024, 4 an item, the last of 3) at
    grid - 1, grid and grid + 1 items; tiled items (rows of 65536, 16 a row)
    on grids forced to items - 1, items and items + 1; forced grids of 1 and
    2 on tiled and on whole-row items (rows of 16, 256 an item)."""
    fb = jt.get_filter("db4")
    rng = np.random.default_rng(28)
    whole = cuda_wpt.wpt_plan(1024, 6, 8)
    grids = {cuda_wpt.wpt_grid(cuda, 1 << 20, 1024, 6, 8, inv, whole) for inv in (False, True)}
    cases = [((g * whole.rows - 1 + 4 * d, 1024), 6, None) for g in grids for d in (-1, 0, 1)]
    items = cuda_wpt.wpt_items(24, 65536, cuda_wpt.wpt_plan(65536, 6, 8))
    cases += [((24, 65536), 6, g) for g in (items - 1, items, items + 1, 1, 2)]
    cases += [((1001, 16), 4, g) for g in (1, 2)]
    for shape, levels, grid in cases:
        x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda)
        for inter in (False, True):
            y = cuda_wpt._k8(x, fb.dec_lo, fb.dec_hi, levels, 1.0, inter, None, grid)
            z = cuda_wpt._k9(x, fb.rec_lo, fb.rec_hi, levels, fb.recon_gain, inter, None, grid)
            torch.cuda.synchronize()
            ref_y = cuda_wpt.wpt_analysis_torch(x.double(), fb.dec_lo, fb.dec_hi, levels, 1.0,
                                                inter)
            ref_z = cuda_wpt.wpt_synthesis_torch(x.double(), fb.rec_lo, fb.rec_hi, levels,
                                                 fb.recon_gain, inter)
            assert _rel_err(y, ref_y) <= F32_BOUND, (shape, grid, inter)
            assert _rel_err(z, ref_z) <= F32_BOUND, (shape, grid, inter)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("shape,levels", [((8, 16384), 6), ((40, 256), 5)])
def test_wpt_kernels_source_off_16_byte_alignment(cuda, offset, shape, levels):
    """Sources 4, 8 or 12 bytes off (tiled rows and whole rows): staged by
    plain loads."""
    fb = jt.get_filter("db4")
    x = torch.empty(shape[0] * shape[1] + offset, dtype=torch.float32,
                    device=cuda)[offset:].view(shape)
    x.copy_(torch.as_tensor(np.random.default_rng(25).standard_normal(shape)))
    for inter in (False, True):
        y = cuda_wpt.wpt_rows(x, fb.dec_lo, fb.dec_hi, levels, interleaved=inter)
        z = cuda_wpt.iwpt_rows(x, fb.rec_lo, fb.rec_hi, levels, 1.0, inter)
        torch.cuda.synchronize()
        assert _rel_err(y, cuda_wpt.wpt_analysis_torch(x.double(), fb.dec_lo, fb.dec_hi, levels,
                                                       1.0, inter)) <= F32_BOUND
        assert _rel_err(z, cuda_wpt.wpt_synthesis_torch(x.double(), fb.rec_lo, fb.rec_hi, levels,
                                                        1.0, inter)) <= F32_BOUND


@pytest.mark.cuda
def test_wpt_paths_route_through_k8_k9(cuda):
    """wpt and iwpt at full depth on 65536 (chunks L6, L6, L4: three K8 and
    three K9 launches), the WPT facade in 1D, 2D and 3D, and the layouts:
    each against float64 through the same calls."""
    rng = np.random.default_rng(26)
    x = torch.as_tensor(rng.standard_normal((4, 65536)), dtype=torch.float32, device=cuda)
    img = torch.as_tensor(rng.standard_normal((256, 256)), dtype=torch.float32, device=cuda)
    vol = torch.as_tensor(rng.standard_normal((32, 32, 32)), dtype=torch.float32, device=cuda)
    t = jt.TransformBuilder.create("Wavelet Packet Transform", "db4", device="cuda")
    calls = {
        "wpt full depth": (lambda a: jt.wpt(a, "db4"), x, (3, 0)),
        "iwpt full depth": (lambda a: jt.iwpt(a, "db4"), x, (0, 3)),
        "wpt interleaved L6": (lambda a: jt.wpt(a, "db4", 6, layout="interleaved"), x, (1, 0)),
        "iwpt interleaved L6": (lambda a: jt.iwpt(a, "db4", 6, layout="interleaved"), x, (0, 1)),
        "facade 1D forward": (lambda a: t.get_basic_transform().forward(a), x, (3, 0)),
        "facade 2D forward": (lambda a: t.forward(a), img, (4, 0)),
        "facade 2D reverse": (lambda a: t.reverse(a), img, (0, 4)),
        "facade 3D reverse": (lambda a: t.reverse(a), vol, (0, 3)),
    }
    for label, (fn, a, (k8, k9)) in calls.items():
        jt.ops.reset_launch_counts()
        got = fn(a)
        torch.cuda.synchronize()
        launches = jt.ops.launch_counts()
        assert (launches["K8"], launches["K9"]) == (k8, k9), label
        assert _rel_err(got, fn(a.double())) <= F32_BOUND, label


@pytest.mark.cuda
@pytest.mark.parametrize("op,wavelet,shape,level", [
    ("wpt", "db4", (4, 65536), None), ("iwpt", "db4", (4, 65536), None),
    ("wpt", "Haar orthogonal", (8, 4096), 6), ("iwpt", "Haar orthogonal", (8, 4096), 6),
    ("wpt", "Discrete Meyer", (4, 4096), 3), ("iwpt", "sym8", (4, 2048), 5),
])
def test_wpt_gradients_launch_the_adjoint_kernel(cuda, op, wavelet, shape, level):
    """wpt's backward launches K9 and iwpt's K8, against autograd of the
    plain versions in float64 (the same calls on CPU tensors); 1e-5 of
    max|ref|."""
    rng = np.random.default_rng(27)
    fn = (lambda a: getattr(jt, op)(a, wavelet, level))
    x = torch.tensor(rng.standard_normal(shape))
    w = torch.tensor(rng.standard_normal(shape))
    xc, wc = x.to(cuda, torch.float32).requires_grad_(), w.to(cuda, torch.float32)
    loss = (fn(xc) * wc).sum()
    jt.ops.reset_launch_counts()
    (g,) = torch.autograd.grad(loss, xc)
    torch.cuda.synchronize()
    back = "K9" if op == "wpt" else "K8"
    assert jt.ops.launch_counts()[back] >= 1 and g.dtype == torch.float32
    assert _rel_err(g.cpu(), _grad_of(fn, x, w)) <= F32_BOUND


@pytest.mark.cuda
def test_wpt_facade_2d_on_a_stack_of_frames_keeps_to_the_cells_limit(cuda):
    """The WPT facade's ``forward_2d``/``reverse_2d`` on the packet cell's
    request, 8 frames of 2048^2 db4 at 6 levels an axis (one K8, then one
    K9, on 16384 rows an axis), against the benchmark's float64 reference
    frame by frame, within the cell's limit of 3e-5."""
    from benchmark.compare import RelErr
    from benchmark.reference import taps
    from benchmark.reference import wpt as ref

    gen = torch.Generator(device=cuda).manual_seed(2**31 + 26)
    x = torch.randn((8, 2048, 2048), generator=gen, device=cuda)
    w = jt.WaveletPacketTransform("Daubechies 4")
    jt.ops.reset_launch_counts()
    y = w.forward_2d(x, 6, 6)
    r = w.reverse_2d(y, 6, 6)
    torch.cuda.synchronize()
    launches = jt.ops.launch_counts()
    assert (launches["K8"], launches["K9"]) == (2, 2)
    lo, hi = taps.fwt_bank("Daubechies 4")
    coeffs, recon = RelErr(), RelErr()
    for f in range(8):
        ry = ref.wpt_nd(x[f], lo, hi, (6, 6))
        coeffs.add(y[f], ry)
        recon.add(r[f], ref.iwpt_nd(ry, lo, hi, (6, 6)))
    assert coeffs.value <= 3e-5 and recon.value <= 3e-5, (coeffs.value, recon.value)


@pytest.mark.cuda
def test_wpt_facade_2d_counts_its_copies_and_chunks_on_a_warm_call(cuda):
    """A warm ``forward_2d``/``reverse_2d`` on a stack: one ``wpt2d`` and one
    ``iwpt2d`` root, each with no transposing copy and two rotated passes,
    two fused chunks (one rotated K8 or K9 launch an axis, its span marked
    ``rotated`` with its group) and no butterfly level."""
    x = torch.randn((8, 256, 512), device=cuda)
    w = jt.WaveletPacketTransform("Daubechies 4")
    w.reverse_2d(w.forward_2d(x, 6, 6), 6, 6)  # warm: the library loaded
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        w.reverse_2d(w.forward_2d(x, 6, 6), 6, 6)
    fwd, rev = [s for s in profiling.spans() if s.parent is None]
    assert (fwd.name, rev.name) == ("wpt2d", "iwpt2d")
    for root, k in ((fwd, "launch.K8"), (rev, "launch.K9")):
        assert root.counts.get("ndim.transposes", 0) == 0
        assert root.counts.get("ndim.transpose_bytes", 0) == 0
        assert root.counts[cuda_pyramid.ROTATED_PASSES] == 2
        assert root.counts["wpt.fused_chunks"] == root.counts[k] == 2
        assert "wpt.butterfly_levels" not in root.counts and "upload.calls" not in root.counts
    for k, parent in (("launch.K8", "wpt"), ("launch.K9", "iwpt")):
        launched = [s for s in profiling.spans() if s.name == k]
        assert [s.parent for s in launched] == [parent] * 2
        assert [s.args for s in launched] == [
            {"rows": 8 * 256, "n": 512, "levels": 6, "rotated": 1, "group": 256},
            {"rows": 8 * 512, "n": 256, "levels": 6, "rotated": 1, "group": 512}]


#: the rotated forms of K8 and K9 ((F G, n) in, (F, n, G) out), as (shape,
#: group, packet length h, bank, levels): the packet cell's axis pass (8
#: frames of 2048^2), rows of 64 in groups of 64 at 2 to 6 levels with db4,
#: Haar and sym8, and packets of 4 in rows of 256 (wpt's last chunk at full
#: depth on 256, 64 rows of h a full row)
_WPT_ROTATED = ([((16384, 2048), 2048, 2048, "db4", 6)]
                + [((128, 64), 64, 64, w, lv) for w in ("db4", "Haar", "sym8")
                   for lv in range(2, 7)]
                + [((512, 256), 256, 4, "db4", 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,group,h,wavelet,levels", _WPT_ROTATED, ids=lambda v: str(v))
def test_wpt_rotated_kernels_match_plain(cuda, shape, group, h, wavelet, levels):
    """The rotated K8 (K9, the synthesis pair and recon_gain) against the
    plain K8 (K9) in float64 followed by the transpose of each group of rows,
    1e-5 of max|ref|; one launch each, counted as K8 (K9) and as a rotated
    pass."""
    fb = jt.get_filter(wavelet)
    r, n = shape
    x = torch.as_tensor(np.random.default_rng(r + n + levels).standard_normal(shape),
                        dtype=torch.float32, device=cuda)
    jt.ops.reset_launch_counts()
    passes = profiling.counts()[cuda_pyramid.ROTATED_PASSES]
    y = cuda_wpt.wpt_rows_rotated(x, fb.dec_lo, fb.dec_hi, levels, group, h)
    z = cuda_wpt.iwpt_rows_rotated(x, fb.rec_lo, fb.rec_hi, levels, group, h, fb.recon_gain)
    torch.cuda.synchronize()
    launches = jt.ops.launch_counts()
    assert (launches["K8"], launches["K9"]) == (1, 1)
    assert profiling.counts()[cuda_pyramid.ROTATED_PASSES] - passes == 2
    assert y.shape == z.shape == (r // group, n, group)

    def by_groups(rows):
        return rows.reshape(r, n).reshape(r // group, group, n).transpose(1, 2)

    xd = x.double().reshape(-1, h)
    assert _rel_err(y, by_groups(cuda_wpt.wpt_analysis_torch(xd, fb.dec_lo, fb.dec_hi,
                                                             levels))) <= F32_BOUND
    assert _rel_err(z, by_groups(cuda_wpt.wpt_synthesis_torch(
        xd, fb.rec_lo, fb.rec_hi, levels, fb.recon_gain))) <= F32_BOUND


@pytest.mark.cuda
def test_wpt_rotated_kernels_refuse_what_they_do_not_take(cuda):
    """Groups that no item divides, rows that make no whole group, rows longer
    than ``ROT_MAX``, packets that do not cut the row and one level raise."""
    fb = jt.get_filter("db4")
    for shape, group, h, levels in (((64, 64), 4, None, 2), ((96, 64), 64, None, 2),
                                    ((8, 2 * cuda_wpt.ROT_MAX), 8, None, 2),
                                    ((64, 64), 64, 24, 2), ((64, 64), 64, None, 1)):
        x = torch.zeros(shape, device=cuda)
        for rotated in (cuda_wpt.wpt_rows_rotated, cuda_wpt.iwpt_rows_rotated):
            with pytest.raises(jt.JWaveFailure):
                rotated(x, fb.dec_lo, fb.dec_hi, levels, group, h)


@pytest.mark.cuda
def test_dtcwt_on_the_card_matches_float64(cuda):
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((4, 4096)), dtype=torch.float32,
                        device=cuda)
    res = jt.dtcwt(x, 6)
    ref = jt.dtcwt(x.double(), 6)
    for g, r in zip(res.highpasses, ref.highpasses):
        assert g.dtype == torch.complex64
        assert _rel_err(torch.view_as_real(g), torch.view_as_real(r)) <= F32_BOUND
    assert _rel_err(jt.idtcwt(res), x) <= F32_BOUND
    img = x[:, :1024].reshape(64, 64)
    res2 = jt.dtcwt2d(img, 4)
    ref2 = jt.dtcwt2d(img.double(), 4)
    for g, r in zip(res2.highpasses, ref2.highpasses):
        assert _rel_err(torch.view_as_real(g), torch.view_as_real(r)) <= F32_BOUND
    assert _rel_err(jt.idtcwt2d(res2), img) <= F32_BOUND


@pytest.mark.cuda
def test_in_place_fwt_reuses_storage_on_the_card(cuda):
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((8, 4096)), dtype=torch.float32,
                        device=cuda)
    ref = jt.fwt(x.double(), "db4")
    buf = x.clone()
    ptr = buf.data_ptr()
    jt.ops.reset_launch_counts()
    y = jt.InPlaceFastWaveletTransform("db4").forward_in_place(buf)
    torch.cuda.synchronize()
    assert y.data_ptr() == ptr and jt.ops.launch_counts()["K3"] == 1
    assert _rel_err(y, ref) <= F32_BOUND


# --------------------------------------------------------------------------
# on any machine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,level,k1,k2", [
    (65536, 8, 5, [(1, 5, True)], [(1, 5, True)]),
    (8192, 2, 13, [(1, 11, True), (12, 12, True), (13, 13, True)],
     [(1, 6, True), (7, 10, True), (11, 11, True), (12, 12, True), (13, 13, True)]),
    (20000, 62, 10, [(1, 5, True), (6, 6, True), (7, 7, True), (8, 8, True), (9, 9, False),
                     (10, 10, False)],
     [(1, 4, True), (5, 6, True), (7, 7, True), (8, 8, False), (9, 9, False), (10, 10, False)]),
    (2896, 62, 5, [(1, 5, True)], [(1, 4, True), (5, 5, True)]),
    (2896, 8, 9, [(1, 8, True), (9, 9, True)], [(1, 5, True), (6, 8, True), (9, 9, True)]),
    (65536, 8, 13, [(1, 8, True), (9, 9, True), (10, 10, True), (11, 11, True),
                    (12, 12, False), (13, 13, False)],
     [(1, 5, True), (6, 8, True), (9, 9, True), (10, 10, True), (11, 11, False),
      (12, 12, False), (13, 13, False)]),
])
def test_level_groups(n, m, level, k1, k2):
    """K1's plan (its segment, V buffers and store stages) and K2's (every
    segment of a group prefetched), each within SMEM_BYTES: both cover
    levels 1..level in order, every staged group leaves three blocks to an
    SM, a group grows while the next level still fits, a level runs
    unstaged only when it does not fit alone, and each group's segment is
    the tile and its halo."""
    assert list(cuda_modwt.level_groups(n, m, level)) == k1
    assert list(cuda_modwt.inverse_level_groups(n, m, level)) == k2
    tl = min(cuda_modwt.TILE, n)
    for groups, smem, bf16 in ((k1, cuda_modwt.k1_smem_bytes, (2, 2, 2)),
                               (k2, cuda_modwt.k2_smem_bytes, (2, 2))):
        assert [j for j0, j1, _ in groups for j in range(j0, j1 + 1)] == list(range(1, level + 1))
        for j0, j1, staged in groups:
            f32 = smem(tl, m, j0, j1)
            if not staged:
                assert f32 > cuda_modwt.SMEM_BYTES
                continue
            assert f32 <= cuda_modwt.SMEM_BYTES and 3 * (f32 + 1024) <= 228 * 1024
            assert j1 == level or smem(tl, m, j0, j1 + 1) > cuda_modwt.SMEM_BYTES
            assert smem(tl, m, j0, j1, *bf16) < f32
            length = cuda_modwt.segment_length(tl, m, j0, j1)
            assert length == tl + (m - 1) * ((1 << j1) - (1 << (j0 - 1)))


@pytest.mark.parametrize("rows,n,level,itemsize,want", [
    (32, 64, 5, 4, 74400),     # the batch cell's n = 64, f32
    (32, 64, 5, 2, 45728),     # the same in bf16
    (22, 90, 5, 4, 71952),     # 1980 samples a block
    (1, 2048, 13, 4, 139936),  # one row at level 13
    (1, 100, 1, 4, 1872),      # one level: no V buffer
    (3, 7, 2, 2, 944),         # two levels: one V buffer; every buffer rounded up
])
def test_whole_row_smem_bytes(rows, n, level, itemsize, want):
    """A whole-row K1 or K2 block's shared bytes (``csrc/modwt.cu``
    row_layout), worked out by hand: 640 bytes of taps and mbarriers; the
    input stage and 16 bytes; min(level - 1, 2) f32 V buffers of rows * n
    samples; the output stage and 16 bytes; each rounded up to 16 bytes.
    K1 stages rows of n and writes rows of (level + 1) n, K2 the reverse,
    so both take the same. At 32 x 64, level 5, f32: 640 + (8192 + 16) +
    2 x 8192 + (32 x 6 x 64 x 4 + 16) = 74400; in bf16 640 + 4112 + 16384 +
    24592 = 45728. At 3 x 7, level 2, bf16: 640 + (42 -> 48, + 16) +
    (84 -> 96) + (126 -> 128, + 16) = 944."""
    assert cuda_modwt.whole_row_smem_bytes(rows, n, level, itemsize) == want


@pytest.mark.parametrize("n,level,itemsize,want", [
    (64, 5, 4, 16), (90, 5, 4, 11), (181, 5, 4, 5), (362, 5, 4, 2), (724, 5, 4, 1),
    (1448, 5, 4, 1), (2048, 5, 4, 1), (64, 5, 2, 16), (1448, 5, 2, 1),
    (64, 13, 4, 16),   # 70304 bytes: still three blocks an SM
    (2048, 13, 4, 1),  # 139936 bytes: one block an SM
    (2049, 5, 4, 0), (2049, 5, 2, 0), (65536, 5, 4, 0),  # longer than WHOLE_ROW_MAX: tiles
])
def test_rows_per_block(n, level, itemsize, want):
    """The whole-row plan: ROW_SAMPLES // n rows a block (at least one); 0
    (the tiles) past WHOLE_ROW_MAX."""
    assert cuda_modwt.rows_per_block(n, level, itemsize) == want


@pytest.mark.parametrize("m", [8, 62])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_whole_row_threshold(m, itemsize):
    """Rows of up to WHOLE_ROW_MAX (2048) samples run whole at every level
    1..13, in f32 and bf16, whatever the filter length: with no halo, m
    changes no byte of the block (the taps take a fixed 512 bytes). A row
    one sample longer takes the tiles, whose plan does depend on m. Every
    plan fits the card; a block of several rows leaves three an SM."""
    assert cuda_modwt.WHOLE_ROW_MAX == 2048 and cuda_modwt.ROW_SAMPLES == 1024
    for level in range(1, 14):
        assert cuda_modwt.rows_per_block(2048, level, itemsize) == 1
        assert cuda_modwt.whole_row_smem_bytes(1, 2048, level, itemsize) \
            <= cuda_modwt.BLOCK_SMEM_MAX
        assert cuda_modwt.rows_per_block(2049, level, itemsize) == 0
        groups = cuda_modwt.level_groups(2049, m, level)
        levels = [j for j0, j1, _ in groups for j in range(j0, j1 + 1)]
        assert levels == list(range(1, level + 1))
        for n in range(1, 2049, 37):
            rows = cuda_modwt.rows_per_block(n, level, itemsize)
            smem = cuda_modwt.whole_row_smem_bytes(rows, n, level, itemsize)
            assert 1 <= rows <= max(1, cuda_modwt.ROW_SAMPLES // n)
            assert smem <= cuda_modwt.BLOCK_SMEM_MAX
            assert rows == 1 or 3 * (smem + 1024) <= 228 * 1024
    # the tiled plan differs with m where the halo outgrows a block
    assert cuda_modwt.level_groups(2049, 8, 13) != cuda_modwt.level_groups(2049, 62, 13)


@pytest.mark.parametrize("tl,m,j0,j1,itemsize_x,itemsize_out,itemsize_v,want", [
    (2048, 8, 1, 5, 4, 4, 4, 44256),  # the main path: db4 L5, f32
    (2048, 8, 1, 5, 2, 2, 2, 31536),  # bf16 storage
    (2048, 8, 1, 5, 4, 2, 4, 36064),  # bf16 W rows from f32 scratch
    (2048, 2, 1, 1, 4, 4, 4, 25280),  # one level: no V buffer, one W stage, a V_j1 stage
    (2048, 8, 6, 7, 4, 4, 4, 47952),  # two levels; the halo starts at 2^(j0-1)
    (777, 8, 1, 9, 4, 4, 4, 59168),   # a short row: buffers rounded up to 16 bytes
])
def test_k1_smem_bytes(tl, m, j0, j1, itemsize_x, itemsize_out, itemsize_v, want):
    """K1's shared bytes (``csrc/modwt.cu`` fwd_layout), worked out by hand:
    640 bytes of taps and mbarriers; the V_{j0-1} segment of
    tl + (M-1)(2^j1 - 2^(j0-1)) samples and 16 bytes for its offset mod 16
    (main path: 2265 x 4 = 9060 -> 9072, + 16);
    two f32 buffers of V_j0's tl + (M-1)(2^j1 - 2^j0) samples and 16 bytes
    (2258 x 4 = 9032 -> 9040, + 16 each), the second holding V_j1's stage
    at the last level; the W stages, two of tl samples plus 16 bytes (8192
    + 16 each): 640 + 9088 + 18112 + 16416 = 44256. A single level has no V
    buffer, one W stage and its own V_j1 stage."""
    assert cuda_modwt.k1_smem_bytes(tl, m, j0, j1, itemsize_x, itemsize_out,
                                    itemsize_v) == want


@pytest.mark.parametrize("tl,m,j0,j1,itemsize_v,itemsize_c,want", [
    (2048, 8, 1, 5, 4, 4, 69568),  # the main path: db4 L5, f32
    (2048, 8, 1, 5, 2, 2, 43760),  # bf16 storage
    (2048, 8, 1, 5, 4, 2, 48288),  # bf16 W segments over an f32 scratch V
    (2048, 2, 1, 1, 4, 4, 25248),  # one level: one f32 V buffer
    (2048, 8, 6, 8, 4, 4, 71296),  # a later group: its halo starts at 2^(j0-1)
    (777, 8, 1, 8, 4, 4, 63216),   # a short row: segments rounded up to 16 bytes
])
def test_k2_smem_bytes(tl, m, j0, j1, itemsize_v, itemsize_c, want):
    """K2's shared bytes (``csrc/modwt.cu`` inv_layout), worked out by hand:
    640 bytes of taps and mbarriers, the V_j1 segment, the W_j1..W_j0
    segments and the f32 V buffers, each rounded up to 16 bytes."""
    assert cuda_modwt.k2_smem_bytes(tl, m, j0, j1, itemsize_v, itemsize_c) == want


@pytest.mark.parametrize("args,want", [
    # tile 8192, quarter 2048. db4: halo 7 (2^Lt - 1), 1785 at Lt = 8 (3577 at 9): all 8 levels
    # tiled. Floats: taps and barrier 132; segment 8192 + 1785 = 9977 -> 9980 + 4; odd levels'
    # approximations 4096 + 127 * 7 = 4985 -> 4988 + 4; stages 4096, 2048, ..., 32 and 32 again,
    # each + 4: 8192 + 36. 132 + 9984 + 4992 + 8228 = 23336 floats
    ((65536, 8, 8), dict(tile=8192, levels=8, halo=1785, tail_levels=0, smem_bytes=93344)),
    # 64 taps: halo 63 (2^Lt - 1) = 1953 at Lt = 5 (3969 at 6); the head left, 2048, fits a
    # tile: the last 3 levels are the launch's tail. Segment 10145 -> 10148 + 4, approximations
    # 4096 + 15 * 63 = 5041 -> 5044 + 4, stages 4096 .. 256 and 256 again = 8192, 6 x 4:
    # 132 + 10152 + 5048 + 8216 = 23548 floats
    ((65536, 8, 64), dict(tile=8192, levels=5, halo=1953, tail_levels=3, smem_bytes=94192)),
    # rows of 2^20: 8 tiled levels leave a head of 4096 <= 8192: a tail of 2, one launch
    ((1 << 20, 10, 8), dict(tile=8192, levels=8, halo=1785, tail_levels=2, smem_bytes=93344)),
    # Haar on 16: tile 16, quarter 4, halo 2^Lt - 1 = 3 at Lt = 2 (7 at 3); head 4 left: tail 2.
    # 132 + (19 -> 20 + 4) + (8 + 1 = 9 -> 12 + 4) + (8 + 4) + (4 + 4) + (4 + 4) = 200 floats
    ((16, 4, 2), dict(tile=16, levels=2, halo=3, tail_levels=2, smem_bytes=800)),
    # rows of 2: a quarter of the tile is 0 samples, no level is tiled
    ((2, 1, 2), dict(tile=2, levels=0, halo=0, tail_levels=0, smem_bytes=608)),
])
def test_k3_plan(args, want):
    """``csrc/pyramid.cu`` k3_layout's arithmetic for (n, levels, m), worked
    out by hand."""
    assert cuda_pyramid.k3_plan(*args)._asdict() == want


def test_k3_plan_fits_every_row_length_and_filter():
    for lg in range(21):
        n = 1 << lg
        for m in range(1, 65):
            plan = cuda_pyramid.k3_plan(n, lg, m)
            assert plan.tile == min(n, cuda_pyramid.K3_TILE) and 0 <= plan.levels <= lg
            assert plan.halo == ((1 << plan.levels) - 1) * (m - 1) <= plan.tile // 4
            assert plan.tile >> plan.levels >= 1
            assert 0 < plan.smem_bytes and 2 * (plan.smem_bytes + 1024) <= 227 * 1024
            # a tail in the launch only on a head that one tile's segment holds
            assert plan.tail_levels in (0, lg - plan.levels)
            assert not plan.tail_levels or (plan.levels and n >> plan.levels <= plan.tile)
            # rows too long for the tail kernel always lose a level to a tiled pass
            assert plan.levels >= 1 or n <= cuda_pyramid.K3_TAIL_HEAD or lg == 0
    assert cuda_pyramid.k3_tail_smem_bytes(cuda_pyramid.K3_TAIL_MAX_HEAD) <= 227 * 1024


@pytest.mark.parametrize("wavelet", ["Haar", "db4", "sym8", "Discrete Meyer"])
@pytest.mark.parametrize("lg", range(1, 13))
def test_k3_tiling_in_plain_torch(wavelet, lg, rng):
    """The kernel's partition of the work (tiles, right halo mod N, valid
    lengths per level, then the head that is left) computed in plain torch,
    against the plain pyramid in float64 at 1e-12: the plan K3 would take,
    a quarter-row tile, and forced plans whose halo exceeds the row."""
    fb = jt.get_filter(wavelet)
    m = len(fb.dec_lo)
    n = 1 << lg
    x = torch.tensor(rng.standard_normal((2, n)))
    for levels in range(lg + 1):
        ref = cuda_pyramid.pyramid_rows_torch(x, fb.dec_lo, fb.dec_hi, levels)
        plans = [cuda_pyramid.k3_plan(n, levels, m),
                 cuda_pyramid.k3_plan(n, levels, m, tile=max(2, n // 4))]
        for t in {n, max(1, n // 2), max(1, n // 8)}:
            for lt in range(min(levels, t.bit_length() - 1) + 1):
                halo = ((1 << lt) - 1) * (m - 1)
                if halo <= 8 * n + 64:
                    plans.append(cuda_pyramid.K3Plan(t, lt, halo, 0, 0))
        for plan in plans:
            got = cuda_pyramid.pyramid_rows_tiled_torch(x, fb.dec_lo, fb.dec_hi, levels, plan)
            err = float((got - ref).abs().max())
            assert err <= 1e-12 * max(float(ref.abs().max()), 1.0), (levels, plan, err)


def test_k6_smem_bytes():
    """``csrc/reassign.cu`` smem_bytes by hand: a 64-bin plane of 128 complex64
    columns is 65536 B, the ring 4 stages x 4 s-rows x 128 columns x 12 B =
    24576 B, four mbarriers 32 B; two blocks fit an SM."""
    assert cuda_reassign.k6_smem_bytes(64) == 65536 + 24576 + 32 == 90144
    assert cuda_reassign.k6_smem_bytes(200) == 90144           # a chunk of 64 bins a block
    assert cuda_reassign.k6_smem_bytes(1) == 1024 + 24576 + 32
    assert cuda_reassign.k6_smem_bytes(20) == 20 * 1024 + 24576 + 32
    assert 2 * (cuda_reassign.k6_smem_bytes(64) + 1024) <= 227 * 1024


def test_k4_rows_per_block():
    """K4 stages K5's rows. Its shared layout, worked out by hand: 132
    floats of taps and mbarrier (528 bytes), rb rows at a stride of n + 4
    floats and rb rows of level 1's approximations at n/2 + 4 (2048:
    528 + 8 x 2052 x 4 + 8 x 1028 x 4 = 99088). Positive for every power of
    two n <= 16384, so fwt2d keeps K4 for every extent it took; two blocks
    share an SM."""
    assert cuda_pyramid.k4_rows_per_block(2048) == 8
    assert cuda_pyramid.k4_rows_per_block(16384) == 1
    assert cuda_pyramid.k4_rows_per_block(32768) == 0
    assert cuda_pyramid.k4_smem_bytes(2048, 8) == 99088
    assert cuda_pyramid.k4_smem_bytes(16384, 1) == 98864
    assert cuda_pyramid.k4_smem_bytes(2, 8) == 880
    for n in (1 << e for e in range(17)):
        rb = cuda_pyramid.k4_rows_per_block(n)
        assert (rb > 0) == (n <= 16384)
        if rb:
            assert 1 <= rb <= 8
            assert 2 * (cuda_pyramid.k4_smem_bytes(n, rb) + 1024) <= 228 * 1024


def test_k5_rows_per_block():
    """rb staged rows of n floats within K5_ROW_FLOATS: three blocks share an
    SM, a level's rb*n/4 output pairs fit K5_PAIRS register pairs a thread, and
    K5 (K4's backward) takes every row length K4 takes."""
    assert cuda_pyramid.k5_rows_per_block(2048) == 8
    assert cuda_pyramid.k5_rows_per_block(16384) == 1
    assert cuda_pyramid.k5_rows_per_block(32768) == 0
    for n in (1 << e for e in range(17)):
        rb = cuda_pyramid.k5_rows_per_block(n)
        assert (rb > 0) == (n <= cuda_pyramid.K5_ROW_FLOATS)
        assert rb > 0 or cuda_pyramid.k4_rows_per_block(n) == 0
        if rb:
            smem = cuda_pyramid.k5_smem_bytes(n, rb)
            assert smem <= 227 * 1024 and 3 * (smem + 1024) <= 228 * 1024
            assert rb * (n // 4) <= cuda_pyramid.K5_PAIRS * cuda_pyramid.K5_THREADS
            assert rb <= cuda_pyramid.K5_MAX_ROWS_PER_BLOCK


def _jax_or_skip():
    """JAX and its Pallas interpret mode, where installed (not on the card's machine)."""
    return pytest.importorskip("jax")


def _interpreting(monkeypatch, module):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(module.pl, "pallas_call", patched)


@pytest.mark.parametrize("plain", ["scatter", "dense"])
def test_plain_k6_matches_reassign_pallas(plain, monkeypatch, rng):
    """tests/test_pallas.py's unaligned case (2, 12, 300), K=20, indices in
    [0, K] (K is the drop sentinel), complex64: bound 1e-5 (f32 sums in
    another order)."""
    _jax_or_skip()
    import jax.numpy as jnp

    from jwave_tpu.ops import pallas_reassign as pr

    _interpreting(monkeypatch, pr)
    s, n, k_bins = 12, 300, 20
    c = (rng.standard_normal((2, s, n)) + 1j * rng.standard_normal((2, s, n))).astype(np.complex64)
    k = rng.integers(0, k_bins + 1, (2, s, n)).astype(np.int32)
    want = np.asarray(pr.reassign_pallas(jnp.asarray(c), jnp.asarray(k), k_bins))
    fn = cuda_reassign.reassign_torch if plain == "scatter" else cuda_reassign.reassign_dense_torch
    got = fn(torch.tensor(c), torch.tensor(k), k_bins)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (2, k_bins, n)
    assert float(np.max(np.abs(got.numpy() - want))) < 1e-5
    # negative indices are dropped as well
    k2 = rng.integers(-3, k_bins + 4, (2, s, n)).astype(np.int32)
    want2 = np.asarray(pr.reassign_pallas(jnp.asarray(c), jnp.asarray(k2), k_bins))
    assert float(np.max(np.abs(fn(torch.tensor(c), torch.tensor(k2), k_bins).numpy()
                               - want2))) < 1e-5


def test_k6_gradient_matches_jax_grad(monkeypatch, rng):
    """K6's backward (the gather) against jax.grad through reassign_pallas's
    custom VJP, on a weighted energy of the squeezed plane. torch's complex
    gradient is the conjugate of JAX's."""
    jax = _jax_or_skip()
    import jax.numpy as jnp

    from jwave_tpu.ops import pallas_reassign as pr

    _interpreting(monkeypatch, pr)
    s, n, k_bins = 12, 300, 20
    c = (rng.standard_normal((2, s, n)) + 1j * rng.standard_normal((2, s, n))).astype(np.complex64)
    k = rng.integers(-2, k_bins + 3, (2, s, n)).astype(np.int32)
    w = rng.standard_normal((2, k_bins, n)).astype(np.float32)
    kj, wj = jnp.asarray(k), jnp.asarray(w)
    g_j = np.asarray(jax.grad(lambda z: jnp.sum(jnp.abs(pr.reassign_pallas(z, kj, k_bins)) ** 2
                                                * wj))(jnp.asarray(c)))
    ct = torch.tensor(c, requires_grad=True)
    (cuda_reassign.reassign(ct, torch.tensor(k), k_bins).abs() ** 2 * torch.tensor(w)).sum() \
        .backward()
    got = ct.grad.numpy()
    assert float(np.max(np.abs(got - np.conj(g_j)))) < 1e-5 * float(np.max(np.abs(g_j)))


@pytest.mark.parametrize("wavelet,shape,level", [("sym8", (512, 512), 3),
                                                 ("Haar orthogonal", (512, 512), 4)])
def test_plain_k5_two_passes_match_ifwt2d_fused(wavelet, shape, level, rng):
    """Two plain transposed inverse passes = the fused inverse 2D kernel
    (interpret mode), f32; bound 2e-6 of max|ref| as in tests/test_pallas.py,
    at its 512 x 512 (the unrouted Pallas kernel itself departs from the
    separable inverse when an extent is below 512, e.g. 256 x 512 db4 L3)."""
    _jax_or_skip()
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from jwave_tpu.ops.pallas_pyramid import ifwt2d_fused

    fb = jt.get_filter(wavelet)
    y = rng.standard_normal(shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ifwt2d_fused(jnp.asarray(y), wavelet, level, level))
    d_cols = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
    d_rows = cuda_pyramid.levels_done(shape[0], fb.transform_wavelength, level)
    p1 = cuda_pyramid.ipyramid_rows_transposed_torch(torch.tensor(y), fb.rec_lo, fb.rec_hi,
                                                     fb.recon_gain, d_cols)
    assert tuple(p1.shape) == (shape[1], shape[0])
    got = cuda_pyramid.ipyramid_rows_transposed_torch(p1, fb.rec_lo, fb.rec_hi,
                                                      fb.recon_gain, d_rows)
    assert got.dtype == torch.float32
    assert float(np.max(np.abs(got.numpy() - want))) < 2e-6 * float(np.max(np.abs(want)))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """The build says what is missing; nothing falls back to a plain path."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(jt.JWaveError, match="nvcc"):
        cuda_build.library("modwt")
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.parametrize("which", ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9"])
def test_cpu_tensors_take_the_plain_version(which, rng):
    jt.ops.reset_launch_counts()
    g0, h0 = _modwt_base_filters("db4")
    fb = jt.get_filter("db4")
    x = torch.tensor(rng.standard_normal((4, 256)), dtype=torch.float32)
    if which == "K1":
        got, want = (cuda_modwt.modwt_cascade(x, g0, h0, 3),
                     cuda_modwt.modwt_cascade_torch(x, g0, h0, 3))
    elif which == "K2":
        c = torch.tensor(rng.standard_normal((4, 4, 256)), dtype=torch.float32)
        got, want = cuda_modwt.imodwt_cascade(c, g0, h0), cuda_modwt.imodwt_cascade_torch(c, g0, h0)
    elif which == "K3":
        got, want = (cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, 4),
                     cuda_pyramid.pyramid_rows_torch(x, fb.dec_lo, fb.dec_hi, 4))
    elif which == "K4":
        got, want = (cuda_pyramid.pyramid_rows_transposed(x, fb.dec_lo, fb.dec_hi, 4),
                     cuda_pyramid.pyramid_rows_transposed_torch(x, fb.dec_lo, fb.dec_hi, 4))
    elif which == "K5":
        got, want = (cuda_pyramid.ipyramid_rows_transposed(x, fb.rec_lo, fb.rec_hi, 1.0, 4),
                     cuda_pyramid.ipyramid_rows_transposed_torch(x, fb.rec_lo, fb.rec_hi, 1.0, 4))
    elif which == "K7":
        got, want = (cuda_pyramid.ipyramid_rows(x, fb.rec_lo, fb.rec_hi, 1.0, 4),
                     cuda_pyramid.ipyramid_rows_torch(x, fb.rec_lo, fb.rec_hi, 1.0, 4))
    elif which == "K8":
        got, want = (cuda_wpt.wpt_rows(x, fb.dec_lo, fb.dec_hi, 4),
                     cuda_wpt.wpt_analysis_torch(x, fb.dec_lo, fb.dec_hi, 4))
    elif which == "K9":
        got, want = (cuda_wpt.iwpt_rows(x, fb.rec_lo, fb.rec_hi, 4, 1.0),
                     cuda_wpt.wpt_synthesis_torch(x, fb.rec_lo, fb.rec_hi, 4, 1.0))
    else:
        c = torch.complex(x, x.flip(-1))
        k = torch.tensor(rng.integers(-1, 6, (4, 256)), dtype=torch.int32)
        got, want = cuda_reassign.reassign(c, k, 5), cuda_reassign.reassign_torch(c, k, 5)
    assert torch.equal(got, want)
    assert not any(jt.ops.launch_counts().values())


def _wrappers():
    """Each kernel wrapper: the call, its input's shape and dtype, and the
    autograd Function it goes through for a gradient."""
    g0, h0 = _modwt_base_filters("db4")
    fb = jt.get_filter("db4")
    lo, hi, rlo, rhi = fb.dec_lo, fb.dec_hi, fb.rec_lo, fb.rec_hi
    k = torch.tensor(np.random.default_rng(5).integers(-1, 6, (4, 256)), dtype=torch.int32)
    f32, c64 = torch.float32, torch.complex64
    return {
        "K1": (lambda x: cuda_modwt.modwt_cascade(x, g0, h0, 3), (4, 256), f32, "_ModwtCascade"),
        "K2": (lambda c: cuda_modwt.imodwt_cascade(c, g0, h0), (4, 4, 256), f32,
               "_ImodwtCascade"),
        "K3": (lambda x: cuda_pyramid.pyramid_rows(x, lo, hi, 4), (4, 256), f32, "_PyramidRows"),
        "K3.rotated": (lambda x: cuda_pyramid.pyramid_rows_rotated(x, lo, hi, 4), (4, 256), f32,
                       "_PyramidRowsRotated"),
        "K4": (lambda x: cuda_pyramid.pyramid_rows_transposed(x, lo, hi, 4), (4, 256), f32,
               "_PyramidRowsT"),
        "K5": (lambda y: cuda_pyramid.ipyramid_rows_transposed(y, rlo, rhi, 1.0, 4), (4, 256),
               f32, "_IPyramidRowsT"),
        "K6": (lambda c: cuda_reassign.reassign(c, k, 5), (4, 256), c64, "_Reassign"),
        "K7": (lambda y: cuda_pyramid.ipyramid_rows(y, rlo, rhi, 1.0, 4), (4, 256), f32,
               "_IPyramidRows"),
        "K7.rotated": (lambda y: cuda_pyramid.ipyramid_rows_rotated(y, rlo, rhi, 1.0, 4),
                       (4, 256), f32, "_IPyramidRowsRotated"),
        "K8": (lambda x: cuda_wpt.wpt_rows(x, lo, hi, 4), (4, 256), f32, "_WptRows"),
        "K9": (lambda y: cuda_wpt.iwpt_rows(y, rlo, rhi, 4, 1.0), (4, 256), f32, "_IWptRows"),
    }


@pytest.mark.parametrize("which", ["K1", "K2", "K3", "K3.rotated", "K4", "K5", "K6", "K7",
                                   "K7.rotated", "K8", "K9"])
def test_wrappers_take_their_autograd_function_only_for_a_gradient(which, rng, monkeypatch):
    """``cuda_build.apply``: a wrapper runs its kernel directly unless a
    gradient of its input is wanted, and then goes through its Function,
    which the result records; both give the same values."""
    fn, shape, dtype, function = _wrappers()[which]
    cls = next(getattr(m, function) for m in (cuda_modwt, cuda_pyramid, cuda_reassign, cuda_wpt)
               if hasattr(m, function))
    applied, real = [], cls.apply
    monkeypatch.setattr(cls, "apply", lambda *args: applied.append(1) or real(*args))
    x = torch.tensor(rng.standard_normal(shape)).to(dtype)
    plain = fn(x)
    xg = x.clone().requires_grad_()
    with torch.no_grad():
        assert fn(xg).grad_fn is None
    assert plain.grad_fn is None and not applied
    y = fn(xg)
    assert applied == [1]
    assert type(y.grad_fn).__name__ == f"{function}Backward"
    assert torch.equal(y.detach(), plain)
