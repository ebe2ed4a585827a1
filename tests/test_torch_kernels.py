"""The hand-written CUDA kernels K1-K6 of jwave_tpu_torch.

Tests marked ``cuda`` build and launch the kernels and hold them against
their plain torch versions (run in float64 on the same input); they need a
CUDA card and skip without one. Run them on the card with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts=''

The other tests check, on any machine, what surrounds the kernels: the
level grouping of K1/K2, the row blocking of K4/K5, the build's error on a
missing compiler, that CPU tensors take the plain versions, and (where JAX
is installed) the plain versions of K5/K6 and K6's gradient against the
Pallas kernels they replace, run in interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_build, cuda_modwt, cuda_pyramid, cuda_reassign  # noqa: E402
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
    ((2, 100), "Discrete Meyer", 6, torch.float32),  # halo 3843 > N: 40 pieces a segment
    ((2, 100), "Discrete Meyer", 6, torch.bfloat16),
    ((3, 4099), "db4", 4, torch.float32),            # unaligned N: plain-loaded piece edges
    ((8, 777), "db4", 9, torch.bfloat16),
    ((5, 1001), "sym8", 7, torch.bfloat16),
    ((4, 8192), "Haar", 13, torch.bfloat16),         # five K2 groups over f32 scratch
    ((2, 65536), "db4", 13, torch.float32),          # K2 groups staged and unstaged
])
def test_k1_k2_match_plain(cuda, shape, wavelet, level, dtype):
    g0, h0 = _modwt_base_filters(wavelet)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(shape), dtype=dtype,
                        device=cuda)
    bound = F32_BOUND if dtype == torch.float32 else BF16_BOUND
    before = dict(cuda_modwt.launch_counts)
    c = cuda_modwt.modwt_cascade(x, g0, h0, level)
    back = cuda_modwt.imodwt_cascade(c, g0, h0)
    torch.cuda.synchronize()
    assert c.dtype == dtype and back.dtype == dtype
    assert _rel_err(c, cuda_modwt.modwt_cascade_torch(x.double(), g0, h0, level)) <= bound
    assert _rel_err(back, cuda_modwt.imodwt_cascade_torch(c.double(), g0, h0)) <= bound
    assert cuda_modwt.launch_counts["modwt_cascade"] > before["modwt_cascade"]
    assert cuda_modwt.launch_counts["imodwt_cascade"] > before["imodwt_cascade"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level,dtype", [
    ((64, 65536), "db4", 5, torch.float32),
    ((3, 4099), "db4", 4, torch.float32),            # N % 4 != 0: rows off 16-byte alignment
    ((8, 777), "db4", 9, torch.bfloat16),            # N % 8 != 0 in bf16
    ((2, 100), "Discrete Meyer", 6, torch.float32),  # a halo longer than N
    ((3, 5000), "db4", 6, torch.float32),            # a ragged last tile
    ((4, 8192), "Haar", 13, torch.float32),          # three groups over f32 scratch
    ((4, 8192), "Haar", 13, torch.bfloat16),         # the same, bf16 rows from f32 scratch
    ((2, 65536), "db4", 13, torch.float32),          # staged groups, then unstaged levels
])
def test_k1_matches_plain(cuda, shape, wavelet, level, dtype):
    """K1 alone, one launch per level group, against its plain version in
    float64. The output's memory held NaN before (the caching allocator
    hands the freed block to the wrapper), so an element left unstored
    shows."""
    g0, h0 = _modwt_base_filters(wavelet)
    x = torch.as_tensor(np.random.default_rng(10).standard_normal(shape), dtype=dtype,
                        device=cuda)
    before = cuda_modwt.launch_counts["modwt_cascade"]
    torch.full((shape[0], level + 1, shape[1]), float("nan"), dtype=dtype, device=cuda)
    c = cuda_modwt.modwt_cascade(x, g0, h0, level)
    torch.cuda.synchronize()
    assert c.dtype == dtype and bool(torch.isfinite(c).all())
    bound = F32_BOUND if dtype == torch.float32 else BF16_BOUND
    assert _rel_err(c, cuda_modwt.modwt_cascade_torch(x.double(), g0, h0, level)) <= bound
    groups = cuda_modwt.level_groups(shape[1], len(g0), level)
    assert cuda_modwt.launch_counts["modwt_cascade"] == before + len(groups)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wavelet,level", [
    ((64, 65536), "db4", 8), ((16, 4096), "sym8", 6), ((8, 1024), "Battle 23", 10),
    ((8, 4096), "Haar", 12), ((4, 262144), "db4", 10),
])
def test_k3_matches_plain(cuda, shape, wavelet, level):
    fb = jt.get_filter(wavelet)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    done = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
    y = cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, done)
    torch.cuda.synchronize()
    ref = cuda_pyramid.pyramid_rows_torch(x.double(), fb.dec_lo, fb.dec_hi, done)
    assert _rel_err(y, ref) <= F32_BOUND


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
    before = cuda_pyramid.launch_counts["pyramid_rows_transposed"]
    y = cuda_pyramid.pyramid_rows_transposed(x, fb.dec_lo, fb.dec_hi, level, gain)
    torch.cuda.synchronize()
    ref = cuda_pyramid.pyramid_rows_transposed_torch(x.double(), fb.dec_lo, fb.dec_hi, level,
                                                     gain)
    assert tuple(y.shape) == (shape[1], shape[0])
    assert _rel_err(y, ref) <= F32_BOUND
    assert cuda_pyramid.launch_counts["pyramid_rows_transposed"] == before + 1


@pytest.mark.cuda
def test_main_path_routes_through_the_kernels(cuda):
    cuda_modwt.reset_launch_counts()
    cuda_pyramid.reset_launch_counts()
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((8, 4096)),
                        dtype=torch.float32, device=cuda)
    back = jt.imodwt(jt.modwt(x, "Daubechies 4", 5), "Daubechies 4")
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "db4", device="cuda")
    rows = t.get_basic_transform().forward(x)
    img = t.forward(x[:, :512].contiguous().reshape(64, 64))
    torch.cuda.synchronize()
    assert float((back - x).abs().max()) < 1e-4
    assert rows.is_cuda and img.is_cuda
    assert cuda_modwt.launch_counts == {"modwt_cascade": 1, "imodwt_cascade": 1}
    assert cuda_pyramid.launch_counts == {"pyramid_rows": 1, "pyramid_rows_transposed": 2,
                                          "ipyramid_rows_transposed": 0}


def _grad_of(fn, x, w):
    """d/dx sum(fn(x) * w) by autograd."""
    x = x.detach().requires_grad_()
    return torch.autograd.grad((fn(x) * w).sum(), x)[0]


def _routes(op, wavelet, shape, levels):
    """(the public entry, the same operator on the wrappers, which run the
    kernels' plain versions on CPU tensors) and the module and key of the
    kernel the backward launches."""
    fb = jt.get_filter(wavelet)
    g0, h0 = _modwt_base_filters(wavelet)

    def done(n, lvl):
        return cuda_pyramid.levels_done(n, fb.transform_wavelength, lvl)

    if op == "modwt":
        return (lambda a: jt.modwt(a, wavelet, levels),
                lambda a: cuda_modwt.modwt_cascade(a, g0, h0, levels),
                (cuda_modwt, "imodwt_cascade"))
    if op == "imodwt":
        return (lambda a: jt.imodwt(a, wavelet), lambda a: cuda_modwt.imodwt_cascade(a, g0, h0),
                (cuda_modwt, "modwt_cascade"))
    if op == "fwt":
        return (lambda a: jt.fwt(a, wavelet, levels),
                lambda a: cuda_pyramid.pyramid_rows(a, fb.dec_lo, fb.dec_hi,
                                                    done(shape[1], levels)), None)
    lr, lc = levels
    if op == "fwt2d":
        def plain(a):
            y = cuda_pyramid.pyramid_rows_transposed(a, fb.dec_lo, fb.dec_hi, done(shape[1], lc))
            return cuda_pyramid.pyramid_rows_transposed(y, fb.dec_lo, fb.dec_hi,
                                                        done(shape[0], lr))
        return (lambda a: jt.fwt2d(a, wavelet, lr, lc), plain,
                (cuda_pyramid, "ipyramid_rows_transposed"))
    args = (fb.rec_lo, fb.rec_hi, fb.recon_gain)

    def plain(a):
        y = cuda_pyramid.ipyramid_rows_transposed(a, *args, done(shape[1], lc))
        return cuda_pyramid.ipyramid_rows_transposed(y, *args, done(shape[0], lr))
    return (lambda a: jt.ifwt2d(a, wavelet, lr, lc), plain,
            (cuda_pyramid, "pyramid_rows_transposed"))


@pytest.mark.cuda
@pytest.mark.parametrize("op,wavelet,shape,levels", [
    ("modwt", "db4", (8, 4096), 5), ("modwt", "Haar", (4, 8192), 13),
    ("imodwt", "db4", (8, 6, 4096), 5), ("fwt", "db4", (8, 65536), 8),
    ("fwt", "Battle 23", (8, 1024), 10), ("fwt2d", "db4", (256, 1024), (3, 5)),
    ("fwt2d", "Haar orthogonal", (128, 64), (5, 2)), ("ifwt2d", "db4", (256, 1024), (3, 5)),
    ("ifwt2d", "Haar orthogonal", (256, 256), (6, 6)),
])
def test_kernel_gradients_match_plain(cuda, op, wavelet, shape, levels):
    """Gradients of the entry points through K1-K5 on CUDA f32 against the
    same operators on the plain versions in float64; bound 1e-5 of max|ref|.
    The backward launches the adjoint kernel: modwt's K2, imodwt's K1,
    fwt2d's K5, ifwt2d's K4 (fwt's adjoint is the plain butterflies)."""
    rng = np.random.default_rng(4)
    entry, plain, launched = _routes(op, wavelet, shape, levels)
    x = torch.tensor(rng.standard_normal(shape))
    with torch.no_grad():
        w = torch.tensor(rng.standard_normal(tuple(plain(x).shape)))
    before = launched[0].launch_counts[launched[1]] if launched else 0
    g = _grad_of(entry, x.to(cuda, torch.float32), w.to(cuda, torch.float32))
    torch.cuda.synchronize()
    assert g.is_cuda and g.dtype == torch.float32 and tuple(g.shape) == shape
    assert _rel_err(g.cpu(), _grad_of(plain, x, w)) <= F32_BOUND
    if launched:
        assert launched[0].launch_counts[launched[1]] >= before + 1


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
    before = cuda_pyramid.launch_counts["ipyramid_rows_transposed"]
    got = cuda_pyramid.ipyramid_rows_transposed(y, fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
    torch.cuda.synchronize()
    ref = cuda_pyramid.ipyramid_rows_transposed_torch(y.double(), fb.rec_lo, fb.rec_hi,
                                                      fb.recon_gain, done)
    assert tuple(got.shape) == (shape[1], shape[0])
    assert _rel_err(got, ref) <= F32_BOUND
    assert cuda_pyramid.launch_counts["ipyramid_rows_transposed"] == before + 1
    if shape[0] & (shape[0] - 1):
        return  # fwt2d and ifwt2d take power-of-two extents only
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    lr = min(level, shape[0].bit_length() - 1)
    back = jt.ifwt2d(jt.fwt2d(x, wavelet, lr, level), wavelet, lr, level)
    torch.cuda.synchronize()
    ref2 = jt.ifwt2d(jt.fwt2d(x.double(), wavelet, lr, level), wavelet, lr, level)
    assert _rel_err(back, ref2) <= F32_BOUND
    assert cuda_pyramid.launch_counts["ipyramid_rows_transposed"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("g,s,n,k,lo,hi", [
    (8, 64, 65536, 64, -3, 67), (2, 12, 300, 20, -3, 23), (3, 16, 1000, 200, -3, 203),
])
def test_k6_matches_plain(cuda, g, s, n, k, lo, hi):
    rng = np.random.default_rng(7)
    c = torch.as_tensor(rng.standard_normal((g, s, n)) + 1j * rng.standard_normal((g, s, n)),
                        dtype=torch.complex64, device=cuda)
    kk = torch.as_tensor(rng.integers(lo, hi + 1, (g, s, n)), dtype=torch.int32, device=cuda)
    before = cuda_reassign.launch_counts["reassign"]
    got = cuda_reassign.reassign(c, kk, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.complex64 and tuple(got.shape) == (g, k, n)
    ref = cuda_reassign.reassign_torch(c.to(torch.complex128), kk, k)
    assert _rel_err(torch.view_as_real(got), torch.view_as_real(ref)) <= F32_BOUND
    assert cuda_reassign.launch_counts["reassign"] == before + 1


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
    cuda_reassign.reset_launch_counts()
    cuda_pyramid.reset_launch_counts()
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
    assert cuda_reassign.launch_counts == {"reassign": 1}
    assert cuda_pyramid.launch_counts["ipyramid_rows_transposed"] == 2


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
    (256, 62, 5, [(1, 5, True)], [(1, 5, True)]),
    (777, 8, 9, [(1, 9, True)], [(1, 8, True), (9, 9, True)]),
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


@pytest.mark.parametrize("which", ["K1", "K2", "K3", "K4", "K5", "K6"])
def test_cpu_tensors_take_the_plain_version(which, rng):
    cuda_modwt.reset_launch_counts()
    cuda_pyramid.reset_launch_counts()
    cuda_reassign.reset_launch_counts()
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
    else:
        c = torch.complex(x, x.flip(-1))
        k = torch.tensor(rng.integers(-1, 6, (4, 256)), dtype=torch.int32)
        got, want = cuda_reassign.reassign(c, k, 5), cuda_reassign.reassign_torch(c, k, 5)
    assert torch.equal(got, want)
    assert not any(cuda_modwt.launch_counts.values())
    assert not any(cuda_pyramid.launch_counts.values())
    assert not any(cuda_reassign.launch_counts.values())
