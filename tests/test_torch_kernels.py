"""The hand-written CUDA kernels K1-K4 of jwave_tpu_torch.

Tests marked ``cuda`` build and launch the kernels and hold them against
their plain torch versions (run in float64 on the same input); they need a
CUDA card and skip without one. Run them on the card with

    python -m pytest tests/test_torch_kernels.py -m cuda -p no:xdist

The other tests check, on any machine, what surrounds the kernels: the
level grouping of K1/K2, the row blocking of K4, the build's error on a
missing compiler, and that CPU tensors take the plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_build, cuda_modwt, cuda_pyramid  # noqa: E402
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
@pytest.mark.parametrize("shape,wavelet,level", [
    ((2048, 2048), "db4", 6), ((512, 1024), "Haar", 3), ((64, 16384), "sym8", 4),
])
def test_k4_matches_plain(cuda, shape, wavelet, level):
    fb = jt.get_filter(wavelet)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    y = cuda_pyramid.pyramid_rows_transposed(x, fb.dec_lo, fb.dec_hi, level)
    torch.cuda.synchronize()
    ref = cuda_pyramid.pyramid_rows_transposed_torch(x.double(), fb.dec_lo, fb.dec_hi, level)
    assert tuple(y.shape) == (shape[1], shape[0])
    assert _rel_err(y, ref) <= F32_BOUND


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
    assert cuda_pyramid.launch_counts == {"pyramid_rows": 1, "pyramid_rows_transposed": 2}


@pytest.mark.cuda
def test_kernels_refuse_gradients(cuda):
    g0, h0 = _modwt_base_filters("db4")
    x = torch.zeros((2, 256), device=cuda, requires_grad=True)
    with pytest.raises(jt.JWaveFailure, match="gradients"):
        jt.modwt(x, "db4", 3)
    with pytest.raises(jt.JWaveFailure, match="gradients"):
        cuda_modwt.imodwt_cascade(torch.zeros((2, 4, 256), device=cuda, requires_grad=True),
                                  g0, h0)
    with pytest.raises(jt.JWaveFailure, match="gradients"):
        jt.fwt(x, "db4")
    with pytest.raises(jt.JWaveFailure, match="gradients"):
        jt.fwt2d(torch.zeros((64, 64), device=cuda, requires_grad=True), "db4")


# --------------------------------------------------------------------------
# on any machine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,level,want", [
    (65536, 8, 5, [(1, 5, True)]),
    (8192, 2, 13, [(1, 12, True), (13, 13, True)]),
    (20000, 62, 10, [(1, 6, True), (7, 7, True), (8, 8, False), (9, 9, False),
                     (10, 10, False)]),
    (256, 62, 5, [(1, 5, True)]),
])
def test_level_groups(n, m, level, want):
    groups = cuda_modwt.level_groups(n, m, level)
    assert groups == want
    tl = min(cuda_modwt.TILE, n)
    for j0, j1, staged in groups:
        if staged:
            assert tl + (m - 1) * ((1 << j1) - (1 << (j0 - 1))) <= cuda_modwt.BUF_FLOATS


def test_k4_rows_per_block():
    assert cuda_pyramid.k4_rows_per_block(2048) == 8
    assert cuda_pyramid.k4_rows_per_block(16384) == 2
    assert cuda_pyramid.k4_rows_per_block(32768) == 0


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """The build says what is missing; nothing falls back to a plain path."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(jt.JWaveError, match="nvcc"):
        cuda_build.library("modwt")
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.parametrize("which", ["K1", "K2", "K3", "K4"])
def test_cpu_tensors_take_the_plain_version(which, rng):
    cuda_modwt.reset_launch_counts()
    cuda_pyramid.reset_launch_counts()
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
    else:
        got, want = (cuda_pyramid.pyramid_rows_transposed(x, fb.dec_lo, fb.dec_hi, 4),
                     cuda_pyramid.pyramid_rows_transposed_torch(x, fb.dec_lo, fb.dec_hi, 4))
    assert torch.equal(got, want)
    assert not any(cuda_modwt.launch_counts.values())
    assert not any(cuda_pyramid.launch_counts.values())
