"""The jwave_tpu_torch facade against jwave_tpu's, and the slice whole: the
step of __graft_entry__.entry() (MODWT db4 L5 then its inverse on a batched
float32 signal) through both packages on the same input."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import jwave_tpu as jw  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402

from torch_parity import assert_close  # noqa: E402


def test_haar_fwt_of_ones():
    """Reference demo: the Haar FWT of ones(16) is [4, 0, ...] and reverses to ones."""
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "Haar", device="cpu")
    y = t.forward(np.ones(16))
    assert y.device.type == "cpu"
    want = np.zeros(16)
    want[0] = 4.0
    assert_close(y, want, 1e-12, "forward")
    assert_close(t.reverse(y), np.ones(16), 1e-12, "reverse")


def test_modwt_db4_round_trip(rng):
    m = jt.MODWTTransform("db4", device="cpu")
    sig = rng.standard_normal(777)
    c = m.forward_modwt(sig, 4)
    assert tuple(c.shape) == (5, 777)
    assert_close(c, jw.MODWTTransform("db4").forward_modwt(sig, 4), 1e-12, "coefficients")
    assert_close(m.inverse_modwt(c), sig, 1e-12, "round trip")
    assert tuple(m.inverse_modwt(torch.zeros((3, 0, 5))).shape) == (3, 0)
    assert tuple(m.inverse_modwt(None).shape) == (0,)


@pytest.mark.parametrize("shape", [(1024,), (64, 128), (8, 16, 32)])
def test_builder_fwt_matches_jax_facade(shape, rng):
    x = rng.standard_normal(shape)
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "db4", device="cpu")
    tj = jw.TransformBuilder.create("Fast Wavelet Transform", "db4")
    y = t.forward(x)
    assert_close(y, tj.forward(x), 1e-12, "forward")
    assert_close(t.reverse(y), tj.reverse(np.asarray(y)), 1e-12, "reverse")
    assert_close(t.reverse(y), x, 1e-10, "round trip")


def test_builder_levels_and_modwt_facade(rng):
    x = rng.standard_normal((64, 128))
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "sym8", device="cpu")
    tj = jw.TransformBuilder.create("Fast Wavelet Transform", "sym8")
    assert_close(t.forward(x, 2, 3), tj.forward(x, 2, 3), 1e-12, "2D levels")
    assert_close(t.decompose(x[0]), tj.decompose(x[0]), 1e-12, "decompose")
    m = jt.TransformBuilder.create("MODWT", "db4", device="cpu")
    mj = jw.TransformBuilder.create("MODWT", "db4")
    s = rng.standard_normal(256)
    assert_close(m.forward(s), mj.forward(s), 1e-12, "flattened modwt")
    assert_close(m.reverse(m.forward(s)), s, 1e-12, "flattened round trip")
    assert jt.TransformBuilder.identify(m) == jw.TransformBuilder.identify(mj)
    assert jt.TransformBuilder.identify(t) == "Fast Wavelet Transform"


def test_complex_input_bridges(rng):
    z = rng.standard_normal(32) + 1j * rng.standard_normal(32)
    b = jt.FastWaveletTransform("db4")
    got = b.forward(torch.tensor(z))
    assert_close(got, jw.FastWaveletTransform("db4").forward(z), 1e-12, "complex forward")
    assert_close(b.reverse(got), z, 1e-10, "complex round trip")


def test_unported_transform_names_raise():
    """Every name of the JAX package's builder is ported now: an unknown name
    raises JWaveNotKnown with the JAX package's message."""
    with pytest.raises(jw.JWaveNotKnown) as ej:
        jw.TransformBuilder.create("nope", "db4")
    with pytest.raises(jt.JWaveNotKnown) as et:
        jt.TransformBuilder.create("nope", "db4")
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("entry", ["as_tensor", "modwt", "facade", "SlidingState.from_numpy",
                                   "wpt", "lifting_fwt", "dtcwt", "aed facade",
                                   "BestBasis.from_numpy", "DTCWTResult.from_numpy",
                                   "Line.to_torch", "compress", "scattering1d",
                                   "scattering2d"])
def test_numpy_input_goes_to_the_card_by_default(entry):
    """Numpy input with no ``device`` becomes a tensor on "cuda". Without a
    card that raises torch's own error: nothing quietly runs on the CPU."""
    from jwave_tpu_torch.utils.host import as_tensor

    x = np.ones(16)
    calls = {
        "as_tensor": lambda: as_tensor(x),
        "modwt": lambda: jt.modwt(x, "db4", 2),
        "facade": lambda: jt.TransformBuilder.create("Fast Wavelet Transform", "Haar").forward(x),
        "SlidingState.from_numpy":
            lambda: jt.SlidingState.from_numpy([x[:7]], np.ones((2, 16)), x).coeffs,
        "wpt": lambda: jt.wpt(x, "db4", 2),
        "lifting_fwt": lambda: jt.lifting_fwt(x),
        "dtcwt": lambda: jt.dtcwt(x, 2).lowpasses,
        "aed facade": lambda: jt.TransformBuilder.create(
            "Ancient Egyptian Decomposition Wavelet Packet Transform").forward(np.ones(12)),
        "BestBasis.from_numpy":
            lambda: jt.BestBasis.from_numpy([(0, 0)], [x], 1.0, 16, "Haar").coefficients[0],
        "DTCWTResult.from_numpy": lambda: jt.DTCWTResult.from_numpy([x[:8] + 0j], np.ones((2, 8)))
        .lowpasses,
        "Line.to_torch": lambda: jt.Line(16).alloc().to_torch(),
        "compress": lambda: jt.CompressorMagnitude().compress(x),
        "scattering1d": lambda: jt.scattering1d(x, 2).S1,
        "scattering2d": lambda: jt.scattering2d(np.ones((16, 16)), 2).S1,
    }
    if torch.cuda.is_available():
        assert calls[entry]().is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            calls[entry]()


def test_device_argument():
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "Haar", device="meta")
    assert t.get_basic_transform().device.type == "meta"
    cpu = torch.ones(8)
    assert jt.fwt(cpu, "Haar").device.type == "cpu"


def test_wrappers_raise_instead_of_falling_back():
    """A tensor that is neither on the CPU nor on CUDA reaches no plain path."""
    from jwave_tpu_torch.ops import cuda_modwt, cuda_pyramid

    g0, h0 = np.ones(2) / 2, np.ones(2) / 2
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(jt.JWaveFailure):
        cuda_modwt.modwt_cascade(x, g0, h0, 2)
    with pytest.raises(jt.JWaveFailure):
        cuda_modwt.imodwt_cascade(torch.empty((2, 3, 64), device="meta"), g0, h0)
    with pytest.raises(jt.JWaveFailure):
        cuda_pyramid.pyramid_rows(x, g0, h0, 2)
    with pytest.raises(jt.JWaveFailure):
        cuda_pyramid.pyramid_rows_transposed(x, g0, h0, 2)
    with pytest.raises(jt.JWaveFailure):
        cuda_pyramid.ipyramid_rows_transposed(x, g0, h0, 1.0, 2)
    from jwave_tpu_torch.ops import cuda_reassign

    with pytest.raises(jt.JWaveFailure):
        cuda_reassign.reassign(torch.empty((3, 64), dtype=torch.complex64, device="meta"),
                               torch.empty((3, 64), dtype=torch.int32, device="meta"), 4)


def test_slice_whole_matches_entry():
    """__graft_entry__.entry()'s step through JAX against the port on the same
    (8, 4096) float32 input. Both run f32 (FFT cascade on the CPU; the f32
    roundoff of two different FFT libraries), so the bound is 1e-5 of the
    largest value for the coefficients and 1e-5 absolute on the
    reconstruction of a unit-variance signal."""
    import __graft_entry__ as entry_mod

    fn, (x_j,) = entry_mod.entry()
    back_j, coeffs_j = jax.jit(fn)(x_j)
    x = np.asarray(x_j)
    assert x.dtype == np.float32 and x.shape == (8, 4096)
    coeffs = jt.modwt(torch.tensor(x), "Daubechies 4", 5)
    back = jt.imodwt(coeffs, "Daubechies 4")
    assert coeffs.dtype == torch.float32 and tuple(coeffs.shape) == (8, 6, 4096)
    assert_close(coeffs, np.asarray(coeffs_j, dtype=np.float64), 1e-5, "coefficients")
    assert_close(back, np.asarray(back_j, dtype=np.float64), 1e-5, "reconstruction")
    assert_close(back, x.astype(np.float64), 1e-5, "round trip")
    # the cascade kernels' plain versions on the same input agree as well
    c2 = jt.modwt(torch.tensor(x), "Daubechies 4", 5, method=jt.ConvolutionMethod.PALLAS)
    assert_close(c2, np.asarray(coeffs_j, dtype=np.float64), 1e-5, "cascade coefficients")
    b2 = jt.imodwt(c2, "Daubechies 4", method=jt.ConvolutionMethod.PALLAS)
    assert_close(b2, x.astype(np.float64), 1e-5, "cascade round trip")


def test_public_names_are_the_jax_packages_but_scattering():
    """Every public name of the JAX package, the six scattering names (the
    last to be ported) included."""
    assert set(jw.__all__) - set(dir(jt)) == set()
    assert {"scattering1d", "scattering_filter_bank", "ScatteringResult", "scattering2d",
            "scattering_filter_bank_2d", "Scattering2DResult"} <= set(jt.__all__)
    assert set(jt.__all__) <= set(dir(jt))


def test_transforms_exports_are_the_jax_packages():
    """``jwave_tpu_torch.transforms`` exports the JAX subpackage's list, the
    complex bridges ``forward_complex``/``reverse_complex`` included."""
    import jwave_tpu.transforms as jwt
    import jwave_tpu_torch.transforms as jtt

    assert set(jwt.__all__) == set(jtt.__all__)
    assert set(jtt.__all__) <= set(dir(jtt))


def test_fresh_import_keeps_torch_switches_and_dials_highest():
    """Importing the port sets no torch switch; its own dial starts at
    'highest', the JAX package's default."""
    code = (
        "import torch\n"
        "before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,\n"
        "          torch.get_float32_matmul_precision())\n"
        "import jwave_tpu_torch as jt\n"
        "after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,\n"
        "         torch.get_float32_matmul_precision())\n"
        "assert before == after == (True, False, 'highest'), (before, after)\n"
        "assert jt.config.conv_precision() == 'highest'\n"
        "print('ok')\n")
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _spy_on(monkeypatch, module, name):
    """Wrap ``module.name`` so that each call records the TF32 switches."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("site", ["butterfly_forward", "butterfly_reverse", "circular_conv",
                                  "wpt_fused_forward", "wpt_fused_inverse", "sliding", "dft"])
def test_convolutions_run_under_the_dial(site, monkeypatch):
    """True float32 inside every convolution and matmul of the port by
    default; TF32 after set_conv_precision('high'); torch's own switches as
    they were after each call."""
    from jwave_tpu_torch.ops import butterfly, circular, composite

    fb = jt.get_filter("db4")
    x = torch.ones(2, 64, dtype=torch.float32)
    calls = {
        "butterfly_forward": ("conv1d", lambda: butterfly.butterfly_forward(
            x, fb.dec_lo, fb.dec_hi)),
        "butterfly_reverse": ("conv1d", lambda: butterfly.butterfly_reverse(
            x, fb.rec_lo, fb.rec_hi)),
        "circular_conv": ("conv1d", lambda: circular.circular_conv(x, fb.dec_lo)),
        "wpt_fused_forward": ("conv1d", lambda: composite.wpt_fused_forward(
            x, fb.dec_lo, fb.dec_hi, 3)),
        "wpt_fused_inverse": ("conv_transpose1d", lambda: composite.wpt_fused_inverse(
            x, fb.rec_lo, fb.rec_hi, 3)),
        "sliding": ("conv1d", lambda: jt.sliding_modwt_update(
            jt.sliding_modwt_init(x, "db4", 2), x[:, :8], "db4", 2)),
        "dft": (None, lambda: jt.transforms.dft(x)),
    }
    fn_name, call = calls[site]
    if fn_name is None:  # the dense DFT: a matmul, seen through the tensor operator
        seen = []
        real = torch.Tensor.__matmul__

        def spy(a, b):
            seen.append((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()))
            return real(a, b)

        monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    else:
        seen = _spy_on(monkeypatch, torch.nn.functional, fn_name)
    before = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    call()
    assert seen and all(s == (False, "highest") for s in seen), seen
    assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == before
    seen.clear()
    try:
        jt.config.set_conv_precision("high")
        call()
        assert seen and all(s == (True, "high") for s in seen), seen
        seen.clear()
        jt.config.set_conv_precision("default")
        call()
        assert seen and all(s == (True, "medium") for s in seen), seen
    finally:
        jt.config.set_conv_precision("highest")
    assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == before
    with pytest.raises(ValueError, match="unknown precision"):
        jt.config.set_conv_precision("fast")


@pytest.fixture
def config_state():
    """Each test's dials are set back to what they were."""
    saved = (jt.config._X64, jt.config.mxu_dft(), jt.config.mxu_butterfly())
    yield
    jt.config._X64 = saved[0]
    jt.config.set_mxu_dft(saved[1])
    jt.config.set_mxu_butterfly(saved[2])


def test_config_has_every_name_of_the_jax_packages():
    import jwave_tpu.config as jcfg

    assert set(dir(jcfg)) - set(dir(jt.config)) == {"jax"}


@pytest.mark.parametrize("dial", ["mxu_dft", "mxu_butterfly"])
def test_mxu_dials_keep_and_validate_their_modes_as_jax(dial, config_state):
    import jwave_tpu.config as jcfg

    get_t, set_t = getattr(jt.config, dial), getattr(jt.config, "set_" + dial)
    get_j, set_j = getattr(jcfg, dial), getattr(jcfg, "set_" + dial)
    assert get_t() == get_j() == "auto"
    saved = get_j()
    try:
        for mode in ("on", "off", "auto"):
            set_t(mode)
            set_j(mode)
            assert get_t() == get_j() == mode
        for bad in ("On", "", "yes", None):
            with pytest.raises(ValueError) as et:
                set_t(bad)
            with pytest.raises(ValueError) as ej:
                set_j(bad)
            assert str(et.value) == str(ej.value)
            assert get_t() == "auto"
    finally:
        set_j(saved)


def test_mxu_dials_select_nothing(config_state, rng):
    """'off' (the JAX package's hatch) and 'on' give the same results."""
    x = torch.as_tensor(rng.standard_normal((2, 256)))
    runs = []
    for mode in ("off", "on"):
        jt.config.set_mxu_dft(mode)
        jt.config.set_mxu_butterfly(mode)
        runs.append((jt.fwt(x, "db4"), jt.wpt(x, "db4", 3),
                     jt.wigner_ville(x, 1.0, n_bins=64)[0]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["modwt", "fwt", "cwt", "wpt", "denoise", "ssq_cwt"])
@pytest.mark.parametrize("dtype", ["int64", "int32", "bool"])
def test_enable_x64_sets_the_dtype_of_integer_input(entry, dtype, config_state):
    """Integer and bool input promotes to float64 under enable_x64() (as in
    the JAX package with x64 on, as the tests run it) and to float32 under
    enable_x64(False); floating input keeps its dtype."""
    a = (np.arange(64) % 7 - 3).astype(dtype)
    scales = jt.generate_log_scales(2.0, 16.0, 4)
    calls = {"modwt": lambda m, v: m.modwt(v, "db4", 2),
             "fwt": lambda m, v: m.fwt(v, "db4"),
             "cwt": lambda m, v: m.cwt(v, scales).coefficients,
             "wpt": lambda m, v: m.wpt(v, "db4", 2),
             "denoise": lambda m, v: m.denoise(v, "db4", 2),
             "ssq_cwt": lambda m, v: m.ssq_cwt(v, scales).Tx}
    call = calls[entry]
    want = np.asarray(call(jw, a))
    jt.config.enable_x64()
    got = call(jt, torch.as_tensor(a))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    # values for int64 (JAX computes some paths of int32 and bool input in
    # float32 before its float64 output); ssq_cwt's bins sit on ties here
    if dtype == "int64" and entry != "ssq_cwt":
        assert_close(got, want, 1e-10, entry)
    jt.config.enable_x64(False)
    assert call(jt, torch.as_tensor(a)).dtype in (torch.float32, torch.complex64)
    assert call(jt, torch.as_tensor(a.astype(np.float64))).dtype in (torch.float64,
                                                                    torch.complex128)


def test_without_enable_x64_integer_input_follows_torchs_default(config_state):
    """Until enable_x64 is called, integer input promotes as before: to
    torch's default dtype."""
    jt.config._X64 = None
    x = torch.arange(32)
    assert jt.fwt(x, "db4").dtype == torch.get_default_dtype()
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        assert jt.fwt(x, "db4").dtype == torch.float64
        assert jt.config.default_complex_dtype() == torch.complex128
    finally:
        torch.set_default_dtype(old)
