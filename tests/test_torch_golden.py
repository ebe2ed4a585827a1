"""jwave_tpu_torch against the pinned float64 vectors of tests/golden.npz
(made by tools/generate_golden.py from the reference-validated
implementation): every key of the file. The inputs are the
file's own ``x64``, ``x100`` and ``img``. Bound: 1e-12 of max|ref| (the same
operators term by term in float64; the CWT's two FFT libraries agree to
~1e-15 at 64 samples)."""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu_torch as jt  # noqa: E402

GOLDEN = np.load(pathlib.Path(__file__).parent / "golden.npz")
BOUND = 1e-12


def _hold(got, key):
    want = GOLDEN[key]
    got = got.detach().numpy()
    assert got.dtype == np.float64 and got.shape == want.shape, (key, got.dtype, got.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= BOUND * float(np.max(np.abs(want))), f"{key}: max|err| {err:.3e}"


@pytest.mark.parametrize("name", ["Haar", "Daubechies 4", "Symlet 8", "Coiflet 3",
                                  "BiOrthogonal 3/5"])
def test_fwt_golden(name):
    key = "fwt_" + name.replace(" ", "_").replace("/", "_")
    _hold(jt.fwt(torch.tensor(GOLDEN["x64"]), name), key)


def test_modwt_golden():
    _hold(jt.modwt(torch.tensor(GOLDEN["x100"]), "db4", 3), "modwt_db4_L3")


def test_modwt_direct_golden():
    _hold(jt.modwt(torch.tensor(GOLDEN["x100"]), "Haar", 4, method=jt.ConvolutionMethod.DIRECT),
          "modwt_haar_L4_direct")


@pytest.mark.parametrize("part", ["re", "im"])
def test_cwt_golden(part):
    res = jt.cwt(torch.tensor(GOLDEN["x64"]), [2.0, 4.0, 8.0], jt.MorletWavelet(1.0, 1.0), 1.0)
    assert res.coefficients.dtype == torch.complex128
    _hold(res.coefficients.real if part == "re" else res.coefficients.imag,
          f"cwt_morlet_{part}")


def test_fwt2d_golden_through_the_facade():
    t = jt.TransformBuilder.create("Fast Wavelet Transform", "db2", device="cpu")
    _hold(t.forward(GOLDEN["img"]), "fwt2d_db2")


@pytest.mark.parametrize("name", ["Haar", "Daubechies 4", "Symlet 8", "Coiflet 3",
                                  "BiOrthogonal 3/5"])
def test_wpt_golden(name):
    key = "wpt_" + name.replace(" ", "_").replace("/", "_")
    _hold(jt.wpt(torch.tensor(GOLDEN["x64"]), name, 3), key)


def test_aed_golden():
    _hold(jt.aed_forward(torch.tensor(GOLDEN["x100"]), lambda c: jt.fwt(c, "db2")), "aed_db2")


def test_shifting_golden():
    _hold(jt.shifting_forward(torch.tensor(GOLDEN["x100"]), "Haar"), "shifting_haar")


def test_dft_golden():
    """The complex spectrum stored as interleaved (re, im) float64 pairs."""
    z = jt.fft(torch.tensor(GOLDEN["x64"] + 0j))
    assert z.dtype == torch.complex128
    _hold(torch.view_as_real(z).reshape(-1), "dft_x64")


def test_every_key_is_read():
    """The inputs and the keys the tests above hold: all of the file."""
    held = {"x64", "x100", "img", "modwt_db4_L3", "modwt_haar_L4_direct", "cwt_morlet_re",
            "cwt_morlet_im", "fwt2d_db2", "aed_db2", "shifting_haar", "dft_x64"}
    for name in ("Haar", "Daubechies_4", "Symlet_8", "Coiflet_3", "BiOrthogonal_3_5"):
        held |= {f"fwt_{name}", f"wpt_{name}"}
    assert set(GOLDEN.files) == held
