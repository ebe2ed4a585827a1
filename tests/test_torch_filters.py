"""jwave_tpu_torch.filters holds the same 67 banks as jwave_tpu.filters, and
importing the port loads neither jax nor jwave_tpu."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu as jw  # noqa: E402
import jwave_tpu.filters as jf  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
import jwave_tpu_torch.filters as tf  # noqa: E402

from torch_parity import assert_close  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def test_same_bank_names():
    assert tf.available_filters() == jf.available_filters()
    assert len(tf.available_filters()) == 67
    assert [fb.name for fb in tf.junit_passing_filters()] == \
        [fb.name for fb in jf.junit_passing_filters()]


@pytest.mark.parametrize("name", jf.available_filters())
def test_bank_equal(name):
    a, b = jf.get_filter(name), tf.get_filter(name)
    for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert getattr(b, f).dtype == np.float64
    for f in ("name", "family", "transform_wavelength", "recon_gain", "in_builder",
              "junit_passing", "length"):
        assert getattr(b, f) == getattr(a, f), f


@pytest.mark.parametrize("alias", sorted(jf._ALIASES))
def test_alias_resolves_alike(alias):
    assert tf.get_filter(alias).name == jf.get_filter(alias).name
    assert tf.get_filter(alias.upper()).name == jf.get_filter(alias).name


def test_unknown_name_raises():
    with pytest.raises(jt.JWaveNotKnown):
        tf.get_filter("dbXX")
    assert issubclass(jt.JWaveNotKnown, jt.JWaveFailure)


@pytest.mark.parametrize("name", ["Daubechies 4", "Battle 23", "Haar orthogonal"])
def test_bank_from_arrays_round_trips(name, rng):
    """A jwave_tpu bank's numpy arrays make a port bank that transforms alike."""
    src = jf.get_filter(name)
    fb = tf.bank_from_arrays("custom", src.dec_lo, src.dec_hi, src.rec_lo, src.rec_hi,
                             src.transform_wavelength, src.recon_gain)
    for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_array_equal(getattr(fb, f), getattr(src, f))
    assert tf.get_filter(fb) is fb
    x = rng.standard_normal((3, 64))
    assert_close(jt.fwt(torch.tensor(x), fb, 4), jw.fwt(x, src, 4), 1e-12, name)
    y = jt.fwt(torch.tensor(x), fb)
    assert_close(jt.ifwt(y, fb), jw.ifwt(jw.fwt(x, src), src), 1e-12, name)


def test_import_leaves_jax_out():
    code = ("import sys, jwave_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jwave_tpu.'))"
            " or m == 'jwave_tpu' or m == 'triton']; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_jax_import_in_sources():
    for path in (REPO / "jwave_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import jwave_tpu ",
                                     "from jwave_tpu ", "from jwave_tpu.")), f"{path}: {s}"


def test_filter_table_is_a_verbatim_copy():
    assert (REPO / "jwave_tpu_torch/filters/data.py").read_bytes() == \
        (REPO / "jwave_tpu/filters/data.py").read_bytes()
