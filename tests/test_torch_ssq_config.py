"""The synchrosqueezed Morlet CWT of the benchmark's configuration
``cwt-morlet-64`` (Morlet(6.0) as ``MorletWavelet(1, 6 / 2 pi)``, log-spaced
scales of 4 to 1024 samples, one bin a scale) at small sizes: ``ssq_cwt``
against the benchmark's plain reference (``benchmark/reference/ssq.py``)
under the cell's three numbers and limits, the working set cut into chunks
of rows against the one-shot call, and the device constants kept between
calls.

Tests marked ``cuda`` need a card and skip without one. Run them there with

    python -m pytest tests/test_torch_ssq_config.py -m cuda --noconftest -o addopts=''
"""
import importlib
import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_reassign  # noqa: E402
from jwave_tpu_torch.utils import profiling  # noqa: E402

from benchmark.entries.ssq_cwt import DELTA, SSQErr  # noqa: E402
from benchmark.reference import ssq as ref  # noqa: E402
from benchmark.reference.precision import TF32  # noqa: E402

# the modules (the package's names ``cwt`` and ``ssq`` are the functions)
tcwt = importlib.import_module("jwave_tpu_torch.transforms.cwt")
tssq = importlib.import_module("jwave_tpu_torch.transforms.ssq")
ROOT = Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "benchmark" / "limits" / "cwt-morlet-64.ssq-32x1M.json").read_text())
FB, FC = 1.0, 6.0 / (2.0 * math.pi)


def _scales(num):
    return ref.log_scales(4.0, 1024.0, num).numpy()


def _chirps(rows, n, seed, device="cpu"):
    """Linear chirps between fc/512 and fc/8 cycles a sample, random phase,
    in white noise at 10 dB SNR, float32: the cell's input at another size."""
    g = torch.Generator().manual_seed(seed)
    f = torch.exp(math.log(FC / 512) + math.log(64) * torch.rand((rows, 2), generator=g,
                                                                 dtype=torch.float64))
    t = torch.arange(n, dtype=torch.float64)
    phase = 2 * math.pi * torch.rand((rows, 1), generator=g, dtype=torch.float64)
    x = torch.cos(2 * math.pi * (f[:, :1] * t + (f[:, 1:] - f[:, :1]) * t * t / (2 * n)) + phase)
    x += math.sqrt(0.05) * torch.randn((rows, n), generator=g, dtype=torch.float64)
    return x.float().to(device)


def _morlet():
    return jt.MorletWavelet(FB, FC)


def _builds():
    return profiling.counts().get("ssq.constant_builds", 0)


@pytest.fixture(autouse=True)
def fresh_constants():
    tcwt._CONSTANTS.clear()
    yield
    tcwt._CONSTANTS.clear()


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
def test_ssq_cwt_keeps_to_the_cells_limits_against_the_reference(seed):
    x, sc = _chirps(3, 4096, seed), _scales(16)
    got = jt.ssq_cwt(x, sc, _morlet(), 1.0, frequencies=16)
    assert got.Tx.dtype == torch.complex64 and tuple(got.Tx.shape) == (3, 16, 4096)
    err = SSQErr().add(got.Tx, ref.ssq(x, sc, FB, FC, 1.0, 16, delta=DELTA)).values()
    assert all(err[k] <= LIMITS[k] for k in LIMITS), err
    # with no error allowed nothing is undecided
    want = ref.ssq(x, sc, FB, FC, 1.0, 16)
    assert not want.slack.any() and not want.slack_sum.any()


@pytest.mark.parametrize("prec", [TF32, ref.BF16], ids=lambda p: p.name)
def test_the_reference_in_a_lower_precision_fails_the_limits(prec):
    x, sc = _chirps(2, 4096, 5), _scales(16)
    want = ref.ssq(x, sc, FB, FC, 1.0, 16, delta=DELTA)
    err = SSQErr().add(ref.ssq(x, sc, FB, FC, 1.0, 16, prec=prec).tx, want).values()
    assert all(err[k] > LIMITS[k] for k in LIMITS), err


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
@pytest.mark.parametrize("reassign", ["auto", "scatter", "dense", "pallas"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunks_of_rows_equal_the_one_shot_call(monkeypatch, lead, reassign, dtype):
    """The threshold is per signal and pocketfft's transform of a row does
    not depend on the rows beside it, so on the CPU the chunked call equals
    the one-shot call to the bit."""
    rows = math.prod(lead)
    x, sc = _chirps(rows, 2048, 3).to(dtype).reshape(lead + (2048,)), _scales(16)
    one = jt.ssq_cwt(x, sc, _morlet(), 1.0, reassign=reassign)
    row = tssq._row_bytes(16, 2048, 2048, 16, x.element_size())
    monkeypatch.setattr(tssq, "_memory_budget", lambda device: 2 * row)
    before = profiling.counts().get("ssq.chunks", 0)
    many = jt.ssq_cwt(x, sc, _morlet(), 1.0, reassign=reassign)
    assert profiling.counts()["ssq.chunks"] - before == math.ceil(rows / 2)
    assert many.Tx.dtype == one.Tx.dtype and many.Tx.shape == one.Tx.shape
    assert torch.equal(many.Tx, one.Tx)
    with_gamma = jt.ssq_cwt(x, sc, _morlet(), 1.0, gamma=0.05, reassign=reassign)
    monkeypatch.undo()
    assert torch.equal(with_gamma.Tx, jt.ssq_cwt(x, sc, _morlet(), 1.0, gamma=0.05,
                                                  reassign=reassign).Tx)


def test_the_chunk_plan_by_hand():
    # the cell: 64 scales and bins on 2^20 samples, float32: 4 GiB a row, the
    # phase transform's peak (1 GiB of W and dW, 2 GiB of temporaries, 1 GiB
    # of a plain route's plane) over the inverse FFT's (3 GiB + 8 MiB)
    row = tssq._row_bytes(64, 2**20, 2**20, 64, 4)
    assert row == 4 * 2**30
    # an 80 GB card (85.0e9 bytes in all): an eighth holds 2 rows, 16 chunks of 2
    assert tssq._chunk_rows(32, row, int(tssq.CHUNK_SHARE * 85_017_493_504)) == 2
    assert tssq._chunk_rows(32, row, 3 * row) == 3  # 11 chunks: 10 of 3, one of 2
    assert tssq._chunk_rows(10, row, 3 * row) == 3  # 4 chunks, no chunk of 1 beside 3s
    assert tssq._chunk_rows(7, row, 100 * row) == 7
    assert tssq._chunk_rows(5, row, row // 2) == 1  # a row that exceeds the budget runs alone
    assert tssq._chunk_rows(0, row, row) == 1


def test_a_warm_call_builds_nothing_and_a_different_wavelet_gets_its_own_bank(monkeypatch):
    x, sc = _chirps(2, 1024, 4), _scales(16)
    b0 = _builds()
    first = jt.ssq_cwt(x, sc, _morlet(), 1.0)
    assert _builds() == b0 + 1

    def boom(*args, **kwargs):
        raise AssertionError("a warm call built a constant")

    monkeypatch.setattr(tssq, "_scaled_bank", boom)
    monkeypatch.setattr(tssq, "_omega_axis", boom)
    again = jt.ssq_cwt(x, sc, jt.MorletWavelet(FB, FC), 1.0)  # another object, the same values
    assert _builds() == b0 + 1 and torch.equal(again.Tx, first.Tx)
    monkeypatch.undo()
    # two Morlets that differ in fc alone, or in fb alone, key apart
    assert tcwt._wavelet_key(jt.MorletWavelet(1, 1)) != tcwt._wavelet_key(jt.MorletWavelet(1, 2))
    assert tcwt._wavelet_key(jt.MorletWavelet(1, 1)) != tcwt._wavelet_key(jt.MorletWavelet(2, 1))
    other = jt.ssq_cwt(x, sc, jt.MorletWavelet(FB, 2 * FC), 1.0)
    assert _builds() == b0 + 2
    banks = [v.stacked for k, v in tcwt._CONSTANTS.items() if k[0] == "ssq"]
    assert len(banks) == 2 and not torch.equal(banks[0], banks[1])
    tcwt._CONSTANTS.clear()
    fresh = jt.ssq_cwt(x, sc, jt.MorletWavelet(FB, 2 * FC), 1.0)
    assert torch.equal(fresh.Tx, other.Tx) and not torch.equal(other.Tx, first.Tx)
    # a result's grids are its own: writing to them leaves the cache as it was
    first.frequencies.zero_()
    assert float(jt.ssq_cwt(x, sc, _morlet(), 1.0).frequencies.min()) > 0


def test_cwt_keeps_its_bank_too_and_the_cache_stays_bounded(monkeypatch):
    x = _chirps(2, 1024, 6)
    builds = profiling.counts().get("cwt.constant_builds", 0)
    want = jt.cwt(x, _scales(8), _morlet(), 1.0).coefficients
    assert profiling.counts()["cwt.constant_builds"] == builds + 1
    assert torch.equal(jt.cwt(x, _scales(8), _morlet(), 1.0).coefficients, want)
    assert profiling.counts()["cwt.constant_builds"] == builds + 1
    for num in range(9, 9 + 2 * tcwt.CONSTANTS_MAX):
        jt.cwt(x, _scales(num), _morlet(), 1.0)
    assert len(tcwt._CONSTANTS) == tcwt.CONSTANTS_MAX


# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 and the device constants live only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(8, 2**16), (8, 2**20)])
def test_card_chunks_agree_with_the_one_shot_call(card, monkeypatch, rows, n):
    """cuFFT may plan a batch of rows otherwise than a smaller one, so the
    chunked and one-shot calls may differ in rounding, and a coefficient
    within rounding of a bin edge may then land in the neighbouring bin:
    each is held to the reference under the cell's limits instead, and
    where the plans agree the two are equal to the bit."""
    x, sc = _chirps(rows, n, 11, card), _scales(64)
    one = jt.ssq_cwt(x, sc, _morlet(), 1.0)
    row = tssq._row_bytes(64, n, n, 64, 4)
    monkeypatch.setattr(tssq, "_memory_budget", lambda device: 3 * row)
    cuda_reassign.reset_launch_counts()
    many = jt.ssq_cwt(x, sc, _morlet(), 1.0)
    torch.cuda.synchronize()
    assert cuda_reassign.launch_counts["reassign"] == 3  # chunks of 3, 3 and 2 rows
    for got in (one, many):
        err = SSQErr()
        for r in range(rows):
            err.add(got.Tx[r:r + 1], ref.ssq(x[r:r + 1], sc, FB, FC, 1.0, 64, delta=DELTA))
        assert all(v <= LIMITS[k] for k, v in err.values().items()), err.values()


@pytest.mark.cuda
def test_k6_writes_into_the_given_output(card):
    g, s, n, k = 4, 64, 65536, 64
    gen = torch.Generator(device=card).manual_seed(3)
    c = torch.randn((g, s, n), generator=gen, device=card, dtype=torch.complex64)
    kk = torch.randint(-3, k + 3, (g, s, n), generator=gen, device=card, dtype=torch.int32)
    out = torch.full((g + 2, k, n), float("nan"), dtype=torch.complex64, device=card)
    got = cuda_reassign.reassign(c, kk, k, out=out[1:g + 1])
    torch.cuda.synchronize()
    assert got.data_ptr() == out[1].data_ptr()
    want = cuda_reassign.reassign_torch(c.to(torch.complex128), kk, k)
    err = float((out[1:g + 1].to(torch.complex128) - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())
    assert bool(torch.isnan(out[0].real).all()) and bool(torch.isnan(out[g + 1].real).all())
    assert torch.equal(cuda_reassign.reassign(c, kk, k), out[1:g + 1])
    for bad in (out[:g, :k - 1], out[1:g + 1].transpose(-1, -2).contiguous().transpose(-1, -2),
                torch.empty((g, k, n), dtype=torch.complex128, device=card)):
        with pytest.raises(jt.JWaveFailure, match="out must be"):
            cuda_reassign.reassign(c, kk, k, out=bad)


@pytest.mark.cuda
def test_card_warm_call_builds_uploads_and_syncs_nothing(card):
    x, sc = _chirps(8, 2**16, 12, card), _scales(64)
    jt.ssq_cwt(x, sc, _morlet(), 1.0)  # cold: the constants built and uploaded
    torch.cuda.synchronize()
    before = profiling.counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = jt.ssq_cwt(x, sc, _morlet(), 1.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = profiling.counts()
    assert after["ssq.constant_builds"] == before["ssq.constant_builds"]
    assert after["upload.calls"] == before["upload.calls"]
    assert after["launch.K6"] == before["launch.K6"] + 1
    assert res.Tx.is_cuda and res.frequencies.is_cuda and res.scales.is_cuda
