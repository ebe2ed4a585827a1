"""The synchrosqueezed Morlet CWT of the benchmark's configuration
``cwt-morlet-64`` (Morlet(6.0) as ``MorletWavelet(1, 6 / 2 pi)``, log-spaced
scales of 4 to 1024 samples, one bin a scale) at small sizes: ``ssq_cwt``
against the benchmark's plain reference (``benchmark/reference/ssq.py``)
under the cell's three numbers and limits, the working set cut into chunks
of rows against the one-shot call, the device constants kept between
calls, and K6's fused form (the phase transform and bin index inside the
kernel): which blocks take it, its plain version, and on the card the
kernel against the plain path.

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

import numpy as np  # noqa: E402

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch.ops import cuda_reassign  # noqa: E402
from jwave_tpu_torch.utils import profiling  # noqa: E402

from benchmark import harness  # noqa: E402

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


# K6's fused form: the rule, the plain version, the shared bytes
# --------------------------------------------------------------------------

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("reassign,device,cdtype,grad,fused", [
    ("auto", CUDA, torch.complex64, False, True),
    ("pallas", CUDA, torch.complex64, False, True),
    ("auto", CUDA, torch.complex64, True, False),      # a gradient takes K6's autograd path
    ("auto", CUDA, torch.complex128, False, False),    # the scatter form in float64
    ("pallas", CUDA, torch.complex128, False, False),  # cast to complex64, then unfused K6
    ("scatter", CUDA, torch.complex64, False, False),
    ("dense", CUDA, torch.complex64, False, False),
    ("auto", CPU, torch.complex64, False, False),
    ("pallas", CPU, torch.complex64, False, False),    # K6's plain version
    ("auto", CPU, torch.complex128, False, False),
])
def test_the_fused_form_is_taken_by_route_device_dtype_and_gradient(reassign, device, cdtype,
                                                                     grad, fused):
    route = tssq._route(reassign, device, cdtype)
    assert tssq._fused(route, device, cdtype, grad) is fused


def _block(rows=3, n=1500, num=16, seed=8, dtype=torch.float32):
    x, sc = _chirps(rows, n, seed).to(dtype), _scales(num)
    W, dW = tssq._cwt_and_derivative(x, sc, _morlet(), 1.0, jt.PaddingType.SYMMETRIC)
    return W, dW, sc, torch.as_tensor(sc ** -0.5 * tssq._log_measure(sc), dtype=dtype)


def _uneven_grid(sc, k=16):
    """An increasing grid over the scales' frequencies that is not
    log-uniform: the bins are searched by their edges."""
    lo, hi = math.log(FC / sc.max()), math.log(FC / sc.min())
    u = np.linspace(0.0, 1.0, k) ** 1.3
    return np.exp(lo + (hi - lo) * u)


@pytest.mark.parametrize("out_of_range", ["clip", "drop"])
@pytest.mark.parametrize("grid", ["affine", "edges"])
@pytest.mark.parametrize("gamma", [None, 0.02])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_squeeze_torch_is_the_scatter_route_of_the_same_block(out_of_range, grid, gamma, dtype):
    W, dW, sc, wgt = _block(dtype=dtype)
    freqs = tssq._default_bins(sc, FC, 16) if grid == "affine" else _uneven_grid(sc)
    assert (tssq._log_uniform(freqs) is None) == (grid == "edges")
    gamma_abs = tssq._default_gamma(W) if gamma is None else torch.tensor(gamma, dtype=dtype)
    want = tssq._squeeze_plane(W, dW, wgt, freqs, gamma_abs, out_of_range, reassign="scatter")
    got = cuda_reassign.squeeze_torch(W, dW, wgt, gamma, freqs, out_of_range)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert float(got.abs().sum()) > 0


def test_the_default_gamma_is_per_row():
    W, *_ = _block(rows=4)
    W = W * torch.arange(1, 5, dtype=torch.float32)[:, None, None]
    g = tssq._default_gamma(W)
    assert tuple(g.shape) == (4, 1, 1)
    peak = (W.real ** 2 + W.imag ** 2).amax(dim=(-2, -1))
    want = 10.0 * math.sqrt(torch.finfo(torch.float32).eps) * peak.sqrt()
    assert torch.equal(g.flatten(), want)


def test_the_bin_grid_of_the_fused_form():
    sc = _scales(16)
    freqs = tssq._default_bins(sc, FC, 16)
    grid = tssq._bin_grid(freqs, None, CPU)
    assert grid.n_bins == 16 and grid.f_lo == float(freqs[0]) and grid.edges is None
    assert grid.affine == pytest.approx((math.log(freqs[0]), math.log(freqs[1] / freqs[0])))
    uneven = _uneven_grid(sc)
    grid = tssq._bin_grid(uneven, None, CPU)
    assert grid.affine is None and grid.edges.dtype == torch.float32
    assert torch.equal(grid.edges, torch.as_tensor(tssq._bin_edges(uneven), dtype=torch.float32))
    held = torch.zeros(17)
    assert tssq._bin_grid(uneven, held, CPU).edges is held


def test_fused_k6_smem_bytes():
    """``csrc/reassign.cu`` smem_bytes for the fused form by hand: the same
    64-bin plane (65536 B), a ring of 3 stages x 8 s-rows x 128 columns x
    16 B of W and dW (49152 B) and three mbarriers (24 B), whatever the grid
    (a grid's edges are searched in global memory); two blocks still fit an
    SM (228 KB, 1 KB of it reserved a block)."""
    base = 65536 + 49152 + 24
    assert cuda_reassign.k6_smem_bytes(64, fused=True) == base == 114712
    assert cuda_reassign.k6_smem_bytes(200, fused=True) == base  # a chunk of 64 bins a block
    assert cuda_reassign.k6_smem_bytes(20, fused=True) == 20 * 1024 + 49152 + 24
    assert cuda_reassign.k6_smem_bytes(64, fused=False) == 90144  # the unfused form's
    assert 2 * (cuda_reassign.k6_smem_bytes(64, fused=True) + 1024) <= 228 * 1024


def test_the_fused_form_checks_its_input_on_the_cpu():
    W, dW, sc, wgt = _block()
    grid = tssq._bin_grid(tssq._default_bins(sc, FC, 16), None, CPU)
    with pytest.raises(jt.JWaveFailure, match="CUDA"):
        cuda_reassign.squeeze(W, dW, wgt, None, grid, "clip")
    with pytest.raises(jt.JWaveFailure, match="out_of_range"):
        cuda_reassign.squeeze(W, dW, wgt, None, grid, "wrap")
    with pytest.raises(jt.JWaveFailure, match="CUDA"):
        cuda_reassign.row_peaks(W)


@pytest.mark.parametrize("gamma,rows", [(0.5, 3), (torch.tensor(0.25), 3),
                                        (torch.arange(1.0, 4.0)[:, None, None], 3)])
def test_row_threshold_of_a_given_gamma(gamma, rows):
    W = torch.zeros((rows, 4, 8), dtype=torch.complex64)
    t = cuda_reassign.row_threshold(W, gamma)
    assert not t.from_peak and t.values.dtype == torch.float32
    assert torch.equal(t.values, torch.as_tensor(gamma, dtype=torch.float32).expand(rows, 1, 1)
                       .reshape(rows))
    with pytest.raises(jt.JWaveFailure, match="one threshold a row"):
        cuda_reassign.row_threshold(W, torch.ones((rows, 4, 1)))


@pytest.mark.parametrize("reassign", ["auto", "pallas", "scatter"])
def test_no_chunk_fuses_on_the_cpu(reassign):
    before = profiling.counts()["ssq.fused_chunks"]
    jt.ops.reset_launch_counts()
    jt.ssq_cwt(_chirps(2, 1024, 9), _scales(16), _morlet(), 1.0, reassign=reassign)
    assert profiling.counts()["ssq.fused_chunks"] == before
    assert jt.ops.launch_counts()["K6.peak"] == 0 and jt.ops.launch_counts()["K6"] == 0


def test_the_fused_chunks_metric_reads_the_counter(monkeypatch):
    """``benchmark/metrics/fused_chunks.ssq.py``: the median over the
    ``ssq_cwt`` roots of their ``ssq.fused_chunks`` change, and None for a
    program that lists no such counter."""
    import types

    from benchmark import program_spans

    reader = harness.load_reader("per_layer", "fused_chunks.ssq")
    roots = [program_spans.Span("ssq_cwt", None, q, 0.0, 1.0, {}, c)
             for q, c in enumerate(({"ssq.fused_chunks": 16}, {"ssq.fused_chunks": 16},
                                    {"ssq.chunks": 16}))]
    monkeypatch.setattr(program_spans, "records", lambda run: roots)
    run = types.SimpleNamespace()
    assert reader.read(run) == 16
    assert "ssq.fused_chunks" in profiling.counts()
    monkeypatch.setattr(program_spans, "_profiling",
                        lambda: types.SimpleNamespace(counts=lambda: {"ssq.chunks": 3}))
    assert reader.read(run) is None
    monkeypatch.setattr(program_spans, "_profiling", lambda: None)
    assert reader.read(run) is None


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
    jt.ops.reset_launch_counts()
    many = jt.ssq_cwt(x, sc, _morlet(), 1.0)
    torch.cuda.synchronize()
    assert jt.ops.launch_counts()["K6"] == 3  # chunks of 3, 3 and 2 rows
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
    # the fused form, with the peak kernel for the default threshold
    assert after["ssq.fused_chunks"] == before["ssq.fused_chunks"] + 1
    peaks = jt.ops.launch_counts()["K6.peak"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        jt.ssq_cwt(x, sc, _morlet(), 1.0, gamma=0.05)  # a given threshold: no peak kernel
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert profiling.counts()["upload.calls"] == before["upload.calls"]
    assert jt.ops.launch_counts()["K6.peak"] == peaks


def _plain_on_the_card(W, dW, wgt, gamma, freqs, out_of_range):
    """``_reassign_inputs`` (eager) then the unfused K6 on the same block:
    the plane, the contributions and the indices."""
    gamma_abs = tssq._default_gamma(W) if gamma is None else torch.as_tensor(
        gamma, dtype=torch.float32, device=W.device)
    contrib, k = tssq._reassign_inputs(W, dW, wgt, freqs, gamma_abs, out_of_range)
    return cuda_reassign.reassign(contrib, k, len(freqs)), contrib, k


def _fused_against_plain(got, want, contrib, k, n_bins):
    """flip_share (the moved weight over twice the kept weight) and
    conserve_err (the largest column-sum difference over the largest column
    sum) of the fused plane against the plain one."""
    d = (got.to(torch.complex128) - want.to(torch.complex128)).abs()
    kept = float(torch.where(k < n_bins, contrib.abs(), 0).double().sum())
    col = (got.to(torch.complex128).sum(dim=-2) - want.to(torch.complex128).sum(dim=-2)).abs()
    scale = float(want.to(torch.complex128).sum(dim=-2).abs().max())
    flip = float(d.sum()) / (2 * kept) if kept else float(d.sum())
    conserve = float(col.max()) / scale if scale else float(col.max())
    return flip, conserve


_FUSED_CASES = {
    # label: rows, n, scales, bins (an int: log-uniform; "uneven": edges), out_of_range, gamma
    "the cell's chunk 2x64x2^20": (2, 2**20, 64, 64, "clip", None),
    "8x64x65536": (8, 2**16, 64, 64, "clip", None),
    "ragged n 3001 (n % 4 != 0, n < P)": (3, 3001, 64, 64, "clip", None),
    "n 49152 < P 65536 (a strided view, whole tiles)": (2, 49152, 64, 64, "clip", None),
    "128 bins (two bin chunks)": (2, 2**16, 64, 128, "clip", None),
    "drop": (4, 2**16, 64, 64, "drop", None),
    "uneven grid (edges)": (2, 2**16, 64, "uneven", "clip", None),
    "uneven grid, drop": (2, 2**16, 64, "uneven", "drop", None),
    "a given gamma": (4, 2**16, 64, 64, "clip", 0.05),
    "S 13 (not a multiple of a stage's rows)": (2, 8192, 13, 20, "clip", None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(_FUSED_CASES))
def test_card_fused_k6_agrees_with_the_plain_path(card, label):
    """The fused form computes each bin with the roundings of torch's eager
    kernels, and both forms add a column in ascending s, so the planes are
    equal wherever the bins are. Where a rounding of the eager path is one
    its compiler chose (a contracted product, a reciprocal), a frequency
    within an ulp of a bin edge may land in the neighbour bin: its
    contribution then moves between two bins, which flip_share counts (at
    most 1e-5 of the kept weight, a tenth of the cell's limit) and the
    column sums do not (conserve_err at most 3e-6, rounding)."""
    rows, n, num, bins, out_of_range, gamma = _FUSED_CASES[label]
    x, sc = _chirps(rows, n, 21, card), _scales(num)
    W, dW = tssq._cwt_and_derivative(x, sc, _morlet(), 1.0, jt.PaddingType.SYMMETRIC)
    freqs = _uneven_grid(sc, 64) if bins == "uneven" else tssq._default_bins(sc, FC, bins)
    wgt = torch.as_tensor(sc ** -0.5 * tssq._log_measure(sc), dtype=torch.float32, device=card)
    before = jt.ops.launch_counts()["K6"]
    got = cuda_reassign.squeeze(W, dW, wgt, gamma, tssq._bin_grid(freqs, None, card),
                                out_of_range)
    torch.cuda.synchronize()
    assert jt.ops.launch_counts()["K6"] == before + 1
    want, contrib, k = _plain_on_the_card(W, dW, wgt, gamma, freqs, out_of_range)
    assert got.shape == want.shape and bool(torch.isfinite(torch.view_as_real(got)).all())
    flip, conserve = _fused_against_plain(got, want, contrib, k, len(freqs))
    assert flip <= 1e-5 and conserve <= 3e-6, (flip, conserve)
    again = cuda_reassign.squeeze(W, dW, wgt, gamma, tssq._bin_grid(freqs, None, card),
                                  out_of_range)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zeros", "nan row"])
def test_card_fused_k6_on_a_silent_and_a_broken_row(card, case):
    """An all-zero signal keeps nothing (max |W|^2 is 0, and 0 > 0 fails);
    a NaN in one row makes that row's threshold NaN, so the row keeps
    nothing, as torch.amax's NaN does on the plain path, and the other rows
    are untouched."""
    x, sc = _chirps(3, 8192, 22, card), _scales(64)
    if case == "zeros":
        x.zero_()
    else:
        x[1, 100] = float("nan")
    W, dW = tssq._cwt_and_derivative(x, sc, _morlet(), 1.0, jt.PaddingType.SYMMETRIC)
    freqs = tssq._default_bins(sc, FC, 64)
    wgt = torch.as_tensor(sc ** -0.5 * tssq._log_measure(sc), dtype=torch.float32, device=card)
    got = cuda_reassign.squeeze(W, dW, wgt, None, tssq._bin_grid(freqs, None, card), "clip")
    want, contrib, k = _plain_on_the_card(W, dW, wgt, None, freqs, "clip")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    if case == "zeros":
        assert not bool(got.abs().any()) and not bool(want.abs().any())
    else:
        assert not bool(got[1].abs().any()) and not bool(want[1].abs().any())
        flip, conserve = _fused_against_plain(got[0::2], want[0::2], contrib[0::2], k[0::2], 64)
        assert flip <= 1e-5 and conserve <= 3e-6, (flip, conserve)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,where", [((2, 64, 2**20), None), ((8, 64, 65536), None),
                                         ((3, 13, 3001), None), ((3, 64, 8192), "nan"),
                                         ((3, 64, 8192), "inf"), ((2, 5, 7), "zeros")])
def test_card_row_peaks_equal_torch_amax_to_the_bit(card, shape, where):
    gen = torch.Generator(device=card).manual_seed(4)
    big = torch.randn((shape[0], 2 * shape[1], shape[2] + 5), generator=gen, device=card,
                      dtype=torch.complex64)
    W = big[:, :shape[1], :shape[2]]  # a strided view, as ssq's halves are
    if where == "nan":
        W[1, 7, 300] = complex(float("nan"), 0.0)
    elif where == "inf":
        W[2, 3, 5] = complex(0.0, float("inf"))
    elif where == "zeros":
        W.zero_()
    before = jt.ops.launch_counts()["K6.peak"]
    got = cuda_reassign.row_peaks(W)
    want = torch.amax(W.real ** 2 + W.imag ** 2, dim=(-2, -1))
    torch.cuda.synchronize()
    assert jt.ops.launch_counts()["K6.peak"] == before + 1
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert torch.equal(got[fin].view(torch.int32), want[fin].view(torch.int32))


@pytest.mark.cuda
def test_card_a_gradient_takes_the_unfused_path(card):
    x = _chirps(2, 4096, 23, card).requires_grad_()
    sc = _scales(16)
    fused = profiling.counts()["ssq.fused_chunks"]
    before = jt.ops.launch_counts()["K6"]
    res = jt.ssq_cwt(x, sc, _morlet(), 1.0)
    (res.Tx.abs() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert profiling.counts()["ssq.fused_chunks"] == fused
    assert jt.ops.launch_counts()["K6"] == before + 1
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
