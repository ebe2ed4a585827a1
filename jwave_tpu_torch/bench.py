"""The port's benchmark: the JAX package's ``bench.py`` rows on the card.

    python -m jwave_tpu_torch bench [--sweep | --pallas-smoke] [--device cpu]
    python -m jwave_tpu_torch.bench [--sweep | --pallas-smoke] [--device cpu]

With no flag, :func:`main` runs ``bench.py``'s rows at its shapes and dtypes,
under its names and units, through the port's public functions, in its
priority order under ``BENCH_BUDGET_S`` seconds (default 420): a row whose
estimated cost the time left no longer covers records
``{"skipped": "budget"}``. At each of ``bench.py``'s checkpoints it prints
two lines: the ``details`` of every row so far, then the compact headline
(MODWT db4 L5 throughput against ``BASELINE_MODWT_MSAMPLES``, the
reference's Java figure) last. ``--sweep`` runs :func:`sweep`, the
reference's performance-test sweeps; ``--pallas-smoke`` runs
:func:`pallas_smoke`, which in the port proves the CUDA kernels K1-K3 and K7
(the JAX flag's name is kept). Everything runs on the card unless ``--device``
names another; without a card the run exits 1 with torch's error.

Each row records, beside ``bench.py``'s throughput key:

- ``ms``: device time, the median of :data:`REPS` runs between CUDA events,
  each after a 128 MB L2 flush and a ~5 ms GPU spin that lets the host
  enqueue the call first (:func:`..utils.profiling.median_ms`); ``wall_ms``
  the same without the spin; ``below_floor`` where ``ms`` is under the
  events' resolution;
- ``host_syncs``: the host's waits for the stream in one warm call, counted
  by torch's sync debug mode. Above 0, the spin cannot keep the host ahead,
  and ``ms`` includes the host's gaps (``device_ms_includes_host_waits``);
- ``launches``: launches of K1-K9 in one warm call;
- ``err``: max |error| of the float32 call against the same call in float64
  on the same device, relative to max |ref| (for several outputs, the
  largest), beside its ``bound``.

On the CPU (``--device cpu``) the times come from the host clock and the
rows that ``bench.py`` runs only off the CPU are skipped unless
``card_rows`` asks for them (they then run the kernels' plain versions).
A row that raises, or whose error exceeds its bound, records ``error`` and
the run goes on; the exit code is then 1. Eager torch has neither XLA's
dead-code elimination nor a relay's dispatch cost, so ``bench.py``'s
chained-scan timing has no counterpart here; each row keeps its reduction
(``.sum(dim=-2)`` and so on) so that the work is that of the JAX row.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import jwave_tpu_torch as jt

from . import ops
from .ops import cuda_build
from .ops.composite import wpt_conv_forward
from .filters import get_filter
from .transforms.fwt import _butterfly_levels, fwt
from .transforms.lifting import lifting_fwt
from .transforms.ndim import forward_2d, forward_3d
from .transforms.sliding import sliding_modwt_init, sliding_modwt_update
from .utils.profiling import median_ms

BASELINE_MODWT_MSAMPLES = 512.0 / (3.3e-3 * 5.0 / 8.0) / 1e6  # 0.248
REPS = 25
F32_BOUND = 1e-5    # float32 storage, float32 accumulation
LOOSE_BOUND = 1e-4  # through a median threshold, 300 ADMM iterations, each scattering order
BF16_BOUND = 1e-2   # the bf16 precision-dial rows
FLOOR_MS = 5e-4     # CUDA events resolve about 0.5 us

#: bench.py's shapes; ``main(shapes=...)`` and ``sweep(shapes=...)`` replace any
SHAPES = {
    "signals": (64, 65536),        # the headline, its methods, fwt1d, wpt, lifting
    "modwt_sweep": (8, (256, 1024, 8192)),
    "image": 2048,
    "rows_256x16K": (256, 16384),
    "volume": 256,
    "signals8": (8, 65536),        # scattering1d, dtcwt1d, denoise_modwt, ssq_cwt
    "image512": 512,
    "image256": 256,
    "chirp": 1 << 20,
    "sliding_window": 512,
    "sliding_updates": 4096,
    "wvd": (8, 4096),
    "superlet": (8, 16384),
    "ewt": (8, 16384),
    "vmd": 2048,
    "pursuit": (4, 2048),
    "sweep_modwt": (64, 256, 1024, 8192),
    "sweep_wpt": (512, 4096, 65536),
    "sweep_cwt": (8192, (10, 25, 50, 100)),
}


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()  # without a card: torch's own error, no fallback
    return dev


def _card_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if dev.type != "cuda":
        return str(dev)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
        return out.splitlines()[torch.cuda.current_device()].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)} (no nvidia-smi: power limit not read)"


def _build(dev: torch.device):
    """Compile K1-K9 (one nvcc per source, all at once) before any row, and
    print the seconds on their own line; a failure is printed and left to
    the rows that need the kernels."""
    if dev.type != "cuda":
        return
    names = ("modwt", "pyramid", "reassign", "wpt")
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(cuda_build.library, names))
    except Exception as e:  # recorded; every row that needs a kernel then errs
        print(json.dumps({"build_error": f"{type(e).__name__}: {str(e)[:400]}"}), flush=True)
        return
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "sources": [f"jwave_tpu_torch/csrc/{n}.cu" for n in names]}), flush=True)


def _parts(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _parts(o)]


def rel_err(got, ref) -> float:
    """Max |got - ref| / max |ref| over each output tensor, the largest."""
    worst = 0.0
    for g, r in zip(_parts(got), _parts(ref), strict=True):
        if g.is_complex():
            g, r = torch.view_as_real(g), torch.view_as_real(r)
        r = r.double()
        worst = max(worst, float((g.double() - r).abs().max() / r.abs().max()))
    return worst


class _Run:
    """One bench run on one device: its clock, its budget and its records."""

    def __init__(self, dev: torch.device, budget_s: float, outputs):
        self.dev, self.card = dev, dev.type == "cuda"
        self.budget_s, self.t0 = budget_s, time.monotonic()
        self.outputs = outputs
        self.rng = np.random.default_rng(0)

    def left(self) -> float:
        return self.budget_s - (time.monotonic() - self.t0)

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def tensor(self, shape) -> torch.Tensor:
        """Standard normal float32 from the run's generator, on the device."""
        return torch.as_tensor(self.rng.standard_normal(shape), dtype=torch.float32,
                               device=self.dev)

    def ms(self, fn, device: bool = True) -> float:
        return median_ms(fn, REPS, device=device, card=self.card)

    def syncs_and_launches(self, fn) -> tuple:
        """(host syncs or None off the card, {kernel: launches}) of one call,
        the second of two under torch's sync debug mode (the mode's first
        call can count a wait of its own)."""
        if not self.card:
            ops.reset_launch_counts()
            fn()
            return None, {k: v for k, v in ops.launch_counts().items() if v}
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
                caught.clear()
                ops.reset_launch_counts()
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        return syncs, {k: v for k, v in ops.launch_counts().items() if v}

    def measure(self, name, fn, x, check=None, ref=None, bound=F32_BOUND, throughput=None):
        """The record of one row: ``fn(x)`` timed; ``check`` (``fn`` by default)
        on ``x`` against ``ref`` (``check`` by default) on ``x`` in float64."""
        check = check or fn
        err = rel_err(check(x), (ref or check)(x.double()))
        if self.outputs is not None:
            self.outputs[name] = (x, fn(x))
        r = {"ms": self.ms(lambda: fn(x)), "wall_ms": self.ms(lambda: fn(x), device=False)}
        if r["ms"] < FLOOR_MS:
            r["below_floor"] = True
        if throughput:
            unit, count = throughput
            r[unit] = count / r["ms"] / 1e3
        r["host_syncs"], r["launches"] = self.syncs_and_launches(lambda: fn(x))
        if r["host_syncs"]:
            r["device_ms_includes_host_waits"] = True
        r["err"], r["bound"] = err, bound
        if not err <= bound:
            r["error"] = f"max |err| / max |ref| = {err} over its bound {bound}"
        return r


def main(shapes=None, device="cuda", card_rows: bool | None = None,
         outputs: dict | None = None) -> dict:
    """Run the rows, print the checkpoint lines, and return the details.

    ``shapes`` replaces entries of :data:`SHAPES`; ``card_rows`` runs the
    rows that ``bench.py`` runs only off the CPU (default: on the card
    only); ``outputs``, a dict, receives each row's ``(input, float32
    output)`` under its name. Each row is timed over :data:`REPS` runs."""
    sh = dict(SHAPES, **(shapes or {}))
    dev = _device(device)
    card = _card_name(dev)
    if card_rows is None:
        card_rows = dev.type == "cuda"
    _build(dev)
    run = _Run(dev, float(os.environ.get("BENCH_BUDGET_S", "420")), outputs)
    details = {"device": card, "dtype": "float32", "budget_s": run.budget_s,
               "torch": torch.__version__,
               "clock": "CUDA events" if run.card else "host perf_counter (not a card's time)"}
    method = jt.ConvolutionMethod

    def emit(partial_flag: bool):
        """bench.py's two lines: the details, then the compact headline last."""
        elapsed = run.elapsed()
        print(json.dumps({"details": dict(details, partial=partial_flag, elapsed_s=elapsed)}),
              flush=True)
        msps = details["modwt_db4_L5"].get("Msamples_per_s")
        print(json.dumps({
            "metric": "MODWT-db4-L5 throughput per chip",
            "value": msps,
            "unit": "Msamples/s",
            "vs_baseline": None if msps is None else msps / BASELINE_MODWT_MSAMPLES,
            "device": card,
            "dtype": "float32",
            "partial": partial_flag,
            "elapsed_s": elapsed,
            "modwt_db4_L5": details.get("modwt_db4_L5"),
        }), flush=True)

    def row(name, fn, arr, est=25.0, **kw):
        """One row if the time left covers its estimated cost, else the skip."""
        if run.left() < est:
            details[name] = {"skipped": "budget"}
            return
        try:
            details[name] = run.measure(name, fn, arr, **kw)
        except Exception as e:  # record, don't kill the bench
            details[name] = {"error": f"{type(e).__name__}: {str(e)[:300]}"}

    def card_row(name, *args, **kw):
        if card_rows:
            row(name, *args, **kw)
        else:
            details[name] = {"skipped": "card only"}

    def modwt_l5(m=method.AUTO):
        return lambda a: jt.modwt(a, "Daubechies 4", 5, method=m).sum(dim=-2)

    def with_dial(name, precision, *args, **kw):
        """A card row under the precision dial, restored afterwards."""
        if not card_rows:
            details[name] = {"skipped": "card only"}
            return
        if run.left() <= 25:
            details[name] = {"skipped": "budget"}
            return
        old = jt.config.conv_precision()
        jt.config.set_conv_precision(precision)
        try:
            row(name, *args, **kw)
        finally:
            jt.config.set_conv_precision(old)

    # --- headline: MODWT db4 L5, batched to fill the card, always first ------
    batch, n = sh["signals"]
    x = run.tensor((batch, n))
    row("modwt_db4_L5", modwt_l5(), x, est=-math.inf,
        throughput=("Msamples_per_s", batch * n))
    details["modwt_db4_L5"] = dict(batch=batch, n=n, **details["modwt_db4_L5"])
    emit(partial_flag=True)

    # --- budgeted rows, bench.py's priority order --------------------------
    row("modwt_db4_L5_fft", modwt_l5(method.FFT), x, throughput=("Msamples_per_s", batch * n))

    # the reference's internal sweep (MODWTFFTPerformanceTest.java:51-76):
    # direct (circular convolutions) / fft (cuFFT) / mxu (K1) at three sizes
    if run.left() > 110:
        sw = {"routes": {"direct": "circular convolutions", "fft": "cuFFT", "mxu": "K1"}}
        errs, raised = [], []
        sb, sizes = sh["modwt_sweep"]
        for ns in sizes:
            xs = run.tensor((sb, ns))
            ref = jt.modwt(xs.double(), "db4", 4).sum(dim=-2)
            r = {}
            for label, m in (("direct", method.DIRECT), ("fft", method.FFT),
                             ("mxu", method.MXU)):
                fn = lambda a, m=m: jt.modwt(a, "db4", 4, method=m).sum(dim=-2)  # noqa: E731
                try:
                    errs.append(rel_err(fn(xs), ref))
                    r[label] = run.ms(lambda: fn(xs)) * 1e3
                except Exception as e:  # record, don't kill the bench
                    r[label] = f"n/a ({type(e).__name__}: {str(e)[:120]})"
                    raised.append(f"{label} at {ns}")
            sw[str(ns)] = r
        last = sw[str(sizes[-1])]
        if all(isinstance(v, float) for v in last.values()):
            sw[f"internal_speedup_{sizes[-1]}"] = last["direct"] / min(last.values())
        sw["err"], sw["bound"] = max(errs, default=math.nan), F32_BOUND
        if raised:
            sw["error"] = "raised: " + ", ".join(raised)
        elif not sw["err"] <= F32_BOUND:
            sw["error"] = f"max |err| / max |ref| = {sw['err']} over its bound {F32_BOUND}"
        details["modwt_sweep_us_b8_L4"] = sw
    else:
        details["modwt_sweep_us_b8_L4"] = {"skipped": "budget"}

    # 2D FWT (BASELINE config #4): fwt2d is K4 twice
    side = sh["image"]
    img = run.tensor((side, side))
    row("fwt2d_db4_L6_2048", lambda m: jt.fwt2d(m, "Daubechies 4", 6, 6), img,
        throughput=("Mpix_per_s", side * side))
    # the separable plain route: forward_2d over the torch butterflies (cuDNN)
    fb4 = get_filter("Daubechies 4")
    card_row("fwt2d_db4_L6_2048_xla",
             lambda m: forward_2d(lambda v, level: _butterfly_levels(v, fb4, level), m, 6, 6),
             img, throughput=("Mpix_per_s", side * side))

    # 1D FWT (BASELINE config #2): K3 at both shapes
    row("fwt1d_db4_L8", lambda a: fwt(a, "Daubechies 4", 8), x,
        throughput=("Msamples_per_s", batch * n))
    rb, rn = sh["rows_256x16K"]
    card_row("fwt1d_db4_L8_256x16K_pallas", lambda a: fwt(a, "Daubechies 4", 8),
             run.tensor((rb, rn)) if card_rows else None,
             throughput=("Msamples_per_s", rb * rn))

    # 3D FWT (config #4): K3 along each axis
    vs = sh["volume"]
    row("fwt3d_db4_L4_256",
        lambda v: forward_3d(lambda a, level: fwt(a, "Daubechies 4", level), v, 4, 4, 4),
        run.tensor((vs, vs, vs)), throughput=("Mvox_per_s", vs**3))

    # WPT (K8 on the card)
    row("wpt_db4_L6", lambda a: jt.wpt(a, "Daubechies 4", 6), x,
        throughput=("Msamples_per_s", batch * n))

    if not card_rows:
        details["pallas_smoke"] = {"skipped": "card only"}
    elif run.left() > 60:
        try:
            details["pallas_smoke"] = pallas_smoke(dev)
        except Exception as e:  # record, don't kill the bench
            details["pallas_smoke"] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    else:
        details["pallas_smoke"] = {"skipped": "budget"}

    emit(partial_flag=True)  # checkpoint: the core transform rows are in

    # --- the analysis layer -----------------------------------------------
    b8, n8 = sh["signals8"]
    xs8 = run.tensor((b8, n8))
    s512, s256 = sh["image512"], sh["image256"]
    img512, img256 = run.tensor((s512, s512)), run.tensor((s256, s256))

    def orders(r):
        return r.S0, r.S1, r.S2

    row("scattering1d_J8_Q8_8x64K", lambda a: sum(s.sum() for s in orders(
        jt.scattering1d(a, J=8, Q=8))), xs8, est=100,
        check=lambda a: orders(jt.scattering1d(a, J=8, Q=8)), bound=LOOSE_BOUND,
        throughput=("Msamples_per_s", b8 * n8))
    row("scattering2d_J3_L8_256", lambda m: sum(s.sum() for s in orders(
        jt.scattering2d(m, J=3, L=8))), img256, est=60,
        check=lambda m: orders(jt.scattering2d(m, J=3, L=8)), bound=LOOSE_BOUND,
        throughput=("Mpix_per_s", s256 * s256))
    row("dtcwt1d_L6_8x64K", lambda a: sum(h.abs().sum() for h in jt.dtcwt(a, 6).highpasses),
        xs8, check=lambda a: jt.dtcwt(a, 6).highpasses,
        throughput=("Msamples_per_s", b8 * n8))
    row("dtcwt2d_roundtrip_L4_512", lambda m: jt.idtcwt2d(jt.dtcwt2d(m, 4)), img512,
        throughput=("Mpix_per_s", s512 * s512))

    # CWT Morlet, 64 scales, on a 1M-sample chirp (config #5)
    nc = sh["chirp"]
    tt = np.arange(nc, dtype=np.float32) / 1e6
    chirp = torch.as_tensor(np.sin(2 * np.pi * (1e3 + 1e4 * tt) * tt), dtype=torch.float32,
                            device=dev)
    scales = jt.generate_log_scales(1e-5, 1e-2, 64)
    morlet = jt.MorletWavelet(1.0, 1.0)

    def cwt_coeffs(sig):
        return jt.cwt(sig, scales=scales, wavelet=morlet, sampling_rate=1e6).coefficients

    row("cwt_morlet_64scales_1M", lambda sig: cwt_coeffs(sig).real.sum(dim=-2), chirp, est=35,
        check=cwt_coeffs, throughput=("Mcoeff_per_s", 64 * nc))

    row("lifting_cdf97_L8", lambda a: lifting_fwt(a, "CDF 9/7", 8), x,
        throughput=("Msamples_per_s", batch * n))

    # incremental sliding-window MODWT against a recompute per window (the
    # reference's pattern, MODWTSlidingWindowTest.java:14-17): window 512,
    # 8 levels, slide 64, 8 streams
    if run.left() > 40:
        try:
            details["sliding_modwt_w512_L8_step64"] = _sliding_row(run, sh)
        except Exception as e:  # record, don't kill the bench
            details["sliding_modwt_w512_L8_step64"] = {
                "error": f"{type(e).__name__}: {str(e)[:300]}"}
    else:
        details["sliding_modwt_w512_L8_step64"] = {"skipped": "budget"}

    emit(partial_flag=True)  # checkpoint: the analysis rows are in

    row("denoise_modwt_8x64K", lambda a: jt.denoise(a, "db4", 4), xs8, bound=LOOSE_BOUND,
        throughput=("Msamples_per_s", b8 * n8))
    row("denoise_dtcwt_512", lambda m: jt.denoise_dtcwt(m, 4), img512, bound=LOOSE_BOUND,
        throughput=("Mpix_per_s", s512 * s512))
    wb, wn = sh["wvd"]
    row("wvd_512bins_8x4K", lambda a: jt.wigner_ville(a, 1.0, n_bins=512)[0].sum(dim=-2),
        run.tensor((wb, wn)), throughput=("Mcoeff_per_s", wb * 512 * wn))
    sb_, sn = sh["superlet"]
    sl_freqs = np.linspace(5.0, 200.0, 64)
    row("superlet_64f_o16_8x16K", lambda a: jt.superlet(a, sl_freqs, 1000.0).sum(dim=-2),
        run.tensor((sb_, sn)), throughput=("Mcoeff_per_s", sb_ * 64 * sn))
    eb, en = sh["ewt"]
    ewt_sig = run.rng.standard_normal(en)
    try:
        ewt_bounds = jt.ewt_boundaries(torch.as_tensor(ewt_sig, device=dev), 5)
        xe = torch.as_tensor(np.tile(ewt_sig, (eb, 1)), dtype=torch.float32, device=dev)
        row("ewt_5modes_8x16K",
            lambda a: jt.ewt(a, boundaries=ewt_bounds).modes.abs().sum(dim=-2), xe,
            throughput=("Msamples_per_s", eb * en))
    except Exception as e:  # record, don't kill the bench
        details["ewt_5modes_8x16K"] = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
    row("vmd_K3_2048_300it", lambda a: jt.vmd(a, 3).modes.sum(dim=0), run.tensor(sh["vmd"]),
        est=30, check=lambda a: jt.vmd(a, 3).modes, bound=LOOSE_BOUND)

    # synchrosqueezed CWT: 64 scales, Tx summed over its bins; K6
    ssq_scales = jt.generate_log_scales(1e-5, 1e-2, 64)

    def ssq_sum(sig):
        r = jt.ssq_cwt(sig, ssq_scales, morlet, sampling_rate=1e6)
        return r.Tx.real.sum(dim=-2)

    # The check pins ssq_cwt's |W| threshold at float32's default for the
    # batch: the default scales with the dtype's eps, so the float64 call
    # would reassign coefficients that the float32 call drops
    xq = run.tensor((b8, n8))
    w_max = float(jt.cwt(xq.double(), ssq_scales, morlet, 1e6).coefficients.abs().max())
    gamma = 10.0 * math.sqrt(torch.finfo(torch.float32).eps) * w_max
    row("ssq_cwt_64scales_8x64K", ssq_sum, xq, est=40,
        check=lambda sig: jt.ssq_cwt(sig, ssq_scales, morlet, sampling_rate=1e6,
                                     gamma=gamma).Tx.real.sum(dim=-2),
        throughput=("Mcoeff_per_s", b8 * 64 * n8))

    # The picks are compared exactly first (picks_equal). Greedy picks may
    # part at a near-tie: two candidates whose residual energies agree to
    # float32's rounding (4 of 40 random 4 x 2048 inputs, float32 against
    # float64 on the CPU). So the error is that of the residual energy after
    # each pick, which such a tie leaves as it is and a wrong pick does not.
    xm = run.tensor(sh["pursuit"])
    row("matching_pursuit_16atoms_4x2K", lambda a: jt.matching_pursuit(a, 16).residual, xm,
        est=45, check=lambda a: jt.matching_pursuit(a, 16).energies)
    if "ms" in details["matching_pursuit_16atoms_4x2K"]:
        p32, p64 = jt.matching_pursuit(xm, 16), jt.matching_pursuit(xm.double(), 16)
        details["matching_pursuit_16atoms_4x2K"]["picks_equal"] = bool(
            torch.equal(p32.atom_idx, p64.atom_idx) and torch.equal(p32.positions, p64.positions))

    # MODWT variants, lowest priority: the headline covers the default path
    card_row("modwt_db4_L5_pallas", modwt_l5(method.PALLAS), x, ref=modwt_l5(),
             throughput=("Msamples_per_s", batch * n))
    # the precision dial's other end; the kernels ignore it (f32 accumulation)
    with_dial("modwt_db4_L5_bf16dial", "default", modwt_l5(), x, bound=BF16_BOUND,
              throughput=("Msamples_per_s", batch * n))
    with_dial("fwt2d_db4_L6_2048_bf16dial", "default", lambda m: jt.fwt2d(m, "Daubechies 4", 6, 6),
              img, bound=BF16_BOUND, throughput=("Mpix_per_s", side * side))

    emit(partial_flag=False)
    return details


def _sliding_row(run: _Run, sh) -> dict:
    """us per incremental update (device time of one update; wall from a
    chain of ``sliding_updates``) beside us per recompute of the window
    (a 512-sample L8 MODWT, K1), and the chain's final coefficients against
    the same chain in float64."""
    wlen, lvl, step, streams, kk = sh["sliding_window"], 8, 64, 8, sh["sliding_updates"]
    sig = run.tensor((streams, wlen))
    chunks = run.tensor((kk, streams, step))

    def chain(st, ch):
        for c in ch:
            st = sliding_modwt_update(st, c, "db4", lvl)
        return st

    st0 = sliding_modwt_init(sig, "db4", lvl)
    err = rel_err(chain(st0, chunks).coeffs,
                  chain(sliding_modwt_init(sig.double(), "db4", lvl), chunks.double()).coeffs)
    one = lambda: sliding_modwt_update(st0, chunks[0], "db4", lvl)  # noqa: E731
    recompute = lambda: jt.modwt(sig, "db4", lvl).sum(dim=-2)  # noqa: E731
    inc_ms, rec_ms = run.ms(one), run.ms(recompute)
    t0 = time.perf_counter()
    chain(st0, chunks)
    if run.card:
        torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    syncs, _ = run.syncs_and_launches(one)
    _, launches = run.syncs_and_launches(recompute)
    r = {"us_per_update": inc_ms * 1e3, "us_recompute_per_window": rec_ms * 1e3,
         "incremental_speedup": rec_ms / inc_ms, "updates": kk,
         "wall_us_per_update_in_chain": chain_s / kk * 1e6,
         "host_syncs": syncs, "launches": launches, "err": err, "bound": F32_BOUND}
    if syncs:
        r["device_ms_includes_host_waits"] = True
    if not err <= F32_BOUND:
        r["error"] = f"max |err| / max |ref| = {err} over its bound {F32_BOUND}"
    return r


def pallas_smoke(device="cuda") -> dict:
    """The kernels' proof on the card, as bench.py's Pallas smoke: db4 on a
    pinned 8 x 1024 float32 input, MODWT L3 through K1 (``method=PALLAS``)
    against cuFFT (``method=FFT``), K2's round trip, ``method=MXU`` (K1
    again in the port) and ``ifwt(fwt(., L6))`` with ``fwt`` on K3 and
    ``ifwt`` on K7, and a content hash of the coefficients as bench.py
    computes it. ``ok`` only when every error is below 1e-4 and, on the
    card, K1, K2, K3 and K7 were launched (their launch counts are in the
    result)."""
    dev = _device(device)
    m = jt.ConvolutionMethod
    rng = np.random.default_rng(1234)
    x = torch.as_tensor(rng.standard_normal((8, 1024)), dtype=torch.float32, device=dev)
    ops.reset_launch_counts()
    coeffs = jt.modwt(x, "db4", 3, method=m.PALLAS)
    back = jt.imodwt(coeffs, "db4", method=m.PALLAS)
    mxu = jt.modwt(x, "db4", 3, method=m.MXU)
    fwt_rt = jt.ifwt(jt.fwt(x, "db4", 6), "db4", 6)
    launches = ops.launch_counts()
    want = jt.modwt(x, "db4", 3, method=m.FFT)

    def err(a, b):
        return float((a - b).abs().max())

    c = coeffs.cpu().numpy()
    res = {"max_err_vs_fft": err(coeffs, want), "roundtrip_err": err(back, x),
           "mxu_err_vs_fft": err(mxu, want), "mxu_fwt_roundtrip_err": err(fwt_rt, x)}
    ok = all(v < 1e-4 for v in res.values())
    if dev.type == "cuda":
        ok = ok and launches["K1"] >= 2 and all(launches[k] >= 1 for k in ("K2", "K3", "K7"))
    digest = hashlib.sha256(np.round(c.astype(np.float64), 4).tobytes()).hexdigest()[:16]
    return {"ok": bool(ok), **res, "sha256_coeffs_r4": digest, "shape": [8, 1024],
            "wavelet": "db4", "level": 3,
            "launches": {k: launches[k] for k in ("K1", "K2", "K3", "K7")}}


def sweep(shapes=None, device="cuda"):
    """The reference's performance-test sweeps (SURVEY.md section 6), device
    microseconds: MODWT direct / FFT / Pallas / MXU over 64..8192
    (MODWTFFTPerformanceTest.java:51-76; in the port Pallas and MXU both
    name K1), WPT at full depth over 512..65536
    (ParallelWPTPerformanceTest.java:112), CWT scale counts 10..100 on 8192
    samples (CWT_PARALLEL_PERFORMANCE.md); on the card also the plain
    butterfly routes (cuDNN), what ``set_mxu_butterfly("off")`` selects in
    the JAX package, the 2D FWT at each precision dial and WPT's
    interleaved layout."""
    sh = dict(SHAPES, **(shapes or {}))
    dev = _device(device)
    _build(dev)
    run = _Run(dev, math.inf, None)
    method = jt.ConvolutionMethod

    def us(fn, a):
        return run.ms(lambda: fn(a)) * 1e3

    print("# MODWT db4 L4: direct vs FFT vs Pallas vs MXU (batch 8; Pallas and MXU are K1)")
    for n in sh["sweep_modwt"]:
        x = run.tensor((8, n))
        r = {"n": n}
        for label, m in (("direct", method.DIRECT), ("fft", method.FFT),
                         ("pallas", method.PALLAS), ("mxu", method.MXU)):
            try:
                r[label] = us(lambda a, m=m: jt.modwt(a, "db4", 4, method=m).sum(dim=-2), x)
            except Exception as e:  # record, don't kill the sweep
                r[label] = f"n/a ({type(e).__name__})"
        print(json.dumps({"modwt_sweep_us": r}), flush=True)

    print("# WPT db4 full depth: sizes 512..65536 (batch 8)")
    for n in sh["sweep_wpt"]:
        dt = us(lambda a: jt.wpt(a, "db4"), run.tensor((8, n)))
        print(json.dumps({"wpt_sweep": {"n": n, "us": dt}}), flush=True)

    cn, counts = sh["sweep_cwt"]
    print(f"# CWT Morlet on {cn} samples: scale counts 10..100")
    sig = run.tensor(cn)
    for s in counts:
        scales = jt.generate_log_scales(1e-4, 1e-1, s)

        def cwt_sum(a, sc=scales):
            r = jt.cwt(a, scales=sc, wavelet=jt.MorletWavelet(1.0, 1.0), sampling_rate=1e4)
            return r.coefficients.real.sum(dim=-2)

        print(json.dumps({"cwt_sweep": {"scales": s, "us": us(cwt_sum, sig)}}), flush=True)

    if dev.type != "cuda":
        return
    batch, n = sh["signals"]
    x = run.tensor((batch, n))
    side = sh["image"]
    img = run.tensor((side, side))
    fb4 = get_filter("Daubechies 4")
    print(json.dumps({"fwt1d_db4_L8_conv_us": us(lambda a: _butterfly_levels(a, fb4, 8), x)}),
          flush=True)
    # wpt's route where K8 does not run: the composite convolution
    print(json.dumps({"wpt_db4_L6_conv_us": us(
        lambda a: wpt_conv_forward(a, fb4.dec_lo, fb4.dec_hi, 6), x)}), flush=True)
    old = jt.config.conv_precision()
    for dial in ("default", "high", "highest"):
        jt.config.set_conv_precision(dial)
        try:
            dt = us(lambda m: forward_2d(lambda v, level: fwt(v, "Daubechies 4", level),
                                         m, 6, 6), img)
        finally:
            jt.config.set_conv_precision(old)
        print(json.dumps({f"fwt2d_db4_L6_2048_{dial}_us": dt}), flush=True)
    dt = us(lambda a: jt.wpt(a, "Daubechies 4", 6, layout="interleaved"), x)
    print(json.dumps({"wpt_fwd_interleaved_us": dt}), flush=True)


def failures(details: dict) -> list:
    """The rows that record an error, and a pallas_smoke that is not ok."""
    return [k for k, v in details.items() if isinstance(v, dict)
            and ("error" in v or v.get("ok") is False)]


def run(mode: str = "rows", device="cuda") -> int:
    """The command line's work: ``mode`` is "rows", "sweep" or "pallas_smoke".
    0 when every row and the smoke are right, else 1."""
    if mode == "sweep":
        sweep(device=device)
        return 0
    if mode == "pallas_smoke":
        res = pallas_smoke(device)
        print(json.dumps({"pallas_smoke": res}), flush=True)
        return 0 if res["ok"] else 1
    return 1 if failures(main(device=device)) else 0


if __name__ == "__main__":
    from .cli import main as _cli

    sys.exit(_cli(["bench", *sys.argv[1:]]))
