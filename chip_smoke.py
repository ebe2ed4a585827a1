"""Smoke run of jwave_tpu_torch on one CUDA card (written for an H100).

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize() so that a fault shows where
it happened; any failed check ends the run with a non-zero exit:

1. device: needs a CUDA card; prints the card's name and power limit;
   checks that the port's precision dial reads 'highest' (true float32, the
   JAX package's default) on a fresh import, with no call to it, and that
   ops.butterfly.synthesis_levels (ifwt's cuDNN route where K7 does not
   run; db4 L8, 64 x 65536 f32) then agrees with its float64 run to 1e-5 of
   max|ref|, and ops.composite.wpt_conv_forward (wpt's cuDNN route where
   K8 does not run: db4 L6, one conv1d of 64 channels of 442 taps)
   likewise; prints each call's error with the dial at 'high' (TF32
   allowed) beside it, the error of that conv1d called directly under each
   of torch's TF32 switches (which one governs cuDNN), and at both dial
   settings wpt_conv_inverse's conv_transpose1d, dft's matmul and a float32
   matmul inside config.dial().
2. build: compiles csrc/*.cu with nvcc, one compiler per source, all at
   once, and prints the build seconds.
3. kernels: K1-K9 on the card against their plain torch versions run in
   float64 on the same input, at the main paths' shapes and at edge shapes
   (K3 also where its tiled levels leave a tail, 62 taps or 16 levels, over
   two tiled passes, and with a gain; K6 at the main shape on the
   contributions and bin indices of a real ssq_cwt of the main signal, on 64
   bins and on 128, two bin chunks, and K6's fused form on the same W and dW
   against it (the same bins, so the same plane), and the peak kernel
   against torch.amax bit for bit there and on its first 65535 columns; K7 at 64 x 65536 db4 L8 and L16, 62
   taps, Haar orthogonal's gain, Battle 23's partial levels, rows of 1, 2
   and 4 samples, odd batches, rows of 2^22, a source off 16-byte
   alignment, items of whole rows of 16, 256 and 2048 with a short last
   one, and the persistent grid at 1, grid - 1 and grid + 1 items and with
   some blocks taking one item more than others; K8 and K9 in both layouts
   at 64 x 65536 db4 L6, at 16384 x 2048 L6 (whole rows, 2 an item), at
   every chunk of wpt at full depth on 65536 (1024
   L6 and 16 L4 as whole rows: 105 taps mod 16), rows of 8 at L3, 62 taps
   at L3, Haar and Haar orthogonal's gain at L6, the generic taps, one
   level, odd batches around the rows an item, rows of 2^20, a source off
   16-byte alignment, and their persistent grid: whole-row items at grid -
   1, grid and grid + 1 items of each kernel's grid, tiled items on grids
   forced to items - 1, items and items + 1, forced grids of 1 and 2); the
   rotated K8 and K9 on the packet cell's axis pass (16384 x 2048 L6 in
   groups of 2048), 128 x 64 Haar L6 and sym8 L2, and packets of 4 in rows
   of 256 (wpt's last chunk at full depth); K4 and K5 in groups (each
   frame's rows stored transposed within the frame) on the 2D FWT cell's
   axis pass (16384 x 2048 db4 L6 in groups of 2048), odd frame counts,
   groups smaller than a block's rows and rows of 4096.
4. main paths, each with the launch counts set to 0 just before it and read
   just after, all through the public entry points (numpy input goes to the
   card by default, tensors are made there):
   a. MODWT + FWT: modwt -> imodwt (db4 L5, 64 x 65536 f32) and the FWT
      facade forward/reverse on 64 x 65536 rows (K3, then K7 once) and a
      2048 x 2048 image (fwt2d as K4 x2, ifwt2d as K5 x2); small inputs
      against the numpy oracle in tests/oracle.py.
   a'. the volume: the FWT facade's 3D forward, then reverse, on a 256^3
      f32 volume at (6, 6, 6): three rotated K3 launches, then three
      rotated K7, and nothing else, against the separable ndim path.
   a''. the packet cell: the WPT facade's forward_2d, then reverse_2d, on
      an (8, 2048, 2048) f32 stack at (6, 6): two rotated K8 (K9) launches
      on 16384 rows of 2048 (ndim.rotated_passes 2) each way, no
      transposing copy and nothing else; against the facade's float64 run
      (the separable path), and the round trip against the stack.
   a'''. the 2D FWT cell: the FWT facade's forward_2d, then reverse_2d, on
      an (8, 2048, 2048) f32 stack at (6, 6): two K4 (K5) launches in
      groups of 2048 on 16384 rows of 2048 (ndim.rotated_passes 2) each
      way, no K3, K7 or transposing copy and nothing else; against the
      plain grouped forms in float64 and the facade's float64 run (the
      separable path), and the round trip against the stack.
   b. continuous: ssq_cwt -> issq_cwt at 8 x 65536 f32, Morlet(1,1), 64 log
      scales 1e-5..1e-2 s, fs = 1e6 (K6), held against the same call with
      the plain scatter and by the column-sum identity; extract_ridge and
      ridge_tube_mask, a tone's ridge and a two-tone round trip at small
      size; the CWT facade's transform_fft and transform, against the
      port's CPU float64 run on a small input.
   c. gradients through K1-K5 and K7-K9: torch.autograd.grad of (f(x) *
      w).sum() for modwt and imodwt (db4 L5, 64 x 65536), fwt and ifwt (db4
      L8, 64 x 65536), fwt2d and ifwt2d (db4 L6, 2048 x 2048) and Haar
      orthogonal ifwt2d (256 x 256), against autograd through the plain
      versions in float64; the backward's launches are read on their own
      (modwt's must launch K2, fwt's K7, ifwt's K3, fwt2d's K5, ifwt2d's
      K4; wpt's K9 and iwpt's K8, db4 L6 64 x 65536 and full depth; the
      WPT facade's forward_2d's K9 and reverse_2d's K8, and the FWT
      facade's forward_2d's K5 and reverse_2d's K4 in groups, on a (2, 256,
      512) stack at (6, 6), against the separable ndim path over the plain
      versions);
      hurst_exponent's gradient at 8 x 65536
      against the float64 route. The K6 gather against the plain scatter's.
   d. MODWT analysis: modwt_mra (64 x 65536, db4 L5), modwt_2d -> imodwt_2d
      (2048 x 2048, L5), modwt_mra_2d (1024 x 1024, L3), the scale
      statistics and logscale diagram (64 x 65536, L8), hurst_exponent of
      white noise; each against its float64 route or identity.
   e. denoising: denoise db4 L4 8 x 65536 (bench.py's denoise_modwt_8x64K),
      three methods, soft, against the float64 route; hard mode by its SNR
      gain; denoise_2d 2048 x 2048 L3 bayes; median_abs's two routes on 4M.
   f. sliding MODWT at bench.py's shape (8 streams, window 512, db4 L8, chunk
      64, 4096 updates), against modwt of the final window and of the whole
      stream.
   g. the rest of the continuous layer at bench.py's shapes: wigner_ville,
      superlet, ewt -> iewt, vmd, matching_pursuit, analytic_signal; their
      identities, and each against the port's float64 CPU run at a small size.
   h. the rest of the discrete family at bench.py's shapes: wpt -> iwpt (db4
      L6, 64 x 65536: fused and interleaved, K8 and K9 once each; level by
      level, no kernel; two rows against tests/oracle.py), at full depth
      (K8 and K9 once a fused chunk: three each), the WPT facade's 2D
      forward and reverse on a 2048^2 image and 3D on 256^3 (L4);
      best_basis (8 x 65536, max level 6) and best_basis_2d (512^2, L4),
      their nodes equal to the port's float64 CPU run's; the Ancient
      Egyptian FWT (db4, 64 x 100000: one K3 launch per chunk) through the
      builder's prefix; shifting (db4, 64 x 65536 and 64 x 65537);
      lifting_fwt -> lifting_ifwt (CDF 9/7 L8, 64 x 65536, both boundaries);
      dtcwt -> idtcwt (L6, 8 x 65536), dtcwt2d -> idtcwt2d (L4, 512^2),
      denoise_dtcwt (512^2, L4); the variants: the in-place FWT (K3 once,
      the input's storage), the streaming MODWT (db4 L5, 2^20 samples in
      chunks of 65536: K1 once a chunk), a pooled MODWT round trip (K1, K2),
      CompressorMagnitude on the WPT'd image. Best bases, lifting and DTCWT
      launch no kernel of this package.
   i. scattering at bench.py's shapes: scattering1d (8 x 65536 f32, J=8,
      Q=8) and scattering2d (256^2 f32, J=3, L=8), spectral form on cuFFT,
      K1-K7 launched 0 times; each order against the card's float64 run
      (1e-4 of max|ref|), the card's float64 against the CPU's (2 rows and
      the image, 1e-10), shapes, dtypes, features() and n_paths against the
      bank; a warm call traced by utils.profiling.trace makes no
      host-to-device copy. The CLI demo (cli.main, FWT Daubechies 4) on the
      card returns 0; utils.profiling.time_fn times both scattering calls.
   j. the sharded layer (jwave_tpu_torch.parallel) in a one-rank NCCL world
      formed by initialize_distributed from torchrun's variables, on
      make_mesh()'s 1D mesh and a (1, 1) mesh: all 29 names at full size,
      f32 on the card (the 2D transforms db4 L6 2048^2, the batch-sharded
      MODWT round trip db4 L5 64 x 65536, the scale-sharded CWT and SSQ at
      8 x 65536 with 64 scales, the time-sharded paths on 2^22 samples, the
      time-sharded CWT on 2^20, pfft on 8 x 2^20, pfft2 and the 2D MODWT on
      2048^2, the 3D transforms on 256^3), each against the port's
      single-device function (1e-5 of max|ref|), its float64 run against
      the single device's (1e-10) and against its own f32 run, and by its
      identity; every output's local block on the card; K3 in the 2D/3D
      FWTs and the halo FWT's tail, K7 in their inverses, K8 in the 2D/3D
      WPTs, K9 in their inverses, K6 in
      ssq_scale_sharded, K1 and K2 in the batch-sharded round trip and the
      2D MODWT. Then every example's
      main() on the card (jwave_tpu_torch.examples).
5. times: CUDA events, median of 25 runs after warm-up with the L2 cache
   flushed before each and a GPU spin that hides the host's launch time
   (device time; each also once without the spin, as wall time), kernel
   beside its plain version and beside one PyTorch call that computes the
   same function (conv1d, matmul with the dense operator of a K3 or K7 row
   or a K4/K5 pass, scatter_add_; checked against the plain version first, never
   called by the port); a byte floor for each kernel (the same bytes, or
   for K6 a fifth more, moved by torch copies, or by K4/K5 with no level);
   K3 at a shape with a tail and K6 at 128 bins; K6's fused form and the
   peak kernel at 8 x 64 x 65536 and at 2 x 64 x 2^20 (the ssq cell's
   chunk; the peak kernel held to torch.amax bit for bit at each first),
   beside their bounds, their plain versions in turns and the eager path
   they replace; K7 at 1, 2, 4 and 8
   levels and Haar's at 8, on 65536 rows of 256, and its plans (blocks an
   SM, grid, items a block); fwt and ifwt (K7) at 64 x 65536, and the 1D inverse's route before K7 (the synthesis butterflies:
   the sum of its kernels' times in a profiled call, and wall); ifwt3d db4
   256^3 and ifwt2d_sharded 2048^2 before and after K7, in turns; K8 and
   K9 beside the conv form they replace (its conv1d on the extended input,
   its conv_transpose1d and fold), the rotated K8 and K9 at 16384 x 2048
   db4 L6 (the packet cell's rows) beside their plain versions and beside
   K8 (K9) in place then a transposing copy, K4 and K5 in groups of 2048
   there (the 2D FWT cell's passes) beside their plain versions and beside
   K3 (K7) in place then a transposing copy, the rotated K8 and K9 plans at 64 x 65536 db4 L6 and at
   wpt's whole-row chunks (4096 x 1024 L6, 262144 x 16 L4: the persistent
   grid, blocks an SM, shared bytes, registers and spills from -Xptxas -v,
   which must show none, and the time), and wpt, iwpt, the WPT facade 2D
   2048^2 and 3D 256^3 L4 and wpt2d/iwpt2d_sharded before (the conv form)
   and after (K8, K9), in turns, each beside the first design's time (FIRST_DESIGN_MS); for
   context
   also the torch FFT path of the MODWT (cuFFT) and the separable ifwt2d
   path, which are not kernels of this package; the entry step's gradient,
   fwt2d's gradient (backward K5 x2), ifwt2d's gradient (backward K4 x2),
   the analysis calls, each call of 4g and each call of 4h (device time and
   wall; WPT fused against level by level in each direction, with the sum
   of its kernels' device times in a profiled call and its byte bound); the
   scattering calls of 4i: device time, wall, time_fn's mean beside them,
   busy time, kernels and cuFFT's share in a profiled call, the peak memory
   of a warm call and the bytes of its FFT rounds; each call of 4j beside
   its single-device counterpart (device time and wall, in turns): on one
   rank the difference is the sharded layer's own cost.

6. the bench entry point, in this process: jwave_tpu_torch.bench.main()
   (bench.py's 28 rows at its shapes, BENCH_BUDGET_S=300), bench.sweep() and
   bench.pallas_smoke(); requires the headline as the rows' last line, the
   28 names of bench.py, no row skipped or with an error, each row's error
   within its bound, the kernels launched in the rows that reach them, the
   sweep's lines, and pallas_smoke ok (K1-K3 and K7 launched); one summary
   line a row.
7. the parity census (tests/torch_census_cases.py, the same case table
   that tier-1 holds against the JAX package on the CPU in float64, the
   card-only cases included): every case the
   card runs, through the public names, in float32 on the card against the
   port's own float64 run on the CPU (the card's host needs no JAX): the same
   raise or return and exception class, structure and shapes, values
   within 1e-5 of max(max|ref|, 1) (1e-4 through a median, a threshold or
   an iteration), discrete outputs exactly but where float32 takes the
   other side of a tie (pursuit picks, a best-basis tree: printed as a
   near-tie), dtypes as the CPU's in the same input dtype, every output
   tensor on the card; and the card-only cases at the kernels' eligibility
   edges (K1-K9 through modwt, fwt, ifwt, fwt2d, ifwt2d, ssq_cwt, wpt and
   iwpt: levels 0, 1
   and split level groups, lengths off the tile, batches of 1 and odd, N =
   1, 2, 4, sources off 16-byte alignment, transposed and non-square
   images, Haar orthogonal's gain, bins outside [0, K)) in float32, bf16
   and f16 where JAX takes them. One line a card-only case with its
   launches; one line for the phase: cases, runs, mismatches, near-ties,
   K1-K9 launches, seconds. Any mismatch fails the run.

The second line from the end is a JSON object listing each kernel with its
launches on its paths (4a-4b, 4h for K8/K9, and 4j), on its main path (4a;
K8/K9: 4h's full-depth WPT; K8.rotated/K9.rotated, the rotated forms of K8
and K9 on the packet cell's rows, timed at 16384 x 2048 L6 in groups of 2048
beside their plain versions and beside K8 (K9) in place followed by a
transposing copy: 4a''; K4.grouped/K5.grouped, K4 and K5 in groups of 2048
on the 2D FWT cell's rows, timed there beside their plain versions and
beside K3 (K7) in place followed by a transposing copy: 4a''';
K6's fused form, K6.fused, and the peak
kernel, K6.peak: 4b, the continuous path) and in 4j (K6's row counts the
unfused form's launches alone), its error, its time beside
its plain version's, the library call's, its byte floor and its bound
(bytes over 3.35 TB/s or FLOPs over 67 TFLOP/s, the larger), and its
backward route with that route's error; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from jwave_tpu_torch.bench import F32_BOUND

ROOT = Path(__file__).resolve().parent
#: the H100 SXM's HBM3 rate in bytes/s (data sheet), the byte floors' divisor
HBM_BYTES_S = 3.35e12
BF16_BOUND = 1e-2  # bf16 storage rounds each stored value to 2^-9 relative
REPS = 25


#: device ms of K8, K9 and their consumers in their first design (one work
#: item a block), for the lines of phase 5 (PERF.md, section 6: its final
#: run on "NVIDIA H100 80GB HBM3, 700.00 W"; the whole-row chunks, K8/K9 at
#: 4096 x 1024 L6 and 262144 x 16 L4: its tree timed beside the present
#: one by tools/ab_times.py on the same card)
FIRST_DESIGN_MS = {"K8 64x65536": 0.03854, "K9 64x65536": 0.04186, "K8 4096x1024": 0.03580,
           "K9 4096x1024": 0.03129, "K8 262144x16": 0.04440, "K9 262144x16": 0.03898,
           "wpt db4 L6 64x65536": 0.03862, "iwpt db4 L6 64x65536": 0.04198,
           "wpt db4 full depth 64x65536": 0.1100,
           "WPT facade 2D forward 2048^2 db4 full depth": 0.2269,
           "WPT facade 2D reverse 2048^2 db4 L6": 0.1303,
           "WPT facade 3D forward 256^3 db4 L4": 0.6654,
           "WPT facade 3D reverse 256^3 db4 L4": 0.6284,
           "wpt2d_sharded db4 L6 2048^2": 0.1574, "iwpt2d_sharded db4 L6 2048^2": 0.1480}


def require(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def wpt_ptxas(log: str) -> dict:
    """Registers and spill bytes of each K8/K9 instance in ``nvcc -Xptxas -v``
    output: {"K8 db4": {...}, "K8 Haar": ..., "K8 generic": ..., "K9 ...": ...}."""
    names = {"analysis_kernelILi8ELb1": "K8.rotated db4", "analysis_kernelILi2ELb1":
             "K8.rotated Haar", "analysis_kernelILi0ELb1": "K8.rotated generic",
             "synthesis_kernelILi4ELb1": "K9.rotated db4", "synthesis_kernelILi1ELb1":
             "K9.rotated Haar", "synthesis_kernelILi0ELb1": "K9.rotated generic",
             "analysis_kernelILi8": "K8 db4", "analysis_kernelILi2": "K8 Haar",
             "analysis_kernelILi0": "K8 generic", "synthesis_kernelILi4": "K9 db4",
             "synthesis_kernelILi1": "K9 Haar", "synthesis_kernelILi0": "K9 generic"}
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((v for k, v in names.items() if k in line), None)
            if cur:
                out[cur] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
        elif cur and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[cur]["spill_stores"], out[cur]["spill_loads"] = int(m[1]), int(m[2])
        elif cur and "registers" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
    return out


def main() -> int:
    # ---- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import jwave_tpu_torch as jt
    import oracle
    from jwave_tpu_torch.ops import cuda_build, cuda_modwt, cuda_pyramid, cuda_reassign, cuda_wpt
    from jwave_tpu_torch.ops.butterfly import synthesis_levels
    from jwave_tpu_torch.transforms import ndim
    from jwave_tpu_torch.transforms.modwt import _modwt_base_filters
    from jwave_tpu_torch.transforms.ssq import _bin_grid, _cwt_and_derivative, _default_bins, \
        _default_gamma, _log_measure, _reassign_inputs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # true float32 with no call to the dial: TF32 would keep ~3 digits. The
    # witness is the synthesis butterflies (cuDNN), the 1D inverse's route
    # where K7 does not run (ifwt itself runs K7 on a CUDA f32 tensor)
    require(jt.config.conv_precision() == "highest",
            f"the dial reads {jt.config.conv_precision()!r} on a fresh import")
    y_tf = torch.as_tensor(rng.standard_normal((64, 65536)), dtype=torch.float32, device=dev)
    fb_tf = jt.get_filter("db4")

    def butterflies(y):
        return synthesis_levels(y, fb_tf.rec_lo, fb_tf.rec_hi, 8)

    ref_tf = butterflies(y_tf.double())
    err_highest = float((butterflies(y_tf).double() - ref_tf).abs().max() / ref_tf.abs().max())
    jt.config.set_conv_precision("high")
    try:
        err_high = float((butterflies(y_tf).double() - ref_tf).abs().max() / ref_tf.abs().max())
    finally:
        jt.config.set_conv_precision("highest")
    conv_switch = getattr(getattr(torch.backends.cudnn, "conv", None), "fp32_precision", None)
    print(json.dumps({"check": "synthesis_levels (ifwt's butterfly route) db4 L8 64x65536 f32 "
                      "(cuDNN) against float64, the dial untouched ('highest')",
                      "rel": err_highest, "bound": F32_BOUND,
                      "rel_with_dial_high": err_high,
                      "cudnn_allow_tf32_outside": torch.backends.cudnn.allow_tf32,
                      "cudnn_conv_fp32_precision_outside": conv_switch}), flush=True)
    require(err_highest <= F32_BOUND,
            f"synthesis_levels with the default dial: {err_highest} > {F32_BOUND}")
    # The same for WPT's conv form db4 L6 (one conv1d of 64 channels of 442
    # taps, which cuDNN may run on the tensor cores; wpt itself runs K8 on a
    # CUDA f32 tensor), and that conv1d called directly under each of
    # torch's switches: which one governs cuDNN's float32 convolutions on
    # this torch
    from jwave_tpu_torch.ops.composite import _bank, wpt_conv_forward, wpt_conv_inverse
    fbp = jt.get_filter("db4")

    def conv_wpt(y):
        return wpt_conv_forward(y, fbp.dec_lo, fbp.dec_hi, 6)

    ref_w = conv_wpt(y_tf.double())
    err_w = float((conv_wpt(y_tf).double() - ref_w).abs().max() / ref_w.abs().max())
    jt.config.set_conv_precision("high")
    try:
        err_w_high = float((conv_wpt(y_tf).double() - ref_w).abs().max() / ref_w.abs().max())
    finally:
        jt.config.set_conv_precision("highest")
    wq = _bank(fbp.dec_lo, fbp.dec_hi, 6, 65536, y_tf)
    ext = torch.cat([y_tf, y_tf[:, :wq.shape[-1] - 1]], dim=-1)[:, None]
    ref_q = torch.nn.functional.conv1d(ext.double(), wq.double(), stride=64)

    def conv_err():
        got = torch.nn.functional.conv1d(ext, wq, stride=64)
        torch.cuda.synchronize()
        return float((got.double() - ref_q).abs().max() / ref_q.abs().max())

    cudnn_b = torch.backends.cudnn
    saved_tf32 = cudnn_b.allow_tf32
    switches = {}
    try:
        for flag in (True, False):
            cudnn_b.allow_tf32 = flag
            switches[f"cudnn.allow_tf32={flag}"] = conv_err()
        if conv_switch is not None:
            for prec in ("tf32", "ieee"):
                cudnn_b.allow_tf32 = prec == "ieee"   # the legacy switch says the opposite
                cudnn_b.conv.fp32_precision = prec
                switches[f"cudnn.conv.fp32_precision={prec} (allow_tf32 opposite)"] = conv_err()
    finally:
        cudnn_b.allow_tf32 = saved_tf32           # sets conv and rnn back together
    # the conv form's inverse, a conv_transpose1d (64 input channels), dft's
    # complex matmul and a float32 matmul inside the dial, each with the dial
    # at 'highest' and at 'high': where cuDNN or cuBLAS take TF32 when
    # allowed, 'high' shows it
    yc_w = conv_wpt(y_tf)
    z_d = torch.complex(y_tf[:8, :2048], y_tf[8:16, :2048])
    a_m, b_m = y_tf.reshape(4, 1024, 1024)[0], y_tf.reshape(4, 1024, 1024)[1]

    def in_dial(a, b):
        with jt.config.dial():
            return a @ b

    probes = {"wpt_conv_inverse db4 L6 (conv_transpose1d)": (
                  lambda: wpt_conv_inverse(yc_w, fbp.rec_lo, fbp.rec_hi, 6),
                  lambda: wpt_conv_inverse(yc_w.double(), fbp.rec_lo, fbp.rec_hi, 6)),
              "dft 8x2048 complex64 (matmul)": (lambda: torch.view_as_real(jt.transforms.dft(z_d)),
                                                lambda: torch.view_as_real(
                                                    jt.transforms.dft(z_d.to(torch.complex128)))),
              "1024^2 float32 matmul inside config.dial()": (
                  lambda: in_dial(a_m, b_m), lambda: in_dial(a_m.double(), b_m.double()))}
    dial_errs = {}
    for label, (fn, ref_fn) in probes.items():
        ref_p = ref_fn()
        errs = []
        for prec in ("highest", "high"):
            jt.config.set_conv_precision(prec)
            try:
                errs.append(float((fn().double() - ref_p).abs().max() / ref_p.abs().max()))
            finally:
                jt.config.set_conv_precision("highest")
        dial_errs[label] = {"highest": errs[0], "high": errs[1]}
    print(json.dumps({"check": "wpt_conv_forward (wpt's conv form) db4 L6 64x65536 f32 "
                               "against float64, the dial untouched",
                      "rel": err_w, "bound": F32_BOUND, "rel_with_dial_high": err_w_high,
                      "its conv1d (64 x 442 taps, stride 64) under torch's switches": switches,
                      "other sites, dial highest / high": dial_errs}), flush=True)
    require(err_w <= F32_BOUND, f"wpt's conv form with the default dial: {err_w} > {F32_BOUND}")
    require(all(e["highest"] <= F32_BOUND for e in dial_errs.values()),
            f"a site with the default dial is not true float32: {dial_errs}")
    del y_tf, ref_tf, ref_w, ext, ref_q, yc_w, z_d, a_m, b_m

    # ---- 2. build ------------------------------------------------------
    names = ("modwt", "pyramid", "reassign", "wpt")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.library, names))
    print(f"build, {len(names)} sources at once: {time.perf_counter() - t0:.3f} s", flush=True)
    for name in names:
        secs, log = cuda_build.BUILD_LOG.get(name, (0.0, "(already built)"))
        print(f"build {name}: nvcc {secs:.3f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  " + line.strip(), flush=True)

    # ---- 3. each kernel against its plain version ----------------------
    errors = {}

    def compare(label, got, ref, bound, scale=None):
        require(not (got.is_complex() or ref.is_complex()), f"{label}: compare real views")
        ref = ref.double()
        err = float((got.double() - ref).abs().max())
        scale = float(ref.abs().max()) if scale is None else scale
        rel = err / scale
        print(json.dumps({"check": label, "max_abs_err": err, "max_abs_ref": scale,
                          "rel": rel, "bound": bound}), flush=True)
        require(np.isfinite(rel) and rel <= bound, f"{label}: {rel} > {bound}")
        return err

    def signal(shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)

    def modwt_case(label, shape, wavelet, level, dtype=torch.float32):
        g0, h0 = _modwt_base_filters(wavelet)
        x = signal(shape, dtype)
        bound = F32_BOUND if dtype == torch.float32 else BF16_BOUND
        c = cuda_modwt.modwt_cascade(x, g0, h0, level)
        torch.cuda.synchronize()
        e1 = compare(f"K1 {label}", c, cuda_modwt.modwt_cascade_torch(x.double(), g0, h0, level), bound)
        back = cuda_modwt.imodwt_cascade(c, g0, h0)
        torch.cuda.synchronize()
        e2 = compare(f"K2 {label}", back, cuda_modwt.imodwt_cascade_torch(c.double(), g0, h0), bound)
        return e1, e2

    errors["K1"], errors["K2"] = modwt_case("64x65536 db4 L5", (64, 65536), "db4", 5)
    modwt_case("8x777 db4 L9", (8, 777), "db4", 9)
    modwt_case("4x256 dmey L5 (halo > N)", (4, 256), "Discrete Meyer", 5)
    modwt_case("4x8192 Haar L13 (K1: three level groups, K2: five)", (4, 8192), "Haar", 13)
    modwt_case("2x20000 dmey L10 (unstaged deep levels)", (2, 20000), "Discrete Meyer", 10)
    modwt_case("64x65536 db4 L5 bf16", (64, 65536), "db4", 5, torch.bfloat16)
    modwt_case("3x5000 db4 L6 (a ragged last tile that wraps)", (3, 5000), "db4", 6)
    modwt_case("2x100 dmey L6 bf16 (halo 3843 > N: 40 pieces)", (2, 100), "Discrete Meyer", 6,
               torch.bfloat16)
    modwt_case("8x777 db4 L9 bf16 (unaligned N)", (8, 777), "db4", 9, torch.bfloat16)

    def pyramid_case(label, shape, wavelet, level):
        fb = jt.get_filter(wavelet)
        x = signal(shape)
        done = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
        y = cuda_pyramid.pyramid_rows(x, fb.dec_lo, fb.dec_hi, done)
        torch.cuda.synchronize()
        return compare(f"K3 {label}", y,
                       cuda_pyramid.pyramid_rows_torch(x.double(), fb.dec_lo, fb.dec_hi, done),
                       F32_BOUND)

    errors["K3"] = pyramid_case("64x65536 db4 L8", (64, 65536), "db4", 8)
    pyramid_case("16x4096 sym8 L6 (a row a block: the tail kernel)", (16, 4096), "sym8", 6)
    pyramid_case("8x1024 Battle 23 full", (8, 1024), "Battle 23", 10)
    pyramid_case("8x4096 Haar full", (8, 4096), "Haar", 12)
    pyramid_case("4x262144 db4 L10 (8 tiled levels, a tail of 2 in the same launch)",
                 (4, 262144), "db4", 10)
    pyramid_case("64x65536 db4 L16 (8 tiled levels, a tail of 8)", (64, 65536), "db4", 16)
    pyramid_case("64x65536 Discrete Meyer L8 (62 taps: 5 tiled levels, a tail of 3)",
                 (64, 65536), "Discrete Meyer", 8)
    pyramid_case("2x1048576 Discrete Meyer L20 (two tiled passes)", (2, 1048576),
                 "Discrete Meyer", 20)
    for label, shape, wavelet, level, gain in (
            ("16x4096 Haar orthogonal L12, gain 0.5", (16, 4096), "Haar orthogonal", 12, 0.5),
            ("64x65536 db4 L8, gain 2", (64, 65536), "db4", 8, 2.0)):
        fb = jt.get_filter(wavelet)
        x = signal(shape)
        got = cuda_pyramid.pyramid_rows(x, fb.rec_lo, fb.rec_hi, level, gain)
        torch.cuda.synchronize()
        compare(f"K3 {label}", got,
                cuda_pyramid.pyramid_rows_torch(x.double(), fb.rec_lo, fb.rec_hi, level, gain),
                F32_BOUND)

    def ipyramid_case(label, shape, wavelet, level, offset=0):
        fb = jt.get_filter(wavelet)
        y = torch.empty(shape[0] * shape[1] + offset, device=dev)[offset:].view(shape)
        y.copy_(signal(shape))
        done = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
        args = (fb.rec_lo, fb.rec_hi, fb.recon_gain, done)
        got = cuda_pyramid.ipyramid_rows(y, *args)
        torch.cuda.synchronize()
        return compare(f"K7 {label}", got, cuda_pyramid.ipyramid_rows_torch(y.double(), *args),
                       F32_BOUND)

    errors["K7"] = ipyramid_case("64x65536 db4 L8", (64, 65536), "db4", 8)
    ipyramid_case("64x65536 db4 L16 (all levels)", (64, 65536), "db4", 16)
    ipyramid_case("64x65536 Discrete Meyer L8 (62 taps)", (64, 65536), "Discrete Meyer", 8)
    ipyramid_case("16x4096 Haar orthogonal L12 (gain 0.5)", (16, 4096), "Haar orthogonal", 12)
    ipyramid_case("256x1024 Battle 23 L8 (partial levels)", (256, 1024), "Battle 23", 8)
    for n_k7 in (1, 2, 4):
        ipyramid_case(f"5x{n_k7} db4, all its levels (one short item of whole rows)", (5, n_k7),
                      "db4", 8)
    ipyramid_case("7x1024 sym8 L10 (odd batch)", (7, 1024), "sym8", 10)
    ipyramid_case("133x8 db4 L3 (odd batch of short rows)", (133, 8), "db4", 3)
    ipyramid_case("2x4194304 db4 L22 (rows of 2^22)", (2, 1 << 22), "db4", 22)
    ipyramid_case("32x16384 db4 L9 (a source 4 bytes off 16-byte alignment)", (32, 16384),
                  "db4", 9, 1)
    # items of several whole rows (rows of 16, 256 and 2048), the last one
    # short where the rows an item do not divide the batch; the persistent
    # grid at 1 item, grid - 1 and grid + 1 (rows of one tile, one an item);
    # tiles of rows of 65536 that leave some blocks one item more than others
    for rows_k7, n_k7 in ((1001, 16), (65537, 256), (37, 2048)):
        rb_k7 = cuda_pyramid.k7_plan(n_k7, n_k7.bit_length() - 1, 8).rows
        ipyramid_case(f"{rows_k7}x{n_k7} db4 full depth ({rb_k7} rows an item, a last item of "
                      f"{rows_k7 % rb_k7})", (rows_k7, n_k7), "db4", n_k7.bit_length() - 1)
    n_t = cuda_pyramid.K7_TILE
    lv_t = n_t.bit_length() - 1
    grid_t = cuda_pyramid.k7_grid(dev, 1 << 20, n_t, lv_t, 8, cuda_pyramid.k7_plan(n_t, lv_t, 8))
    for rows_k7 in (1, grid_t - 1, grid_t + 1):
        ipyramid_case(f"{rows_k7}x{n_t} db4 L{lv_t} ({rows_k7} items on a grid of {grid_t})",
                      (rows_k7, n_t), "db4", lv_t)
    plan_t = cuda_pyramid.k7_plan(65536, 8, 8)
    grid_t = cuda_pyramid.k7_grid(dev, 1 << 20, 65536, 8, 8, plan_t)
    rows_k7 = grid_t // (65536 // plan_t.tile) + 1
    ipyramid_case(f"{rows_k7}x65536 db4 L8 ({cuda_pyramid.k7_items(rows_k7, 65536, plan_t)} "
                  f"items on a grid of {grid_t})", (rows_k7, 65536), "db4", 8)

    # the rotated forms of K3 and K7 ((R, N) in, (N, R) out): the volume's
    # rows, a row count no item divides, db2 (no unrolled taps), level 0
    errors["K3.rotated"] = errors["K7.rotated"] = 0.0
    for shape_rt, wavelet_rt, level_rt in (((65536, 256), "db4", 6), ((1000, 256), "db4", 8),
                                           ((4096, 64), "db2", 6), ((77, 2048), "sym8", 0)):
        fb_rt = jt.get_filter(wavelet_rt)
        x_rt = signal(shape_rt)
        done_rt = cuda_pyramid.levels_done(shape_rt[1], fb_rt.transform_wavelength, level_rt)
        label_rt = f"{shape_rt[0]}x{shape_rt[1]} {wavelet_rt} L{done_rt}, rotated"
        got_rt = cuda_pyramid.pyramid_rows_rotated(x_rt, fb_rt.dec_lo, fb_rt.dec_hi, done_rt)
        torch.cuda.synchronize()
        errors["K3.rotated"] = max(errors["K3.rotated"], compare(
            f"K3 {label_rt}", got_rt, cuda_pyramid.pyramid_rows_transposed_torch(
                x_rt.double(), fb_rt.dec_lo, fb_rt.dec_hi, done_rt), F32_BOUND))
        args_rt = (fb_rt.rec_lo, fb_rt.rec_hi, fb_rt.recon_gain, done_rt)
        got_rt = cuda_pyramid.ipyramid_rows_rotated(x_rt, *args_rt)
        torch.cuda.synchronize()
        errors["K7.rotated"] = max(errors["K7.rotated"], compare(
            f"K7 {label_rt}", got_rt,
            cuda_pyramid.ipyramid_rows_transposed_torch(x_rt.double(), *args_rt), F32_BOUND))
        del x_rt, got_rt

    def wpt_case(label, shape, wavelet, levels, offset=0):
        """K8 and K9 (the bank's synthesis pair and recon_gain) in both
        layouts against their plain versions in float64 on the same input,
        one launch each; (K8's, K9's) max |err| in the subband layout."""
        fb = jt.get_filter(wavelet)
        x_w = torch.empty(shape[0] * shape[1] + offset, device=dev)[offset:].view(shape)
        x_w.copy_(signal(shape))
        errs = []
        for inter in (False, True):
            lay = "interleaved" if inter else "subband"
            before = jt.ops.launch_counts()
            y_w = cuda_wpt.wpt_rows(x_w, fb.dec_lo, fb.dec_hi, levels, interleaved=inter)
            z_w = cuda_wpt.iwpt_rows(x_w, fb.rec_lo, fb.rec_hi, levels, fb.recon_gain, inter)
            torch.cuda.synchronize()
            after = jt.ops.launch_counts()
            require((after["K8"], after["K9"]) == (before["K8"] + 1, before["K9"] + 1),
                    f"K8/K9 {label} {lay}: not one launch each: {after}")
            errs.append((
                compare(f"K8 {label} {lay}", y_w, cuda_wpt.wpt_analysis_torch(
                    x_w.double(), fb.dec_lo, fb.dec_hi, levels, 1.0, inter), F32_BOUND),
                compare(f"K9 {label} {lay}", z_w, cuda_wpt.wpt_synthesis_torch(
                    x_w.double(), fb.rec_lo, fb.rec_hi, levels, fb.recon_gain, inter),
                    F32_BOUND)))
        return errs[0]

    errors["K8"], errors["K9"] = wpt_case("64x65536 db4 L6", (64, 65536), "db4", 6)
    # K8 and K9 in place on the packet cell's rows (whole rows, 2 an item)
    wpt_case("16384x2048 db4 L6 (whole rows, 2 an item: 8 frames of 2048^2)", (16384, 2048),
             "db4", 6)
    # the rotated forms of K8 and K9 ((F G, n) in, (F, n, G) out): the packet
    # cell's axis pass (8 frames of 2048^2), a short row at a shallow and at
    # full depth with Haar and sym8 (no unrolled taps), and packets shorter
    # than the row (wpt's last chunk at full depth on rows of 256)
    errors["K8.rotated"] = errors["K9.rotated"] = 0.0
    for shape_wr, group_wr, h_wr, wavelet_wr, levels_wr in (
            ((16384, 2048), 2048, 2048, "db4", 6), ((128, 64), 64, 64, "Haar", 6),
            ((128, 64), 64, 64, "sym8", 2), ((512, 256), 256, 4, "db4", 2)):
        fb_wr = jt.get_filter(wavelet_wr)
        x_wr = signal(shape_wr)
        label_wr = (f"{shape_wr[0]}x{shape_wr[1]} {wavelet_wr} L{levels_wr}, packets of {h_wr}, "
                    f"groups of {group_wr}, rotated")
        got_wr = cuda_wpt.wpt_rows_rotated(x_wr, fb_wr.dec_lo, fb_wr.dec_hi, levels_wr,
                                           group_wr, h_wr)
        torch.cuda.synchronize()
        errors["K8.rotated"] = max(errors["K8.rotated"], compare(
            f"K8 {label_wr}", got_wr, cuda_wpt.wpt_analysis_rotated_torch(
                x_wr.double(), fb_wr.dec_lo, fb_wr.dec_hi, levels_wr, group_wr, h_wr),
            F32_BOUND))
        args_wr = (fb_wr.rec_lo, fb_wr.rec_hi, levels_wr, group_wr, h_wr, fb_wr.recon_gain)
        got_wr = cuda_wpt.iwpt_rows_rotated(x_wr, *args_wr)
        torch.cuda.synchronize()
        errors["K9.rotated"] = max(errors["K9.rotated"], compare(
            f"K9 {label_wr}", got_wr, cuda_wpt.wpt_synthesis_rotated_torch(x_wr.double(),
                                                                           *args_wr),
            F32_BOUND))
        del x_wr, got_wr
    for label, shape, wavelet, levels, offset in (
            ("64x1024 db4 L6 (whole rows, 4 an item: wpt's second chunk at full depth)",
             (64, 1024), "db4", 6, 0),
            ("256x16 db4 L4 (whole rows, 256 an item: 105 taps mod 16, the third chunk)",
             (256, 16), "db4", 4, 0),
            ("133x8 db4 L3 (rows of 8)", (133, 8), "db4", 3, 0),
            ("64x65536 Discrete Meyer L3 (62 taps)", (64, 65536), "Discrete Meyer", 3, 0),
            ("16x65536 Haar L6 (no halo)", (16, 65536), "Haar", 6, 0),
            ("16x4096 Haar orthogonal L6 (gain 0.5 a level)", (16, 4096), "Haar orthogonal", 6, 0),
            ("9x16384 sym8 L4 (the generic taps)", (9, 16384), "sym8", 4, 0),
            ("133x4096 db4 L1 (one level)", (133, 4096), "db4", 1, 0),
            ("257x512 db4 L6 (8 rows an item: a last item of 1)", (257, 512), "db4", 6, 0),
            ("3x1048576 db4 L6 (rows of 2^20: 256 items a row)", (3, 1 << 20), "db4", 6, 0),
            ("8x16384 db4 L6 (a source 4 bytes off 16-byte alignment)", (8, 16384), "db4", 6,
             1)):
        wpt_case(label, shape, wavelet, levels, offset)

    def wpt_grid_case(label, shape, levels, grid=None):
        """K8 and K9 (db4) in both layouts on ``grid`` persistent blocks
        (default: wpt_grid's one wave) against their plain versions."""
        fb = jt.get_filter("db4")
        x_w = signal(shape)
        for inter in (False, True):
            lay = "interleaved" if inter else "subband"
            y_w = cuda_wpt._k8(x_w, fb.dec_lo, fb.dec_hi, levels, 1.0, inter, None, grid)
            z_w = cuda_wpt._k9(x_w, fb.rec_lo, fb.rec_hi, levels, fb.recon_gain, inter, None, grid)
            torch.cuda.synchronize()
            compare(f"K8 {label} {lay}", y_w, cuda_wpt.wpt_analysis_torch(
                x_w.double(), fb.dec_lo, fb.dec_hi, levels, 1.0, inter), F32_BOUND)
            compare(f"K9 {label} {lay}", z_w, cuda_wpt.wpt_synthesis_torch(
                x_w.double(), fb.rec_lo, fb.rec_hi, levels, fb.recon_gain, inter), F32_BOUND)

    # the persistent grid, min(items, SMs x blocks an SM): whole-row items
    # (rows of 1024, 4 an item, the last of 3) at grid - 1, grid and grid + 1
    # items of each kernel's grid; tiled items (24 rows of 65536, 16 items a
    # row) on grids forced to items - 1, items and items + 1; forced grids of
    # 1 and 2 on tiled and on whole-row items (1001 rows of 16, 256 an item)
    plan_w = cuda_wpt.wpt_plan(1024, 6, 8)
    for grid_w in sorted({cuda_wpt.wpt_grid(dev, 1 << 20, 1024, 6, 8, inverse_w, plan_w)
                          for inverse_w in (False, True)}):
        for items_w in (grid_w - 1, grid_w, grid_w + 1):
            rows_w = items_w * plan_w.rows - 1
            wpt_grid_case(f"{rows_w}x1024 db4 L6 ({items_w} items of whole rows, a grid of "
                          f"{grid_w})", (rows_w, 1024), 6)
    items_t = cuda_wpt.wpt_items(24, 65536, cuda_wpt.wpt_plan(65536, 6, 8))
    for grid_w in (items_t - 1, items_t, items_t + 1, 1, 2):
        wpt_grid_case(f"24x65536 db4 L6 ({items_t} items on a forced grid of {grid_w})",
                      (24, 65536), 6, grid_w)
    for grid_w in (1, 2):
        wpt_grid_case(f"1001x16 db4 L4 (4 items of whole rows on a forced grid of {grid_w})",
                      (1001, 16), 4, grid_w)

    def fwt2d_case(label, shape, wavelet, level):
        fb = jt.get_filter(wavelet)
        x = signal(shape)
        d_cols = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
        d_rows = cuda_pyramid.levels_done(shape[0], fb.transform_wavelength, level)
        y1 = cuda_pyramid.pyramid_rows_transposed(x, fb.dec_lo, fb.dec_hi, d_cols)
        torch.cuda.synchronize()
        ref1 = cuda_pyramid.pyramid_rows_transposed_torch(x.double(), fb.dec_lo, fb.dec_hi, d_cols)
        err = compare(f"K4 pass {label}", y1, ref1, F32_BOUND)
        y = jt.fwt2d(x, wavelet, level, level)
        torch.cuda.synchronize()
        ref = cuda_pyramid.pyramid_rows_transposed_torch(ref1, fb.dec_lo, fb.dec_hi, d_rows)
        compare(f"fwt2d (K4 x2) {label}", y, ref, F32_BOUND)
        return err

    errors["K4"] = fwt2d_case("2048x2048 db4 L6", (2048, 2048), "db4", 6)
    fwt2d_case("512x1024 Haar L3", (512, 1024), "Haar", 3)
    for label, shape, wavelet, level, gain, offset in (
            ("13x1024 sym8 L6 (a ragged last block of 5 rows)", (13, 1024), "sym8", 6, 1.0, 0),
            ("64x2 Haar L1 (rows of 2: plain-loaded)", (64, 2), "Haar", 1, 1.0, 0),
            ("32x1024 db4 L5 (a source 4 bytes off 16-byte alignment)", (32, 1024), "db4", 5,
             1.0, 1),
            ("16x16384 Haar orthogonal L14, gain 0.5 (one row a block)", (16, 16384),
             "Haar orthogonal", 14, 0.5, 0)):
        fb = jt.get_filter(wavelet)
        xo = torch.empty(shape[0] * shape[1] + offset, device=dev)[offset:].view(shape)
        xo.copy_(signal(shape))
        got = cuda_pyramid.pyramid_rows_transposed(xo, fb.dec_lo, fb.dec_hi, level, gain)
        torch.cuda.synchronize()
        compare(f"K4 pass {label}", got, cuda_pyramid.pyramid_rows_transposed_torch(
            xo.double(), fb.dec_lo, fb.dec_hi, level, gain), F32_BOUND)

    def ifwt2d_case(label, shape, wavelet, level):
        fb = jt.get_filter(wavelet)
        y = signal(shape)
        lr = min(level, shape[0].bit_length() - 1)
        d_cols = cuda_pyramid.levels_done(shape[1], fb.transform_wavelength, level)
        d_rows = cuda_pyramid.levels_done(shape[0], fb.transform_wavelength, lr)
        args = (fb.rec_lo, fb.rec_hi, fb.recon_gain)
        x1 = cuda_pyramid.ipyramid_rows_transposed(y, *args, d_cols)
        torch.cuda.synchronize()
        ref1 = cuda_pyramid.ipyramid_rows_transposed_torch(y.double(), *args, d_cols)
        err = compare(f"K5 pass {label}", x1, ref1, F32_BOUND)
        x = jt.ifwt2d(y, wavelet, lr, level)
        torch.cuda.synchronize()
        ref = cuda_pyramid.ipyramid_rows_transposed_torch(ref1, *args, d_rows)
        compare(f"ifwt2d (K5 x2) {label}", x, ref, F32_BOUND)
        return err

    errors["K5"] = ifwt2d_case("2048x2048 db4 L6", (2048, 2048), "db4", 6)
    ifwt2d_case("512x1024 Haar L3", (512, 1024), "Haar", 3)
    ifwt2d_case("64x16384 sym8 L4", (64, 16384), "sym8", 4)
    ifwt2d_case("256x1024 Battle 23 L8 (partial levels)", (256, 1024), "Battle 23", 8)
    ifwt2d_case("64x64 Haar orthogonal L6 (gain 0.5)", (64, 64), "Haar orthogonal", 6)
    for label, shape, wavelet, level in (
            ("100x2048 db4 L6 (a ragged last block)", (100, 2048), "db4", 6),
            ("37x512 sym8 L5 (scalar stores)", (37, 512), "sym8", 5),
            ("40000x16 Haar L4 (5000 row blocks)", (40000, 16), "Haar", 4)):
        fb = jt.get_filter(wavelet)
        y = signal(shape)
        args = (fb.rec_lo, fb.rec_hi, fb.recon_gain, level)
        got = cuda_pyramid.ipyramid_rows_transposed(y, *args)
        torch.cuda.synchronize()
        compare(f"K5 pass {label}", got,
                cuda_pyramid.ipyramid_rows_transposed_torch(y.double(), *args), F32_BOUND)
    # K4 and K5 in groups: each group of rows (a frame) stored transposed
    # within itself; the 2D FWT cell's pass first, then odd frame counts,
    # groups smaller than a block's rows (blocks of fewer rows) and rows of
    # 4096 (4 a block)
    errors["K4.grouped"] = errors["K5.grouped"] = 0.0
    for shape_g, group_g, wavelet_g, level_g in (
            ((16384, 2048), 2048, "db4", 6),
            ((3 * 64, 64), 64, "Haar", 6),
            ((5 * 16, 1024), 16, "sym8", 5),
            ((7 * 4, 32), 4, "db4", 3),
            ((3 * 16, 4096), 16, "db4", 6)):
        fb_g = jt.get_filter(wavelet_g)
        x_g = signal(shape_g)
        label_g = (f"{shape_g[0]}x{shape_g[1]} {wavelet_g} L{level_g} in groups of "
                   f"{group_g}")
        got = cuda_pyramid.pyramid_rows_transposed(x_g, fb_g.dec_lo, fb_g.dec_hi, level_g,
                                                   group=group_g)
        torch.cuda.synchronize()
        errors["K4.grouped"] = max(errors["K4.grouped"], compare(
            f"K4 pass {label_g}", got, cuda_pyramid.pyramid_rows_transposed_torch(
                x_g.double(), fb_g.dec_lo, fb_g.dec_hi, level_g, group=group_g), F32_BOUND))
        args_g = (fb_g.rec_lo, fb_g.rec_hi, fb_g.recon_gain, level_g)
        got = cuda_pyramid.ipyramid_rows_transposed(x_g, *args_g, group=group_g)
        torch.cuda.synchronize()
        errors["K5.grouped"] = max(errors["K5.grouped"], compare(
            f"K5 pass {label_g}", got, cuda_pyramid.ipyramid_rows_transposed_torch(
                x_g.double(), *args_g, group=group_g), F32_BOUND))
    del x_g, got

    # K6. f32 sums in another order than the plain version: a column's error
    # is at most S * 2^-24 * sum|c| (printed as "derived"); the check holds
    # the 1e-5 of max|ref| bound of K1-K5, which is tighter wherever a bin
    # collects mass of one phase (no cancellation), as here.
    def reassign_case(label, c, k, n_bins):
        got = cuda_reassign.reassign(c, k, n_bins)
        torch.cuda.synchronize()
        ref = cuda_reassign.reassign_torch(c.to(torch.complex128), k, n_bins)
        derived = c.shape[-2] * 2.0**-24 * float(c.abs().sum(dim=-2).max())
        print(json.dumps({"check": f"K6 {label} derived bound",
                          "rel": derived / float(ref.abs().max())}), flush=True)
        return compare(f"K6 {label}", torch.view_as_real(got), torch.view_as_real(ref),
                       F32_BOUND), got

    ssq_scales = jt.generate_log_scales(1e-5, 1e-2, 64)
    ssq_fs = 1e6
    morlet = jt.MorletWavelet(1.0, 1.0)
    xs_np = np.random.default_rng(5).standard_normal((8, 65536)).astype(np.float32)
    xs = torch.as_tensor(xs_np, device=dev)
    W, dW = _cwt_and_derivative(xs, ssq_scales, morlet, ssq_fs, jt.PaddingType.SYMMETRIC)
    mag2 = W.real ** 2 + W.imag ** 2
    gamma = 10.0 * math.sqrt(torch.finfo(torch.float32).eps) * mag2.amax(
        dim=(-2, -1), keepdim=True).sqrt()
    bins = _default_bins(ssq_scales, morlet.center_frequency, None)
    wgt = ssq_scales ** -0.5 * _log_measure(ssq_scales)
    contrib, k_idx = _reassign_inputs(W, dW, wgt, bins, gamma, "clip")
    bins128 = np.exp(np.linspace(np.log(bins[0]), np.log(bins[-1]), 128))
    _, k_idx128 = _reassign_inputs(W, dW, wgt, bins128, gamma, "clip")
    # K6's fused form on the same block (W and dW in, the phase transform and
    # the bin index inside, after the peak kernel): its bins are the eager
    # path's, so its plane is the unfused kernel's on these indices
    tx_fused = cuda_reassign.squeeze(W, dW, torch.as_tensor(wgt, device=dev), None,
                                     _bin_grid(bins, None, dev), "clip")

    # the peak kernel: each row's max |W|^2, to the bit torch.amax's
    def peak_case(label, w):
        got = cuda_reassign.row_peaks(w)
        ref = torch.amax(w.real ** 2 + w.imag ** 2, dim=(-2, -1)).reshape(-1)
        torch.cuda.synchronize()
        same = bool(torch.equal(got.view(torch.int32), ref.view(torch.int32)))
        err = float((got - ref).abs().max())
        print(json.dumps({"check": f"peak kernel {label} against torch.amax, bit for bit",
                          "bitwise_equal": same, "max_abs_err": err}), flush=True)
        require(same, f"peak kernel {label}: {got.tolist()[:4]} against {ref.tolist()[:4]}")
        return err

    errors["K6.peak"] = max(peak_case("8x64x65536", W),
                            peak_case("8x64x65535 (an odd last column, a strided view)",
                                      W[..., :65535]))
    del W, dW, mag2
    require(contrib.dtype == torch.complex64 and k_idx.dtype == torch.int32,
            f"ssq block {contrib.dtype} {k_idx.dtype}")
    errors["K6"], tx_main = reassign_case("8x64x65536 K=64 (indices of ssq_cwt)",
                                          contrib, k_idx, 64)
    moved = float((tx_fused - tx_main).abs().double().sum()) / float(
        2 * torch.where(k_idx < 64, contrib.abs(), 0).double().sum())
    print(json.dumps({"check": "K6 fused 8x64x65536 K=64 against K6 on the eager indices",
                      "bitwise_equal": bool(torch.equal(torch.view_as_real(tx_fused),
                                                        torch.view_as_real(tx_main))),
                      "moved_share": moved, "bound": 1e-5}), flush=True)
    require(moved <= 1e-5, f"K6's fused form moved {moved} of the kept weight")
    errors["K6.fused"] = float((tx_fused - tx_main).abs().max())
    del tx_fused
    kept = torch.where(k_idx < 64, contrib, 0).sum(dim=-2)
    compare("K6 column sums = kept weighted scale sums (clip)",
            torch.view_as_real(tx_main.sum(dim=-2)), torch.view_as_real(kept), F32_BOUND)
    del tx_main, kept
    reassign_case("8x64x65536 K=128 (the same coefficients on 128 bins: two bin chunks)",
                  contrib, k_idx128, 128)

    def rand_case(label, g, s_, n, n_bins):
        c = torch.complex(signal((g, s_, n)), signal((g, s_, n)))
        k = torch.as_tensor(rng.integers(-3, n_bins + 4, (g, s_, n)), dtype=torch.int32,
                            device=dev)
        reassign_case(label, c, k, n_bins)

    rand_case("2x12x300 K=20 (unaligned, indices in [-3, K+3])", 2, 12, 300, 20)
    rand_case("3x16x1000 K=200 (four bin chunks)", 3, 16, 1000, 200)
    torch.cuda.synchronize()

    # ---- 4a. the MODWT + FWT path through the entry points --------------
    reset_counts, read_counts = jt.ops.reset_launch_counts, jt.ops.launch_counts

    x64 = np.random.default_rng(1).standard_normal((64, 65536)).astype(np.float32)
    img = np.random.default_rng(2).standard_normal((2048, 2048)).astype(np.float32)
    reset_counts()
    x = torch.as_tensor(x64, device=dev)
    coeffs = jt.modwt(x, "Daubechies 4", 5)
    xr = jt.imodwt(coeffs, "Daubechies 4")
    fwt_t = jt.TransformBuilder.create("Fast Wavelet Transform", "db4")
    rows_c = fwt_t.get_basic_transform().forward(x64)      # numpy rows -> "cuda" by default
    rows_back = fwt_t.get_basic_transform().reverse(rows_c)
    img_c = fwt_t.forward(img)                              # 2D dispatch -> fwt2d
    img_back = fwt_t.reverse(img_c)
    torch.cuda.synchronize()
    launches = read_counts()
    print(json.dumps({"main_path": "MODWT + FWT", "launches": launches}), flush=True)
    require(all(launches[k] >= 1 for k in ("K1", "K2", "K3", "K4", "K5")),
            f"a kernel of the MODWT + FWT path was not launched: {launches}")
    require(launches["K7"] == 1, f"the FWT facade's reverse of the rows launched K7 "
            f"{launches['K7']} times, not once")
    for label, got, want, shape in (
        ("modwt->imodwt 64x65536 db4 L5", xr, x64, (64, 65536)),
        ("fwt->ifwt rows 64x65536 db4", rows_back, x64, (64, 65536)),
        ("fwt2d->ifwt2d 2048x2048 db4", img_back, img, (2048, 2048)),
    ):
        require(got.is_cuda and tuple(got.shape) == shape and bool(torch.isfinite(got).all()),
                f"{label}: not a finite CUDA tensor of shape {shape}")
        err = float((got.double().cpu() - torch.as_tensor(want).double()).abs().max())
        print(json.dumps({"roundtrip": label, "max_abs_err": err}), flush=True)
        require(err < 1e-4, f"{label}: round trip error {err}")
    require(tuple(coeffs.shape) == (64, 6, 65536) and coeffs.dtype == torch.float32,
            f"modwt output {tuple(coeffs.shape)} {coeffs.dtype}")
    require(tuple(rows_c.shape) == (64, 65536) and tuple(img_c.shape) == (2048, 2048),
            "FWT output shapes")

    # ---- 4a'. the volume's main path: the FWT facade's 3D forward, then its
    # reverse, on a 256^3 f32 volume at (6, 6, 6), the launch counts set to 0
    # just before each: three rotated K3 passes, then three rotated K7 passes,
    # each result against the separable ndim path over fwt and ifwt
    from jwave_tpu_torch.transforms import ndim as jt_ndim
    from jwave_tpu_torch.transforms.fwt import fwt3d, ifwt3d
    from jwave_tpu_torch.utils import profiling

    vol_np = np.random.default_rng(11).standard_normal((256, 256, 256)).astype(np.float32)
    vol = torch.as_tensor(vol_np, device=dev)
    vol_launches, vol_out = {}, {}
    for name_v, fn_v in (("forward", lambda: fwt_t.forward(vol, 6, 6, 6)),
                         ("reverse", lambda: fwt_t.reverse(vol_out["forward"], 6, 6, 6))):
        reset_counts()
        passes_v = profiling.counts()[cuda_pyramid.ROTATED_PASSES]
        vol_out[name_v] = fn_v()
        torch.cuda.synchronize()
        counts_v = read_counts()
        counts_v["ndim.rotated_passes"] = (profiling.counts()[cuda_pyramid.ROTATED_PASSES]
                                           - passes_v)
        vol_launches[name_v] = counts_v
        print(json.dumps({"main_path": f"FWT facade {name_v}_3d 256^3 db4 (6, 6, 6)",
                          "launches": counts_v}), flush=True)
    k_v = {"forward": "K3", "reverse": "K7"}
    for name_v, counts_v in vol_launches.items():
        require(counts_v[k_v[name_v]] == 3 and counts_v["ndim.rotated_passes"] == 3
                and not any(v for k, v in counts_v.items()
                            if k not in (k_v[name_v], "ndim.rotated_passes")),
                f"the facade's {name_v}_3d did not run three rotated {k_v[name_v]} passes and "
                f"nothing else: {counts_v}")
    compare("FWT facade forward_3d 256^3 db4 (6, 6, 6) against the separable ndim path",
            vol_out["forward"],
            jt_ndim.forward_3d(lambda v, lvl: jt.fwt(v, "db4", lvl), vol, 6, 6, 6), F32_BOUND)
    compare("FWT facade reverse_3d 256^3 db4 (6, 6, 6) against the separable ndim path",
            vol_out["reverse"], jt_ndim.reverse_3d(lambda v, lvl: jt.ifwt(v, "db4", lvl),
                                                   vol_out["forward"], 6, 6, 6), F32_BOUND)
    compare("FWT facade reverse_3d(forward_3d(v)) = v, 256^3 db4 (6, 6, 6)", vol_out["reverse"],
            vol, F32_BOUND)
    del vol, vol_np, vol_out

    # ---- 4a''. the packet cell's main path: the WPT facade's 2D forward,
    # then its reverse, on an (8, 2048, 2048) f32 stack at (6, 6), the counts
    # set to 0 just before each: one rotated K8 (K9) an axis on 16384 rows
    # of 2048 and no transposing copy, against the facade's float64 run
    # (the separable path) and the stack
    wpt2d_t = jt.api.WaveletPacketTransform("Daubechies 4")
    stack = torch.as_tensor(
        np.random.default_rng(13).standard_normal((8, 2048, 2048)).astype(np.float32),
        device=dev)
    stack_launches, stack_out = {}, {}
    for name_s, fn_s in (("forward", lambda: wpt2d_t.forward_2d(stack, 6, 6)),
                         ("reverse", lambda: wpt2d_t.reverse_2d(stack_out["forward"], 6, 6))):
        reset_counts()
        before_s = profiling.counts()
        stack_out[name_s] = fn_s()
        torch.cuda.synchronize()
        counts_s = read_counts()
        for key_s in ("ndim.transposes", "ndim.rotated_passes"):
            counts_s[key_s] = profiling.counts()[key_s] - before_s[key_s]
        stack_launches[name_s] = counts_s
        print(json.dumps({"main_path": f"WPT facade {name_s}_2d (8, 2048, 2048) db4 (6, 6)",
                          "launches": counts_s}), flush=True)
    k_s = {"forward": "K8", "reverse": "K9"}
    for name_s, counts_s in stack_launches.items():
        require(counts_s[k_s[name_s]] == 2 and counts_s["ndim.rotated_passes"] == 2
                and not any(v for k, v in counts_s.items()
                            if k not in (k_s[name_s], "ndim.rotated_passes")),
                f"the facade's {name_s}_2d did not run two rotated {k_s[name_s]} passes and "
                f"nothing else (no transposing copy): {counts_s}")
    stack64 = stack.double()
    compare("WPT facade forward_2d (8, 2048, 2048) db4 (6, 6) f32 against float64",
            stack_out["forward"], wpt2d_t.forward_2d(stack64, 6, 6), F32_BOUND)
    compare("WPT facade reverse_2d (8, 2048, 2048) db4 (6, 6) f32 against float64",
            stack_out["reverse"], wpt2d_t.reverse_2d(stack_out["forward"].double(), 6, 6),
            F32_BOUND)
    compare("WPT facade reverse_2d(forward_2d(s)) = s, (8, 2048, 2048) db4 (6, 6)",
            stack_out["reverse"], stack, F32_BOUND)
    del stack, stack64, stack_out

    # ---- 4a'''. the 2D FWT cell's main path: the FWT facade's 2D forward,
    # then its reverse, on an (8, 2048, 2048) f32 stack at (6, 6), the counts
    # set to 0 just before each: two K4 (K5) launches in groups of 2048 on
    # 16384 rows of 2048 and no K3, K7 or transposing copy, against the plain
    # grouped forms in float64, the facade's float64 run (the separable
    # path) and the stack
    fwt2d_t = jt.api.FastWaveletTransform("Daubechies 4")
    stack = torch.as_tensor(
        np.random.default_rng(16).standard_normal((8, 2048, 2048)).astype(np.float32),
        device=dev)
    frames_launches, frames_out = {}, {}
    for name_f, fn_f in (("forward", lambda: fwt2d_t.forward_2d(stack, 6, 6)),
                         ("reverse", lambda: fwt2d_t.reverse_2d(frames_out["forward"], 6, 6))):
        reset_counts()
        before_f = profiling.counts()
        frames_out[name_f] = fn_f()
        torch.cuda.synchronize()
        counts_f = read_counts()
        for key_f in ("ndim.transposes", "ndim.rotated_passes"):
            counts_f[key_f] = profiling.counts()[key_f] - before_f[key_f]
        frames_launches[name_f] = counts_f
        print(json.dumps({"main_path": f"FWT facade {name_f}_2d (8, 2048, 2048) db4 (6, 6)",
                          "launches": counts_f}), flush=True)
    k_f = {"forward": "K4", "reverse": "K5"}
    for name_f, counts_f in frames_launches.items():
        require(counts_f[k_f[name_f]] == 2 and counts_f["ndim.rotated_passes"] == 2
                and not any(v for k, v in counts_f.items()
                            if k not in (k_f[name_f], "ndim.rotated_passes")),
                f"the FWT facade's {name_f}_2d did not run two grouped {k_f[name_f]} passes "
                f"and nothing else (no K3, K7 or transposing copy): {counts_f}")
    fb_f = jt.get_filter("Daubechies 4")
    done_f = cuda_pyramid.levels_done(2048, fb_f.transform_wavelength, 6)
    rows64 = stack.double().view(-1, 2048)
    for _ in range(2):  # W, then H: each frame stored transposed within itself
        rows64 = cuda_pyramid.pyramid_rows_transposed_torch(
            rows64, fb_f.dec_lo, fb_f.dec_hi, done_f, group=2048)
    compare("FWT facade forward_2d (8, 2048, 2048) db4 (6, 6) f32 against the plain grouped "
            "K4 x2 in float64", frames_out["forward"], rows64.view(8, 2048, 2048), F32_BOUND)
    compare("FWT facade forward_2d (8, 2048, 2048) db4 (6, 6) f32 against its float64 run "
            "(the separable path)", frames_out["forward"],
            fwt2d_t.forward_2d(stack.double(), 6, 6), F32_BOUND)
    rows64 = frames_out["forward"].double().view(-1, 2048)
    for _ in range(2):
        rows64 = cuda_pyramid.ipyramid_rows_transposed_torch(
            rows64, fb_f.rec_lo, fb_f.rec_hi, fb_f.recon_gain, done_f, group=2048)
    compare("FWT facade reverse_2d (8, 2048, 2048) db4 (6, 6) f32 against the plain grouped "
            "K5 x2 in float64", frames_out["reverse"], rows64.view(8, 2048, 2048), F32_BOUND)
    compare("FWT facade reverse_2d(forward_2d(s)) = s, (8, 2048, 2048) db4 (6, 6)",
            frames_out["reverse"], stack, F32_BOUND)
    del stack, rows64, frames_out

    # small inputs against the float64 numpy oracle
    small = np.random.default_rng(3).standard_normal((2, 300))
    c_small = jt.modwt(torch.as_tensor(small, dtype=torch.float32, device=dev), "db4", 4)
    want = np.stack([oracle.modwt(r, jt.get_filter("db4"), 4) for r in small])
    err = float(np.abs(c_small.cpu().double().numpy() - want).max())
    print(json.dumps({"oracle": "modwt 2x300 db4 L4", "max_abs_err": err}), flush=True)
    require(err <= F32_BOUND * np.abs(want).max(), "modwt against the oracle")
    sm = np.random.default_rng(4).standard_normal((64, 64))
    fb = jt.get_filter("db4")
    y_small = jt.fwt2d(torch.as_tensor(sm, dtype=torch.float32, device=dev), "db4")
    want2 = np.stack([oracle.fwt(r, fb, 6) for r in sm])
    want2 = np.stack([oracle.fwt(c, fb, 6) for c in want2.T]).T
    err = float(np.abs(y_small.cpu().double().numpy() - want2).max())
    print(json.dumps({"oracle": "fwt2d 64x64 db4", "max_abs_err": err}), flush=True)
    require(err <= F32_BOUND * np.abs(want2).max(), "fwt2d against the oracle")
    y1 = jt.fwt(torch.as_tensor(sm, dtype=torch.float32, device=dev), "db4", 5)
    want1 = np.stack([oracle.fwt(r, fb, 5) for r in sm])
    err = float(np.abs(y1.cpu().double().numpy() - want1).max())
    print(json.dumps({"oracle": "fwt 64x64 db4 L5", "max_abs_err": err}), flush=True)
    require(err <= F32_BOUND * np.abs(want1).max(), "fwt against the oracle")
    torch.cuda.synchronize()

    # ---- 4b. the continuous path through the entry points ---------------
    reset_counts()
    res = jt.ssq_cwt(xs, ssq_scales, morlet, ssq_fs)
    xr_ssq = jt.issq_cwt(res, morlet)
    fs_s = 1000.0
    t_s = np.arange(4096) / fs_s
    small_scales = jt.generate_log_scales(0.002, 0.2, 128)
    two = np.cos(2 * np.pi * 40.0 * t_s) + 0.5 * np.cos(2 * np.pi * 150.0 * t_s + 1.0)
    two_c = torch.as_tensor(two, dtype=torch.float32, device=dev)
    # the float64 default threshold, so that f32 keeps the same coefficients
    # as tests/test_ssq.py's float64 run (the f32 default, 10*sqrt(2^-23) of
    # max|W|, drops more of the tails; its round trip is printed beside)
    w_two = jt.cwt(two_c, small_scales, morlet, fs_s).coefficients
    g64 = 10.0 * math.sqrt(np.finfo(np.float64).eps) * float(w_two.abs().max())
    res_two = jt.ssq_cwt(two_c, small_scales, morlet, fs_s, gamma=g64)
    two_back = jt.issq_cwt(res_two, morlet)
    two_back_default = jt.issq_cwt(jt.ssq_cwt(two_c, small_scales, morlet, fs_s), morlet)
    ridge_res = jt.ssq_cwt(torch.as_tensor(np.cos(2 * np.pi * 40.0 * t_s)
                                           + 0.8 * np.cos(2 * np.pi * 160.0 * t_s + 0.9),
                                           dtype=torch.float32, device=dev),
                           small_scales, morlet, fs_s)
    idx, ridge_f = jt.extract_ridge(ridge_res, n_ridges=2, tube_width=3)
    tube = jt.ridge_tube_mask(ridge_res, idx[0], tube_width=4)
    mode = jt.issq_cwt(ridge_res, morlet, band=tube)
    cwt_t = jt.TransformBuilder.create("Continuous Wavelet Transform", "morlet")
    scal = cwt_t.get_basic_transform().transform_fft(xs_np, ssq_scales, ssq_fs)
    small = np.random.default_rng(6).standard_normal((2, 1000)).astype(np.float32)
    direct = cwt_t.get_basic_transform().transform(small, [2.0, 5.0, 13.0, 40.0], 1.0)
    torch.cuda.synchronize()
    launches_ssq = read_counts()
    print(json.dumps({"main_path": "continuous (ssq_cwt, issq_cwt, ridges, CWT facade)",
                      "launches": launches_ssq}), flush=True)
    require(launches_ssq["K6"] >= 1, f"K6 was not launched on the continuous path: {launches_ssq}")
    # every ssq_cwt here is complex64 on the card with no gradient: K6's
    # fused form, after the peak kernel where gamma is the default
    require(launches_ssq["K6.fused"] == launches_ssq["K6"] and launches_ssq["K6.peak"] >= 1,
            f"the continuous path did not take K6's fused form and the peak kernel: "
            f"{launches_ssq}")
    main_launches = dict(launches)  # phase 4a's counts: K6 is 0 there
    launches["K6"] = launches_ssq["K6"]
    for k in ("K6.fused", "K6.peak"):  # their main path is this phase's
        launches[k] = main_launches[k] = launches_ssq[k]

    require(res.Tx.is_cuda and res.Tx.dtype == torch.complex64
            and tuple(res.Tx.shape) == (8, 64, 65536) and bool(torch.isfinite(res.Tx).all()),
            f"ssq_cwt Tx {res.Tx.dtype} {tuple(res.Tx.shape)}")
    require(xr_ssq.is_cuda and tuple(xr_ssq.shape) == (8, 65536)
            and bool(torch.isfinite(xr_ssq).all()), "issq_cwt output")
    tx_plain = jt.ssq_cwt(xs, ssq_scales, morlet, ssq_fs, reassign="scatter").Tx
    compare("ssq_cwt 8x65536: K6 route against the plain scatter route",
            torch.view_as_real(res.Tx), torch.view_as_real(tx_plain), F32_BOUND)
    del tx_plain
    interior = slice(4096 // 8, -4096 // 8)
    err = float(np.abs(two_back.double().cpu().numpy() - two)[interior].max())
    err_d = float(np.abs(two_back_default.double().cpu().numpy() - two)[interior].max())
    print(json.dumps({"roundtrip": "ssq_cwt->issq_cwt two tones 4096 f32, 128 scales",
                      "max_abs_err": err, "bound": 2e-3,
                      "max_abs_err_f32_default_gamma": err_d}), flush=True)
    require(err < 2e-3, f"two-tone issq round trip {err}")
    tone_res = jt.ssq_cwt(torch.as_tensor(np.cos(2 * np.pi * 50.0 * t_s), dtype=torch.float32,
                                          device=dev), small_scales, morlet, fs_s)
    ridge_hz = float(tone_res.ridge()[1024:3072].median())
    print(json.dumps({"ridge": "50 Hz tone", "median_hz": ridge_hz}), flush=True)
    require(abs(ridge_hz - 50.0) / 50.0 < 0.05, f"tone ridge at {ridge_hz} Hz")
    mid = slice(1024, 3072)
    meds = sorted(float(ridge_f[r, mid].median()) for r in range(2))
    print(json.dumps({"ridges": "40 + 160 Hz", "median_hz": meds}), flush=True)
    require(tuple(idx.shape) == (2, 4096) and abs(meds[0] - 40.0) / 40.0 < 0.05
            and abs(meds[1] - 160.0) / 160.0 < 0.05, f"extract_ridge medians {meds}")
    require(tube.dtype == torch.bool and tuple(tube.shape) == (128, 4096)
            and bool(torch.isfinite(mode).all()), "ridge_tube_mask / band reconstruction")
    require(tuple(scal.coefficients.shape) == (8, 64, 65536)
            and scal.coefficients.dtype == torch.complex64
            and bool(torch.isfinite(scal.coefficients).all()), "CWT facade transform_fft")
    # small inputs against the port's own plain float64 run on the CPU
    want_d = jt.cwt_direct(small.astype(np.float64), [2.0, 5.0, 13.0, 40.0], "morlet", 1.0)
    compare("CWT facade transform (cwt_direct) 2x1000 against CPU f64",
            torch.view_as_real(direct.coefficients),
            torch.view_as_real(want_d.coefficients).to(dev), F32_BOUND)
    want_f = jt.cwt(small.astype(np.float64), ssq_scales[::8] * 1e3, "morlet", 1e3)
    got_f = cwt_t.get_basic_transform().transform_fft(small, ssq_scales[::8] * 1e3, 1e3)
    compare("CWT facade transform_fft 2x1000 against CPU f64",
            torch.view_as_real(got_f.coefficients),
            torch.view_as_real(want_f.coefficients).to(dev), F32_BOUND)
    torch.cuda.synchronize()

    def path(name, fn, need=()):
        """Drive one path with the launch counts set to 0 just before it and
        read just after; the kernels in ``need`` must have launched."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        print(json.dumps({"main_path": name, "launches": counts}), flush=True)
        require(all(counts[k] >= 1 for k in need), f"{name}: {need} not all launched: {counts}")
        return out

    def finite(t, shape, label):
        require(t.is_cuda and tuple(t.shape) == tuple(shape) and bool(torch.isfinite(t).all()),
                f"{label}: not a finite CUDA tensor of shape {shape}: {tuple(t.shape)}")

    # ---- 4c. gradients through K1-K5 --------------------------------------
    backward = {}

    def grad_case(label, entry, plain, x_np, need):
        """grad of (entry(x) * w).sum() on the card (backward launches read on
        their own) against autograd through ``plain`` in float64."""
        xg = torch.as_tensor(x_np, dtype=torch.float32, device=dev).requires_grad_()
        y = entry(xg)
        w = torch.as_tensor(np.random.default_rng(7).standard_normal(tuple(y.shape)),
                            dtype=torch.float32, device=dev)
        loss = (y * w).sum()
        torch.cuda.synchronize()
        (g,) = path(f"backward of {label}", lambda: torch.autograd.grad(loss, xg), need)
        finite(g, x_np.shape, f"grad {label}")
        x_ref = xg.detach().double().requires_grad_()
        (ref,) = torch.autograd.grad((plain(x_ref) * w.double()).sum(), x_ref)
        return compare(f"grad {label} against autograd of the plain versions in f64", g, ref,
                       F32_BOUND)

    gm, hm = _modwt_base_filters("db4")
    fb4 = jt.get_filter("db4")
    c_np = np.random.default_rng(8).standard_normal((64, 6, 65536)).astype(np.float32)
    backward["K1"] = ("K2 imodwt_cascade", grad_case(
        "modwt db4 L5 64x65536", lambda a: jt.modwt(a, "db4", 5),
        lambda a: cuda_modwt.modwt_cascade_torch(a, gm, hm, 5), x64, ("K2",)))
    backward["K2"] = ("K1 modwt_cascade", grad_case(
        "imodwt db4 L5 64x6x65536", lambda a: jt.imodwt(a, "db4"),
        lambda a: cuda_modwt.imodwt_cascade_torch(a, gm, hm), c_np, ("K1",)))
    del c_np
    backward["K3"] = ("K7 ipyramid_rows with the analysis filters, gain 1", grad_case(
        "fwt db4 L8 64x65536", lambda a: jt.fwt(a, "db4", 8),
        lambda a: cuda_pyramid.pyramid_rows_torch(a, fb4.dec_lo, fb4.dec_hi, 8), x64, ("K7",)))
    backward["K7"] = ("K3 pyramid_rows with the synthesis filters, gain recon_gain", grad_case(
        "ifwt db4 L8 64x65536", lambda a: jt.ifwt(a, "db4", 8),
        lambda a: cuda_pyramid.ipyramid_rows_torch(a, fb4.rec_lo, fb4.rec_hi, fb4.recon_gain, 8),
        x64, ("K3",)))

    def k4x2_plain(a, fb, levels):
        return cuda_pyramid.pyramid_rows_transposed_torch(
            cuda_pyramid.pyramid_rows_transposed_torch(a, fb.dec_lo, fb.dec_hi, levels),
            fb.dec_lo, fb.dec_hi, levels)

    def k5x2_plain(a, fb, levels):
        args = (fb.rec_lo, fb.rec_hi, fb.recon_gain)
        return cuda_pyramid.ipyramid_rows_transposed_torch(
            cuda_pyramid.ipyramid_rows_transposed_torch(a, *args, levels), *args, levels)

    backward["K4"] = ("K5 x2 with the analysis filters, gain 1", grad_case(
        "fwt2d db4 L6 2048x2048", lambda a: jt.fwt2d(a, "db4", 6, 6),
        lambda a: k4x2_plain(a, fb4, 6), img, ("K5",)))
    backward["K5"] = ("K4 x2 with the synthesis filters, gain recon_gain", grad_case(
        "ifwt2d db4 L6 2048x2048", lambda a: jt.ifwt2d(a, "db4", 6, 6),
        lambda a: k5x2_plain(a, fb4, 6), img, ("K4",)))
    backward["K8"] = ("K9 iwpt_rows with the analysis filters, gain 1", grad_case(
        "wpt db4 L6 64x65536", lambda a: jt.wpt(a, "db4", 6),
        lambda a: cuda_wpt.wpt_analysis_torch(a, fb4.dec_lo, fb4.dec_hi, 6), x64, ("K9",)))
    backward["K9"] = ("K8 wpt_rows with the synthesis filters, gain recon_gain", grad_case(
        "iwpt db4 L6 64x65536", lambda a: jt.iwpt(a, "db4", 6),
        lambda a: cuda_wpt.wpt_synthesis_torch(a, fb4.rec_lo, fb4.rec_hi, 6, fb4.recon_gain),
        x64, ("K8",)))
    grad_case("wpt db4 full depth 64x65536 (K9 once a fused chunk; plain: the conv form)",
              lambda a: jt.wpt(a, "db4"), lambda a: jt.wpt(a, "db4"), x64, ("K9",))
    def rotated_plain(a, rows_fn, levels):
        """Three rotated passes of the plain K4/K5 functions, (P, Q, R) back
        to (P, Q, R), as fwt3d's and ifwt3d's route runs them."""
        for lv in levels:
            p_, q_, r_ = a.shape
            a = rows_fn(a.reshape(p_ * q_, r_), lv).reshape(r_, p_, q_)
        return a

    vol_g = np.random.default_rng(12).standard_normal((32, 64, 128)).astype(np.float32)
    backward["K3.rotated"] = ("K7 ipyramid_rows in place on the transposed gradient", grad_case(
        "fwt3d (32, 64, 128) db4 levels (3, 4, 5)", lambda a: fwt3d(a, "db4", 3, 4, 5),
        lambda a: rotated_plain(a, lambda r, lv: cuda_pyramid.pyramid_rows_transposed_torch(
            r, fb4.dec_lo, fb4.dec_hi, lv), (5, 4, 3)), vol_g, ("K7",)))
    backward["K7.rotated"] = ("K3 pyramid_rows in place on the transposed gradient", grad_case(
        "ifwt3d (32, 64, 128) db4 levels (3, 4, 5)", lambda a: ifwt3d(a, "db4", 3, 4, 5),
        lambda a: rotated_plain(a, lambda r, lv: cuda_pyramid.ipyramid_rows_transposed_torch(
            r, fb4.rec_lo, fb4.rec_hi, fb4.recon_gain, lv), (5, 4, 3)), vol_g, ("K3",)))
    del vol_g
    # the WPT facade's 2D pair on a small stack, each axis pass against the
    # separable ndim path over the plain K8/K9 functions
    wpt2d_g = jt.api.WaveletPacketTransform("Daubechies 4")
    stack_g = np.random.default_rng(14).standard_normal((2, 256, 512)).astype(np.float32)
    backward["K8.rotated"] = ("K9 iwpt_rows in place on the unrotated gradient, an axis",
                            grad_case("WPT facade forward_2d (2, 256, 512) db4 (6, 6)",
                                      lambda a: wpt2d_g.forward_2d(a, 6, 6),
                                      lambda a: ndim.forward_2d(
                                          lambda v, lv: cuda_wpt.wpt_analysis_torch(
                                              v.reshape(-1, v.shape[-1]), fb4.dec_lo,
                                              fb4.dec_hi, lv).reshape(v.shape), a, 6, 6),
                                      stack_g, ("K9",)))
    backward["K9.rotated"] = ("K8 wpt_rows in place on the unrotated gradient, an axis",
                            grad_case("WPT facade reverse_2d (2, 256, 512) db4 (6, 6)",
                                      lambda a: wpt2d_g.reverse_2d(a, 6, 6),
                                      lambda a: ndim.reverse_2d(
                                          lambda v, lv: cuda_wpt.wpt_synthesis_torch(
                                              v.reshape(-1, v.shape[-1]), fb4.rec_lo,
                                              fb4.rec_hi, lv, fb4.recon_gain).reshape(v.shape),
                                          a, 6, 6),
                                      stack_g, ("K8",)))
    # the FWT facade's 2D pair on the same stack: K4 and K5 in groups, each
    # the other's backward, against the separable ndim path over the plain
    # K3/K7 functions
    fwt2d_g = jt.api.FastWaveletTransform("Daubechies 4")
    backward["K4.grouped"] = ("K5 in groups on the gradient unrotated within each frame",
                              grad_case("FWT facade forward_2d (2, 256, 512) db4 (6, 6)",
                                        lambda a: fwt2d_g.forward_2d(a, 6, 6),
                                        lambda a: ndim.forward_2d(
                                            lambda v, lv: cuda_pyramid.pyramid_rows_torch(
                                                v.reshape(-1, v.shape[-1]), fb4.dec_lo,
                                                fb4.dec_hi, lv).reshape(v.shape), a, 6, 6),
                                        stack_g, ("K5",)))
    backward["K5.grouped"] = ("K4 in groups on the gradient unrotated within each frame",
                              grad_case("FWT facade reverse_2d (2, 256, 512) db4 (6, 6)",
                                        lambda a: fwt2d_g.reverse_2d(a, 6, 6),
                                        lambda a: ndim.reverse_2d(
                                            lambda v, lv: cuda_pyramid.ipyramid_rows_torch(
                                                v.reshape(-1, v.shape[-1]), fb4.rec_lo,
                                                fb4.rec_hi, fb4.recon_gain,
                                                lv).reshape(v.shape), a, 6, 6),
                                        stack_g, ("K4",)))
    del stack_g
    fbh = jt.get_filter("Haar orthogonal")
    grad_case("ifwt2d Haar orthogonal 256x256 (gain 0.5)",
              lambda a: jt.ifwt2d(a, "Haar orthogonal"), lambda a: k5x2_plain(a, fbh, 8),
              img[:256, :256], ("K4",))
    xh = torch.as_tensor(np.random.default_rng(9).standard_normal((8, 65536)), dtype=torch.float32,
                         device=dev).requires_grad_()
    hurst = path("hurst_exponent 8x65536 (auto level 13): forward",
                 lambda: jt.hurst_exponent(xh), ("K1",))
    (gh,) = path("hurst_exponent: backward", lambda: torch.autograd.grad(hurst.sum(), xh), ("K2",))
    finite(gh, (8, 65536), "hurst_exponent grad")
    xh64 = xh.detach().double().requires_grad_()
    (gh64,) = torch.autograd.grad(jt.hurst_exponent(xh64).sum(), xh64)
    compare("hurst_exponent grad against the float64 direct/FFT route", gh, gh64, F32_BOUND)
    ct = contrib[:, :, :4096].contiguous().requires_grad_()
    wt = torch.as_tensor(np.random.default_rng(10).standard_normal((8, 64, 4096)),
                         dtype=torch.float32, device=dev)
    kt = k_idx[:, :, :4096].contiguous()
    (g6,) = torch.autograd.grad((cuda_reassign.reassign(ct, kt, 64).abs() ** 2 * wt).sum(), ct)
    c128 = ct.detach().to(torch.complex128).requires_grad_()
    (g6_ref,) = torch.autograd.grad(
        (cuda_reassign.reassign_torch(c128, kt, 64).abs() ** 2 * wt.double()).sum(), c128)
    backward["K6"] = ("gather ct[k_idx]", compare(
        "grad K6 8x64x4096 against autograd of the plain scatter in c128",
        torch.view_as_real(g6), torch.view_as_real(g6_ref), F32_BOUND))
    del ct, c128, g6, g6_ref
    torch.cuda.synchronize()

    # ---- 4d. the MODWT analysis layer -------------------------------------
    mra = path("modwt_mra db4 L5 64x65536", lambda: jt.modwt_mra(x, "db4", 5), ("K1", "K2"))
    finite(mra, (64, 6, 65536), "modwt_mra")
    compare("modwt_mra components sum to x", mra.sum(dim=-2), x, F32_BOUND)
    compare("modwt_mra against the float64 route", mra, jt.modwt_mra(x.double(), "db4", 5),
            F32_BOUND)
    del mra
    ximg = torch.as_tensor(img, device=dev)

    def mw2():
        c = jt.modwt_2d(ximg, "db4", 5)
        return c, jt.imodwt_2d(c, "db4")

    c2, back2 = path("modwt_2d -> imodwt_2d db4 L5 2048x2048", mw2, ("K1", "K2"))
    finite(c2, (6, 6, 2048, 2048), "modwt_2d")
    compare("imodwt_2d(modwt_2d(x)) = x", back2, ximg, F32_BOUND)
    compare("modwt_2d against the float64 route", c2, jt.modwt_2d(ximg.double(), "db4", 5),
            F32_BOUND)
    del c2, back2
    sub = ximg[:1024, :1024]
    mra2 = path("modwt_mra_2d db4 L3 1024x1024", lambda: jt.modwt_mra_2d(sub, "db4", 3),
                ("K1", "K2"))
    finite(mra2, (4, 4, 1024, 1024), "modwt_mra_2d")
    compare("modwt_mra_2d components sum to x", mra2.sum(dim=(0, 1)), sub, F32_BOUND)
    del mra2
    y2 = 0.6 * x + torch.as_tensor(np.random.default_rng(10).standard_normal((64, 65536)),
                                   dtype=torch.float32, device=dev)

    def stats(a, b):
        return (*jt.modwt_variance_ci(a, "db4", 8), jt.modwt_covariance(a, b, "db4", 8),
                jt.modwt_correlation(a, b, "db4", 8), *jt.wavelet_log_spectrum(a, "db4", 8))

    got_s = path("variance/CI, covariance, correlation, logscale db4 L8 64x65536",
                 lambda: stats(x, y2), ("K1",))
    names = ("variance", "CI low", "CI high", "covariance", "correlation", "log2 variance",
             "logscale slope", "logscale intercept")
    ref_s = stats(x.double(), y2.double())
    for name, g_, r_ in zip(names, got_s, ref_s):
        finite(g_, r_.shape, name)
        if name == "logscale intercept":
            # a weighted mean of the log2 variances less slope * jbar: its
            # error scales with theirs, not with its own (small) value
            compare(f"{name} against the float64 route (scale: max|log2 variance|)", g_, r_,
                    F32_BOUND, scale=float(ref_s[5].abs().max()))
        else:
            compare(f"{name} against the float64 route", g_, r_, F32_BOUND)
    white = torch.as_tensor(np.random.default_rng(11).standard_normal((64, 65536)),
                            dtype=torch.float32, device=dev)
    h_white = path("hurst_exponent white noise 64x65536", lambda: jt.hurst_exponent(white),
                   ("K1",))
    dev_h = float((h_white - 0.5).abs().max())
    print(json.dumps({"check": "hurst_exponent of white noise, max |H - 0.5| over 64 rows",
                      "value": dev_h, "bound": 0.05}), flush=True)
    require(dev_h < 0.05, f"hurst_exponent of white noise: max |H - 0.5| = {dev_h}")
    del y2, white
    torch.cuda.synchronize()

    # ---- 4e. denoising ------------------------------------------------------
    td = np.arange(65536)
    # tones in the fine bands, so that SURE takes its risk minimum there
    dense = (np.sin(2 * np.pi * td / 512.0) + 0.5 * np.sin(2 * np.pi * td / 5.3)
             + 0.4 * np.sin(2 * np.pi * td / 11.7) + 0.3 * np.sin(2 * np.pi * td / 23.0))
    xdn = torch.as_tensor(dense + 0.3 * np.random.default_rng(12).standard_normal((8, 65536)),
                          dtype=torch.float32, device=dev)
    for method in ("universal", "sure", "bayes"):
        got = path(f"denoise {method} soft db4 L4 8x65536",
                   lambda: jt.denoise(xdn, "db4", 4, method=method), ("K1", "K2"))
        finite(got, (8, 65536), f"denoise {method}")
        compare(f"denoise {method} soft against the float64 route (thresholds through a "
                "median; bound 1e-4)", got, jt.denoise(xdn.double(), "db4", 4, method=method),
                1e-4)
    tone = np.sin(2 * np.pi * td / 256.0) + 0.5 * np.sign(np.sin(2 * np.pi * td / 4096.0))
    noisy = tone + 0.3 * np.random.default_rng(13).standard_normal((8, 65536))
    hard = path("denoise universal hard db4 L4 8x65536",
                lambda: jt.denoise(torch.as_tensor(noisy, dtype=torch.float32, device=dev),
                                   "db4", 4, mode="hard"), ("K1", "K2"))
    def snr_gain(label, noisy_np, clean_np, got):
        """dB of noise removed; hard thresholds are discontinuous, so f32 and
        f64 may keep different coefficients near the threshold."""
        db = 10 * math.log10(float(np.mean((noisy_np - clean_np) ** 2))
                             / float(np.mean((got.double().cpu().numpy() - clean_np) ** 2)))
        print(json.dumps({"check": f"{label}: SNR gain, dB", "value": db, "bound": 6.0}),
              flush=True)
        require(db > 6.0, f"{label}: SNR gain {db} dB")

    snr_gain("denoise hard, a tone plus noise", noisy, tone, hard)
    yy, xx = np.mgrid[0:2048, 0:2048]
    smooth = np.sin(2 * np.pi * xx / 256.0) * np.cos(2 * np.pi * yy / 512.0)
    noisy2 = smooth + 0.3 * np.random.default_rng(14).standard_normal((2048, 2048))
    den2 = path("denoise_2d bayes db4 L3 2048x2048",
                lambda: jt.denoise_2d(torch.as_tensor(noisy2, dtype=torch.float32, device=dev),
                                      "db4", 3), ("K1", "K2"))
    finite(den2, (2048, 2048), "denoise_2d")
    snr_gain("denoise_2d bayes", noisy2, smooth, den2)
    big = torch.as_tensor(np.random.default_rng(15).standard_normal(4 * 2**20),
                          dtype=torch.float32, device=dev)
    m_sel, m_rad = jt.median_abs(big), jt.median_abs(big, force=True)
    print(json.dumps({"check": "median_abs 4M: kthvalue route = radix-select route",
                      "kthvalue": float(m_sel), "radix": float(m_rad)}), flush=True)
    require(bool(m_sel == m_rad), "median_abs routes differ")
    del xdn, den2, big
    torch.cuda.synchronize()

    # ---- 4f. sliding MODWT --------------------------------------------------
    wlen, slv, step, n_upd = 512, 8, 64, 4096
    stream = torch.as_tensor(np.random.default_rng(16).standard_normal((8, wlen + n_upd * step)),
                             dtype=torch.float32, device=dev)
    sl = jt.SlidingMODWT("db4", slv, wlen)

    def slide():
        st = sl.init(stream[:, :wlen])
        for i in range(n_upd):
            st = sl.update(st, stream[:, wlen + i * step: wlen + (i + 1) * step])
        return st

    st = path("sliding MODWT 8 streams, window 512, db4 L8, 4096 updates of 64", slide)
    finite(st.coeffs, (8, slv + 1, wlen), "sliding state")
    mlen = jt.get_filter("db4").length
    ref_w = jt.modwt(stream[:, -wlen:], "db4", slv)
    full = jt.modwt(stream, "db4", slv)
    for j in range(1, slv + 2):
        s0 = (mlen - 1) * ((1 << min(j, slv)) - 1)  # L_j - 1; V_J has level J's support
        if s0 < wlen:
            compare(f"sliding row {j}: interior columns = modwt of the final window",
                    st.coeffs[:, j - 1, s0:], ref_w[:, j - 1, s0:], F32_BOUND)
        compare(f"sliding row {j}: the causal stream = modwt of the whole stream",
                st.coeffs[:, j - 1, :], full[:, j - 1, -wlen:], F32_BOUND)
    del full, ref_w
    torch.cuda.synchronize()

    # ---- 4g. the rest of the continuous layer -------------------------------
    def small_check(label, got, want, bound=F32_BOUND,
                    why="f32 on the card against f64 on the CPU"):
        got = got.detach().cpu()
        if got.is_complex():
            got, want = torch.view_as_real(got), torch.view_as_real(want)
        err = float((got.double() - want.double()).abs().max())
        scale = float(want.abs().max())
        print(json.dumps({"check": label, "max_abs_err": err, "max_abs_ref": scale,
                          "rel": err / scale, "bound": bound, "why": why}), flush=True)
        require(err <= bound * scale, f"{label}: {err / scale} > {bound}")

    xw = torch.as_tensor(np.random.default_rng(17).standard_normal((8, 4096)),
                         dtype=torch.float32, device=dev)
    tfr, _ = path("wigner_ville 8x4096, 512 bins", lambda: jt.wigner_ville(xw, 1.0, n_bins=512))
    finite(tfr, (8, 512, 4096), "wigner_ville")
    xsl = torch.as_tensor(np.random.default_rng(18).standard_normal((8, 16384)),
                          dtype=torch.float32, device=dev)
    sl_freqs = np.linspace(5.0, 200.0, 64)
    spl = path("superlet 8x16384, 64 frequencies 5-200 Hz, fs 1000",
               lambda: jt.superlet(xsl, sl_freqs, 1000.0))
    finite(spl, (8, 64, 16384), "superlet")
    require(bool((spl >= 0).all()), "superlet is nonnegative")
    ewt_sig = np.random.default_rng(19).standard_normal(16384)
    ewt_b = jt.ewt_boundaries(ewt_sig, 5)
    xe = torch.as_tensor(np.tile(ewt_sig, (8, 1)), dtype=torch.float32, device=dev)

    def ewt_round():
        r = jt.ewt(xe, boundaries=ewt_b)
        return r, jt.iewt(r)

    er, eback = path("ewt -> iewt 8x16384, 5 modes", ewt_round)
    finite(er.modes, (8, 5, 16384), "ewt modes")
    compare("iewt(ewt(x)) = x", eback, xe, F32_BOUND)
    xv = torch.as_tensor(np.random.default_rng(20).standard_normal(2048), dtype=torch.float32,
                         device=dev)
    vr = path("vmd K=3 N=2048, 300 iterations", lambda: jt.vmd(xv, 3))
    finite(vr.modes, (3, 2048), "vmd modes")
    finite(vr.omegas, (3,), "vmd omegas")
    xm = torch.as_tensor(np.random.default_rng(21).standard_normal((4, 2048)),
                         dtype=torch.float32, device=dev)
    mp = path("matching_pursuit 16 atoms 4x2048", lambda: jt.matching_pursuit(xm, 16))
    finite(mp.residual, (4, 2048), "pursuit residual")
    compare("pursuit: reconstruction + residual = x", mp.reconstruct() + mp.residual, xm,
            F32_BOUND)
    require(bool((mp.energies[:, 1:] <= mp.energies[:, :-1] * (1 + 1e-6)).all()),
            "pursuit energies do not increase")
    xan = torch.as_tensor(np.random.default_rng(22).standard_normal((8, 65536)),
                          dtype=torch.float32, device=dev)
    z = path("analytic_signal 8x65536", lambda: jt.analytic_signal(xan))
    finite(z, (8, 65536), "analytic_signal")
    compare("Re analytic_signal(x) = x", z.real, xan, F32_BOUND)

    # small sizes against the port's own float64 run on the CPU
    fs_b = 1000.0
    tb = np.arange(1024) / fs_b
    sm = (np.cos(2 * np.pi * 40 * tb) + 0.5 * np.cos(2 * np.pi * 150 * tb + 1)
          + 0.1 * np.random.default_rng(23).standard_normal((2, 1024)))
    smc = torch.as_tensor(sm, dtype=torch.float32, device=dev)
    smd = torch.as_tensor(sm)
    small_check("analytic_signal 2x1024", jt.analytic_signal(smc), jt.analytic_signal(smd))
    small_check("wigner_ville 2x256, 64 bins", jt.wigner_ville(smc[:, :256], fs_b, n_bins=64)[0],
                jt.wigner_ville(smd[:, :256], fs_b, n_bins=64)[0])
    fr16 = np.linspace(5.0, 200.0, 16)
    small_check("superlet 2x1024, 16 frequencies", jt.superlet(smc, fr16, fs_b),
                jt.superlet(smd, fr16, fs_b))
    b3 = jt.ewt_boundaries(sm, 3)
    small_check("ewt 2x1024, 3 modes", jt.ewt(smc, boundaries=b3).modes,
                jt.ewt(smd, boundaries=b3).modes)
    small_check("vmd K=3 N=512, 300 iterations", jt.vmd(smc[0, :512], 3).modes,
                jt.vmd(smd[0, :512], 3).modes, bound=1e-4,
                why="f32 against f64; 300 ADMM iterations compound the rounding")
    gd = jt.gabor_dictionary(256)
    comp = np.zeros((2, 256))
    for a_i, p_i, amp in ((30, 17, 3.0), (100, 120, 2.0), (200, 200, 1.5)):
        comp += amp * np.roll(gd.cos_atoms[a_i], p_i)
    comp += 0.01 * np.random.default_rng(24).standard_normal((2, 256))
    mp_c = jt.matching_pursuit(torch.as_tensor(comp, dtype=torch.float32, device=dev), 3)
    mp_d = jt.matching_pursuit(torch.as_tensor(comp), 3)
    same = (torch.equal(mp_c.atom_idx.cpu(), mp_d.atom_idx)
            and torch.equal(mp_c.positions.cpu(), mp_d.positions))
    print(json.dumps({"check": "matching_pursuit 2x256: the same atoms and shifts as f64 CPU",
                      "atoms": mp_c.atom_idx.tolist(), "positions": mp_c.positions.tolist(),
                      "equal": same}), flush=True)
    require(same, "matching_pursuit picks differ from the float64 CPU run")
    small_check("matching_pursuit 2x256 reconstruction", mp_c.reconstruct(), mp_d.reconstruct())
    torch.cuda.synchronize()

    # ---- 4h. the rest of the discrete family --------------------------------
    def no_kernel(name, fn):
        """A path that runs no kernel of this package: every count stays 0."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        print(json.dumps({"main_path": name, "launches": counts}), flush=True)
        require(not any(counts.values()), f"{name} launched a kernel of this package: {counts}")
        return out

    fb4 = jt.get_filter("db4")
    xp_np = np.random.default_rng(26).standard_normal((64, 65536)).astype(np.float32)
    xp = torch.as_tensor(xp_np, device=dev)
    wpt_modes = {"fused": ({}, 1), "level by level": ({"fused": False}, 0),
                 "interleaved": ({"layout": "interleaved"}, 1)}
    for mode, (kw, k89) in wpt_modes.items():
        def wpt_round(kw=kw):
            y = jt.wpt(xp, "db4", 6, **kw)
            return y, jt.iwpt(y, "db4", 6, **kw)

        name = f"wpt -> iwpt db4 L6 64x65536 ({mode})"
        yw, backw = path(name, wpt_round, ("K8", "K9")) if k89 else no_kernel(name, wpt_round)
        counts = read_counts()
        require(counts["K8"] == k89 and counts["K9"] == k89, f"{name}: {counts}")
        finite(yw, (64, 65536), f"wpt {mode}")
        compare(f"iwpt(wpt(x)) db4 L6 64x65536 ({mode})", backw, xp, F32_BOUND)
        sub = jt.wpt_interleaved_to_subband(yw, 6) if mode == "interleaved" else yw
        want_w = np.stack([oracle.wpt(r.astype(np.float64), fb4, 6) for r in xp_np[:2]])
        err = float(np.abs(sub[:2].double().cpu().numpy() - want_w).max())
        print(json.dumps({"oracle": f"wpt 2 rows of 64x65536 db4 L6 ({mode})",
                          "max_abs_err": err, "rel": err / np.abs(want_w).max()}), flush=True)
        require(err <= F32_BOUND * np.abs(want_w).max(), f"wpt {mode} against the oracle")
    del yw, backw, sub

    def wpt_full():
        y = jt.wpt(xp, "db4")
        return y, jt.iwpt(y, "db4")

    # the WPT path's counts: K8 and K9 once a fused chunk, (65536, 6),
    # (1024, 6) and (16, 4) at full depth
    yw, backw = path("wpt -> iwpt db4 full depth 64x65536 (chunks L6, L6, L4)", wpt_full,
                     ("K8", "K9"))
    wpt_launches = read_counts()
    require(wpt_launches["K8"] == 3 and wpt_launches["K9"] == 3,
            f"wpt -> iwpt at full depth: {wpt_launches}")
    launches["K8"] = main_launches["K8"] = wpt_launches["K8"]
    launches["K9"] = main_launches["K9"] = wpt_launches["K9"]
    compare("iwpt(wpt(x)) db4 full depth 64x65536", backw, xp, F32_BOUND)
    compare("wpt db4 full depth 64x65536 f32 against float64 (the conv form)", yw,
            jt.wpt(xp.double(), "db4"), F32_BOUND)
    del yw, backw
    wpt_t = jt.TransformBuilder.create("Wavelet Packet Transform", "db4")
    img_w = path("WPT facade forward_2d 2048x2048 db4 (full depth)",
                 lambda: wpt_t.forward(img), ("K8",))  # numpy -> "cuda" by default
    img_wb = path("WPT facade reverse_2d 2048x2048 db4 (full depth)",
                  lambda: wpt_t.reverse(img_w), ("K9",))
    finite(img_w, (2048, 2048), "WPT facade 2D")
    compare("WPT facade 2D 2048x2048 f32 against float64", img_w,
            wpt_t.forward(torch.as_tensor(img, dtype=torch.float64, device=dev)), F32_BOUND)
    compare("WPT facade 2D round trip 2048x2048", img_wb, torch.as_tensor(img, device=dev),
            F32_BOUND)
    del img_wb
    vol_w = torch.as_tensor(np.random.default_rng(34).standard_normal((256, 256, 256)),
                            dtype=torch.float32, device=dev)
    vol_c = path("WPT facade forward_3d 256^3 db4 L4 (wpt3d)",
                 lambda: wpt_t.forward(vol_w, 4, 4, 4), ("K8",))
    vol_b = path("WPT facade reverse_3d 256^3 db4 L4 (iwpt3d)",
                 lambda: wpt_t.reverse(vol_c, 4, 4, 4), ("K9",))
    compare("WPT facade 3D 256^3 L4 f32 against float64", vol_c,
            wpt_t.forward(vol_w.double(), 4, 4, 4), F32_BOUND)
    compare("WPT facade 3D round trip 256^3 L4", vol_b, vol_w, F32_BOUND)
    del vol_w, vol_c, vol_b

    tb_ = np.arange(65536)
    bb_np = (np.sin(2 * np.pi * tb_ / 37.0) + np.sign(np.sin(2 * np.pi * tb_ / 4096.0))
             + 0.3 * np.random.default_rng(27).standard_normal((8, 65536)))
    xbb = torch.as_tensor(bb_np, dtype=torch.float32, device=dev)
    bb = no_kernel("best_basis db4 8x65536 max level 6", lambda: jt.best_basis(xbb, "db4", 6))
    bb_cpu = jt.best_basis(xbb.double().cpu(), "db4", 6)
    print(json.dumps({"check": "best_basis 8x65536: nodes of the card's f32 run = the CPU's f64",
                      "nodes": len(bb.nodes), "equal": bb.nodes == bb_cpu.nodes}), flush=True)
    require(bb.nodes == bb_cpu.nodes, "best_basis nodes differ from the float64 CPU run")
    compare("best_basis_reconstruct 8x65536", jt.best_basis_reconstruct(bb), xbb, F32_BOUND)
    yy2, xx2 = np.mgrid[0:512, 0:512]
    img512_np = (np.sin(2 * np.pi * xx2 / 16.0) * np.cos(2 * np.pi * yy2 / 64.0) + (xx2 > 200)
                 + 0.2 * np.random.default_rng(28).standard_normal((512, 512)))
    img512 = torch.as_tensor(img512_np, dtype=torch.float32, device=dev)
    bb2 = no_kernel("best_basis_2d db4 512x512 L4", lambda: jt.best_basis_2d(img512, "db4", 4))
    bb2_cpu = jt.best_basis_2d(img512.double().cpu(), "db4", 4)
    print(json.dumps({"check": "best_basis_2d 512^2: nodes of the card's f32 run = the CPU's f64",
                      "nodes": len(bb2.nodes), "equal": bb2.nodes == bb2_cpu.nodes}), flush=True)
    require(bb2.nodes == bb2_cpu.nodes, "best_basis_2d nodes differ from the float64 CPU run")
    compare("best_basis_2d_reconstruct 512x512", jt.best_basis_2d_reconstruct(bb2), img512,
            F32_BOUND)

    xa_np = np.random.default_rng(29).standard_normal((64, 100000)).astype(np.float32)
    aed_t = jt.TransformBuilder.create("Ancient Egyptian Decomposition Fast Wavelet Transform",
                                       "db4")
    chunks = len(jt.utils.ancient_egyptian_decompose(100000))
    aed_b = aed_t.get_basic_transform()                      # 1D along the rows
    ya = path("AED over FWT db4 64x100000 (forward)",
              lambda: aed_b.forward(xa_np), ("K3",))            # numpy rows -> "cuda"
    k3_aed = jt.ops.launch_counts()["K3"]
    print(json.dumps({"check": "AED: one K3 launch per power-of-two chunk", "chunks": chunks,
                      "k3_launches": k3_aed}), flush=True)
    require(k3_aed == chunks, f"AED launched K3 {k3_aed} times for {chunks} chunks")
    finite(ya, (64, 100000), "AED forward")
    compare("AED reverse(forward(x)) 64x100000", aed_b.reverse(ya), torch.as_tensor(xa_np,
            device=dev), F32_BOUND)
    del ya
    for n_s in (65536, 65537):
        xs_np = np.random.default_rng(30).standard_normal((64, n_s)).astype(np.float32)
        xsh = torch.as_tensor(xs_np, device=dev)
        ysh = no_kernel(f"shifting_forward db4 64x{n_s}", lambda: jt.shifting_forward(xsh, "db4"))
        finite(ysh, (64, n_s), "shifting")
        compare(f"shifting_reverse(shifting_forward(x)) 64x{n_s}",
                jt.shifting_reverse(ysh, "db4"), xsh, F32_BOUND)
        compare(f"shifting_forward 64x{n_s} against float64", ysh,
                jt.shifting_forward(xsh.double(), "db4"), F32_BOUND)
    del xsh, ysh
    for bnd in ("periodic", "symmetric"):
        def lift_round(bnd=bnd):
            c = jt.lifting_fwt(xp, "CDF 9/7", 8, bnd)
            return c, jt.lifting_ifwt(c, "CDF 9/7", 8, bnd)

        cl, backl = no_kernel(f"lifting_fwt -> lifting_ifwt CDF 9/7 L8 64x65536 ({bnd})",
                              lift_round)
        compare(f"lifting round trip ({bnd})", backl, xp, F32_BOUND)
        compare(f"lifting_fwt ({bnd}) against float64", cl,
                jt.lifting_fwt(xp.double(), "CDF 9/7", 8, bnd), F32_BOUND)
    del cl, backl
    xd = xp[:8]

    def dt_round():
        r = jt.dtcwt(xd, 6)
        return r, jt.idtcwt(r)

    rd, backd = no_kernel("dtcwt -> idtcwt L6 8x65536", dt_round)
    require(rd.highpasses[0].dtype == torch.complex64, f"dtcwt {rd.highpasses[0].dtype}")
    compare("idtcwt(dtcwt(x)) L6 8x65536", backd, xd, F32_BOUND)
    rd64 = jt.dtcwt(xd.double(), 6)
    for j, (g, w) in enumerate(zip(rd.highpasses, rd64.highpasses)):
        compare(f"dtcwt level {j + 1} against float64", torch.view_as_real(g),
                torch.view_as_real(w), F32_BOUND)

    def dt2_round():
        r = jt.dtcwt2d(img512, 4)
        return r, jt.idtcwt2d(r)

    rd2, backd2 = no_kernel("dtcwt2d -> idtcwt2d L4 512x512", dt2_round)
    compare("idtcwt2d(dtcwt2d(x)) L4 512x512", backd2, img512, F32_BOUND)
    rd2_64 = jt.dtcwt2d(img512.double(), 4)
    compare("dtcwt2d level 1 against float64", torch.view_as_real(rd2.highpasses[0]),
            torch.view_as_real(rd2_64.highpasses[0]), F32_BOUND)
    den_d = no_kernel("denoise_dtcwt 512x512 L4", lambda: jt.denoise_dtcwt(img512, 4))
    finite(den_d, (512, 512), "denoise_dtcwt")
    compare("denoise_dtcwt against the float64 route (sigma through a median; bound 1e-4)",
            den_d, jt.denoise_dtcwt(img512.double(), 4), 1e-4)
    del rd, backd, rd64, rd2, backd2, rd2_64

    ip = jt.InPlaceFastWaveletTransform("db4")
    buf = xp.clone()
    ptr = buf.data_ptr()
    ref_ip = jt.fwt(xp.double(), "db4")
    y_ip = path("InPlaceFastWaveletTransform.forward_in_place 64x65536",
                lambda: ip.forward_in_place(buf), ("K3",))
    k3_ip = jt.ops.launch_counts()["K3"]
    require(k3_ip == 1 and y_ip.data_ptr() == ptr,
            f"in-place FWT: K3 {k3_ip} launches, storage reused {y_ip.data_ptr() == ptr}")
    compare("forward_in_place against fwt in float64", y_ip, ref_ip, F32_BOUND)
    del buf, y_ip, ref_ip
    stream_np = np.random.default_rng(31).standard_normal(1 << 20).astype(np.float32)
    eff = jt.EfficientMODWTTransform("db4")
    st_m = path("EfficientMODWTTransform.forward_streaming db4 L5, 2^20 samples, chunks of 65536",
                lambda: eff.forward_streaming(stream_np, 5, 65536), ("K1",))
    k1_st = jt.ops.launch_counts()["K1"]
    require(k1_st == 16, f"forward_streaming launched K1 {k1_st} times for 16 chunks")
    compare("forward_streaming = forward_modwt of the whole signal", st_m,
            eff.forward_modwt(stream_np, 5), F32_BOUND)
    del st_m
    pooled = jt.PooledMODWTTransform("db4")

    def pooled_round():
        c = pooled.forward_modwt(xp, 5)
        return pooled.inverse_modwt(c)

    back_p = path("PooledMODWTTransform round trip db4 L5 64x65536", pooled_round, ("K1", "K2"))
    compare("pooled MODWT round trip", back_p, xp, F32_BOUND)
    comp = jt.CompressorMagnitude(1.0)
    kept = no_kernel("CompressorMagnitude on the WPT'd 2048^2 image", lambda: comp.compress(img_w))
    mask_ok = bool(torch.equal(kept != 0, img_w.abs() >= comp.magnitude))
    rate = float(jt.Compressor.compression_rate(kept))
    print(json.dumps({"check": "CompressorMagnitude: kept where |c| >= mean|c|",
                      "equal": mask_ok, "compression_rate_percent": rate}), flush=True)
    require(mask_ok and 0.0 < rate < 100.0, "CompressorMagnitude mask")
    del back_p, kept
    torch.cuda.synchronize()

    # ---- 4i. scattering, the CLI and profiling ------------------------------
    from jwave_tpu_torch import cli
    from jwave_tpu_torch.transforms import scattering as scat
    from jwave_tpu_torch.utils import profiling

    def per_order(label, got, want, bound, rows=slice(None)):
        """Each order of ``got[rows]`` against ``want``, relative to its own
        max|ref|."""
        for name in ("S0", "S1", "S2"):
            compare(f"{label} {name}", getattr(got, name)[rows], getattr(want, name).to(dev),
                    bound)

    def h2d_copies(label, fn):
        """Host-to-device copies in a warm call, traced by profiling.trace."""
        fn()
        torch.cuda.synchronize()
        with profiling.trace(str(ROOT / "build" / "trace_4i")) as prof:
            fn()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "HtoD" in e.name]
        print(json.dumps({"check": f"{label}: host-to-device copies in a warm call",
                          "copies": len(names), "names": sorted(set(names))}), flush=True)
        require(not names, f"{label}: a warm call copies from the host: {names}")

    xsc_np = np.random.default_rng(32).standard_normal((8, 65536)).astype(np.float32)
    xsc = torch.as_tensor(xsc_np, device=dev)
    img_sc = torch.as_tensor(np.random.default_rng(33).standard_normal((256, 256)),
                             dtype=torch.float32, device=dev)
    scat_calls = {"scattering1d J8 Q8 8x65536": (lambda: jt.scattering1d(xsc, 8, Q=8),
                                                  8 * 65536, "Msamples_per_s"),
                  "scattering2d J3 L8 256x256": (lambda: jt.scattering2d(img_sc, 3, L=8),
                                                  256 * 256, "Mpix_per_s")}
    peak = {}
    for label, (fn, _, _) in scat_calls.items():
        no_kernel(label + " f32", fn)
        h2d_copies(label, fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        peak[label] = torch.cuda.max_memory_allocated() - base  # above the inputs, warm
    # bytes of the FFT rounds from the shapes: each FFT reads and writes its
    # complex64 planes once. 1D: fft(x), the lowpass of S0, then per group
    # of rate r (or R) an inverse FFT, fft(|.|) and the lowpass's inverse FFT
    # over its rows of padded / r points; 2D likewise over 512^2 planes
    plan1 = scat._plan_1d(65536, 8, 8, 1, 0, torch.float32, dev)
    planes1 = 2 * plan1.padded + sum(3 * g.psi.shape[0] * plan1.padded // g.r
                                     for g in plan1.order1) + sum(
        3 * g.psi.shape[0] * plan1.padded // g.R for g in plan1.order2)
    plan2 = scat._plan_2d(256, 256, 3, 8, 0, torch.float32, dev)
    planes2 = (2 + 3 * plan2.psi.shape[0] + 3 * len(plan2.bank.paths)) * plan2.py * plan2.px
    fft_bytes = {"scattering1d J8 Q8 8x65536": 2 * 8 * 8 * planes1,
                 "scattering2d J3 L8 256x256": 2 * 8 * planes2}
    sc1 = jt.scattering1d(xsc, 8, Q=8)
    sc1_64 = jt.scattering1d(xsc.double(), 8, Q=8)
    bank1 = jt.scattering_filter_bank(131072, 8, 8, 1)
    k1, p1, t1 = len(bank1.xi1), len(bank1.paths), 65536 // 256
    require(tuple(sc1.S0.shape) == (8, t1) and tuple(sc1.S1.shape) == (8, k1, t1)
            and tuple(sc1.S2.shape) == (8, p1, t1) and sc1.n_paths == p1
            and tuple(sc1.features().shape) == (8, 1 + k1 + p1, t1)
            and all(getattr(sc1, n).dtype == torch.float32 for n in ("S0", "S1", "S2")),
            f"scattering1d shapes or dtypes: {sc1.S0.shape} {sc1.S1.shape} {sc1.S2.shape}")
    per_order("scattering1d 8x65536 f32 against the card's float64 (bound 1e-4)", sc1, sc1_64,
              1e-4)
    sc1_cpu = jt.scattering1d(xsc[:2].double().cpu(), 8, Q=8)
    per_order("scattering1d 2x65536 float64: the card against the CPU (bound 1e-10)", sc1_64,
              sc1_cpu, 1e-10, rows=slice(0, 2))
    sc2 = jt.scattering2d(img_sc, 3, L=8)
    sc2_64 = jt.scattering2d(img_sc.double(), 3, L=8)
    bank2 = jt.scattering_filter_bank_2d(512, 512, 3, 8)
    p2 = len(bank2.paths)
    require(tuple(sc2.S0.shape) == (32, 32) and tuple(sc2.S1.shape) == (24, 32, 32)
            and tuple(sc2.S2.shape) == (p2, 32, 32) and sc2.n_paths == p2 == 192
            and tuple(sc2.features().shape) == (1 + 24 + p2, 32, 32)
            and all(getattr(sc2, n).dtype == torch.float32 for n in ("S0", "S1", "S2")),
            f"scattering2d shapes or dtypes: {sc2.S0.shape} {sc2.S1.shape} {sc2.S2.shape}")
    per_order("scattering2d 256^2 f32 against the card's float64 (bound 1e-4)", sc2, sc2_64, 1e-4)
    per_order("scattering2d 256^2 float64: the card against the CPU (bound 1e-10)", sc2_64,
              jt.scattering2d(img_sc.double().cpu(), 3, L=8), 1e-10)
    del sc1, sc1_64, sc1_cpu, sc2, sc2_64
    torch.cuda.empty_cache()
    rc_cli = path("python -m jwave_tpu_torch 'Fast Wavelet Transform' 'Daubechies 4' "
                  "(cli.main in this process, on the card)",
                  lambda: cli.main(["Fast Wavelet Transform", "Daubechies 4"]))
    require(rc_cli == 0, f"the CLI demo returned {rc_cli}")
    time_fn_ms = {label: profiling.time_fn(fn, warmup=2, iters=10) * 1e3
                  for label, (fn, _, _) in scat_calls.items()}
    torch.cuda.synchronize()

    # ---- 4j. the sharded layer ------------------------------------------------
    # A one-rank NCCL world, as torchrun would set it up (the machine has one
    # card, so no collective crosses cards here). Every name of
    # jwave_tpu_torch.parallel at full size, f32 on the card: each result
    # against the port's single-device function on the same input (F32_BOUND
    # of max|ref|), its float64 run against the single device's float64 run
    # (1e-10, JAX's bound for the sharded paths), f32 against its own float64
    # run, and its identity (round trips; the gathered pyramids equal fwt's
    # and fwt2d's layout); every output's local block on the card; the
    # launches read around each call: K3 in the 2D/3D FWTs and the halo
    # FWT's tail, K6 in ssq_scale_sharded, K1/K2 in the batch-sharded MODWT.
    import os
    import socket

    import torch.distributed as dist

    from jwave_tpu_torch import parallel as par
    from jwave_tpu_torch.transforms.modwt import imodwt_2d, modwt_2d

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        free_port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port), RANK="0",
                      WORLD_SIZE="1")
    joined = par.initialize_distributed()
    mesh = par.make_mesh()
    mesh2 = par.make_mesh((1, 1), ("batch", "scale"))
    group_backend = dist.get_backend(mesh.get_group("shard"))
    print(json.dumps({"sharded": "process group", "joined": list(joined),
                      "backend": dist.get_backend(), "mesh_backend": group_backend,
                      "world_size": dist.get_world_size(), "mesh": str(mesh),
                      "mesh_2d": str(mesh2)}), flush=True)
    require(dist.is_initialized() and joined == (0, 1) and "nccl" in group_backend,
            f"the one-rank NCCL world: {joined} {group_backend}")

    def full(r):
        """A result's global value as a tensor on the card (a DTensor gathered;
        its local block must lie on the card)."""
        for attr in ("coefficients", "Tx"):
            r = getattr(r, attr, r)
        if isinstance(r, np.ndarray):
            return torch.as_tensor(r, device=dev)
        if hasattr(r, "to_local"):
            require(r.to_local().is_cuda, "a sharded output's local block is not on the card")
            return r.full_tensor()
        return r

    def real_view(t):
        return torch.view_as_real(t) if t.is_complex() else t

    f64 = torch.float64
    rng_4j = np.random.default_rng(40)
    base = {k: rng_4j.standard_normal(shape) for k, shape in (
        ("img", (2048, 2048)), ("xb", (64, 65536)), ("xs", (8, 65536)), ("s22", 1 << 22),
        ("s20", 1 << 20), ("p20", (8, 1 << 20)), ("vol", (256, 256, 256)))}
    sharded_in = {dt: {k: torch.as_tensor(v, dtype=dt, device=dev) for k, v in base.items()}
               for dt in (torch.float32, f64)}
    del base
    fwt_f = jt.TransformBuilder.create("Fast Wavelet Transform", "db4")
    wpt_f = jt.TransformBuilder.create("Wavelet Packet Transform", "db4")
    fft_m = jt.ConvolutionMethod.FFT
    sharded_launches = dict.fromkeys(read_counts(), 0)
    # label -> (sharded call, single-device call) on f32, timed in phase 5; the
    # inputs of the inverses (the forwards' outputs) stay on the card for it
    sharded_calls = {}

    def sharded(label, fn, single, ident=None, need=(), vs_f64=True, timed=None):
        """``fn(dt)`` the sharded call and ``single(dt)`` its single-device
        counterpart on the inputs of dtype ``dt``; ``ident(dt)`` what the
        result must equal; ``timed`` the f32 call phase 5 times, if not
        ``fn``'s (the sharded call without the host-side gather)."""
        reset_counts()
        out = fn(torch.float32)
        torch.cuda.synchronize()
        counts = read_counts()
        for k, v in counts.items():
            sharded_launches[k] += v
        print(json.dumps({"main_path": f"sharded: {label}", "launches": counts}), flush=True)
        require(all(counts[k] >= 1 for k in need), f"{label}: {need} not all launched: {counts}")
        got = full(out)
        require(bool(torch.isfinite(real_view(got)).all()), f"{label}: not finite")
        compare(f"sharded {label} f32 against the single device", real_view(got),
                real_view(full(single(torch.float32))), F32_BOUND)
        if ident is not None:
            compare(f"sharded {label} f32: identity", real_view(got),
                    real_view(full(ident(torch.float32))), F32_BOUND)
        got64 = full(fn(f64))
        compare(f"sharded {label} float64 against the single device's float64",
                real_view(got64), real_view(full(single(f64))), 1e-10)
        if vs_f64:
            compare(f"sharded {label} f32 against its float64 run", real_view(got),
                    real_view(got64), F32_BOUND)
        sharded_calls[label] = (timed or (lambda: fn(torch.float32)),
                                lambda: single(torch.float32))
        del out, got, got64

    def inp(name):
        return lambda dt: sharded_in[dt][name]

    img_, xb_, xs_, s22_, s20_, p20_, vol_ = (inp(k) for k in
                                              ("img", "xb", "xs", "s22", "s20", "p20", "vol"))
    fwt2_out = {dt: par.fwt2d_sharded(img_(dt), "db4", mesh, 6, 6) for dt in sharded_in}
    wpt2_out = {dt: par.wpt2d_sharded(img_(dt), "db4", mesh, 6, 6) for dt in sharded_in}
    sharded("fwt2d_sharded db4 L6 2048^2 (single: fwt2d, K4 x2)",
            lambda dt: par.fwt2d_sharded(img_(dt), "db4", mesh, 6, 6),
            lambda dt: jt.fwt2d(img_(dt), "db4", 6, 6), need=("K3",))
    sharded("ifwt2d_sharded db4 L6 2048^2 (single: ifwt2d, K5 x2)",
            lambda dt: par.ifwt2d_sharded(fwt2_out[dt], "db4", mesh, 6, 6),
            lambda dt: jt.ifwt2d(fwt2_out[dt].full_tensor(), "db4", 6, 6), ident=img_,
            need=("K7",))
    sharded("wpt2d_sharded db4 L6 2048^2",
            lambda dt: par.wpt2d_sharded(img_(dt), "db4", mesh, 6, 6),
            lambda dt: wpt_f.forward(img_(dt), 6, 6), need=("K8",))
    sharded("iwpt2d_sharded db4 L6 2048^2",
            lambda dt: par.iwpt2d_sharded(wpt2_out[dt], "db4", mesh, 6, 6),
            lambda dt: wpt_f.reverse(wpt2_out[dt].full_tensor(), 6, 6), ident=img_,
            need=("K9",))
    sharded("fwt2d_tile_sharded db4 L6 2048^2 on a (1, 1) mesh, gather_pyramid_2d",
            lambda dt: par.gather_pyramid_2d(par.fwt2d_tile_sharded(img_(dt), "db4", mesh2, 6, 6),
                                             "db4", 6, 6, 1, 1),
            lambda dt: jt.fwt2d(img_(dt), "db4", 6, 6),
            timed=lambda: par.fwt2d_tile_sharded(img_(torch.float32), "db4", mesh2, 6, 6))
    fwt3_out = {dt: par.fwt3d_sharded(vol_(dt), "db4", mesh) for dt in sharded_in}
    sharded("fwt3d_sharded db4 256^3 (full depth)",
            lambda dt: par.fwt3d_sharded(vol_(dt), "db4", mesh),
            lambda dt: fwt_f.forward(vol_(dt)), need=("K3",))
    sharded("ifwt3d_sharded db4 256^3", lambda dt: par.ifwt3d_sharded(fwt3_out[dt], "db4", mesh),
            lambda dt: fwt_f.reverse(fwt3_out[dt].full_tensor()), ident=vol_, need=("K7",))
    wpt3_out = {dt: par.wpt3d_sharded(vol_(dt), "db4", mesh, 4, 4, 4) for dt in sharded_in}
    sharded("wpt3d_sharded db4 L4 256^3",
            lambda dt: par.wpt3d_sharded(vol_(dt), "db4", mesh, 4, 4, 4),
            lambda dt: wpt_f.forward(vol_(dt), 4, 4, 4), need=("K8",))
    sharded("iwpt3d_sharded db4 L4 256^3",
            lambda dt: par.iwpt3d_sharded(wpt3_out[dt], "db4", mesh, 4, 4, 4),
            lambda dt: wpt_f.reverse(wpt3_out[dt].full_tensor(), 4, 4, 4), ident=vol_,
            need=("K9",))
    sharded("batch_sharded(modwt -> imodwt) db4 L5 64x65536",
            lambda dt: par.batch_sharded(lambda b: jt.imodwt(jt.modwt(b, "db4", 5), "db4"),
                                         mesh)(xb_(dt)),
            lambda dt: jt.imodwt(jt.modwt(xb_(dt), "db4", 5), "db4"), ident=xb_,
            need=("K1", "K2"))
    sharded("cwt_scale_sharded 8x65536, Morlet(1,1), 64 scales",
            lambda dt: par.cwt_scale_sharded(xs_(dt), ssq_scales, morlet, mesh, ssq_fs),
            lambda dt: jt.cwt(xs_(dt), ssq_scales, morlet, ssq_fs))
    # f32 against float64 is not compared for SSQ: the |W| threshold and the
    # bin of a coefficient near a bin edge differ between the two
    sharded("ssq_scale_sharded 8x65536, Morlet(1,1), 64 scales (K6)",
            lambda dt: par.ssq_scale_sharded(xs_(dt), ssq_scales, morlet, mesh, ssq_fs),
            lambda dt: jt.ssq_cwt(xs_(dt), ssq_scales, morlet, ssq_fs), need=("K6",),
            vs_f64=False)
    sharded("cwt_batch_scale_sharded 8x65536 on a (1, 1) mesh",
            lambda dt: par.cwt_batch_scale_sharded(xs_(dt), ssq_scales, morlet, mesh2, ssq_fs),
            lambda dt: jt.cwt(xs_(dt), ssq_scales, morlet, ssq_fs))
    mh_out = {dt: par.modwt_halo_sharded(s22_(dt), "db4", 5, mesh) for dt in sharded_in}
    sharded("modwt_halo_sharded db4 L5 2^22",
            lambda dt: par.modwt_halo_sharded(s22_(dt), "db4", 5, mesh),
            lambda dt: jt.modwt(s22_(dt), "db4", 5))
    sharded("imodwt_halo_sharded db4 L5 2^22",
            lambda dt: par.imodwt_halo_sharded(mh_out[dt], "db4", mesh),
            lambda dt: jt.imodwt(mh_out[dt].full_tensor(), "db4"), ident=s22_)
    sharded("fwt_halo_sharded db4 L8 2^22, gather_pyramid",
            lambda dt: par.gather_pyramid(par.fwt_halo_sharded(s22_(dt), "db4", mesh, 8),
                                          "db4", 8, 1),
            lambda dt: jt.fwt(s22_(dt), "db4", 8),
            timed=lambda: par.fwt_halo_sharded(s22_(torch.float32), "db4", mesh, 8))
    sharded("fwt_halo_sharded db4 full depth 2^22 (a 2-level tail through fwt, K3)",
            lambda dt: par.gather_pyramid(par.fwt_halo_sharded(s22_(dt), "db4", mesh),
                                          "db4", 22, 1),
            lambda dt: jt.fwt(s22_(dt), "db4"), need=("K3",),
            timed=lambda: par.fwt_halo_sharded(s22_(torch.float32), "db4", mesh))
    mf_out = {dt: par.modwt_fft_sharded(s22_(dt), "db4", 6, mesh) for dt in sharded_in}
    sharded("modwt_fft_sharded db4 L6 2^22",
            lambda dt: par.modwt_fft_sharded(s22_(dt), "db4", 6, mesh),
            lambda dt: jt.modwt(s22_(dt), "db4", 6, method=fft_m))
    sharded("imodwt_fft_sharded db4 L6 2^22",
            lambda dt: par.imodwt_fft_sharded(mf_out[dt], "db4", mesh),
            lambda dt: jt.imodwt(mf_out[dt].full_tensor(), "db4", method=fft_m), ident=s22_)
    sharded("cwt_time_sharded 2^20, Morlet(1,1), 64 scales",
            lambda dt: par.cwt_time_sharded(s20_(dt), ssq_scales, morlet, mesh, ssq_fs),
            lambda dt: jt.cwt(s20_(dt), ssq_scales, morlet, ssq_fs))
    pf_out = {dt: par.pfft(p20_(dt), mesh) for dt in sharded_in}
    sharded("pfft 8x2^20", lambda dt: par.pfft(p20_(dt), mesh),
            lambda dt: torch.fft.fft(p20_(dt)).reshape(8, 1, -1))
    sharded("pifft 8x2^20", lambda dt: par.pifft(pf_out[dt], mesh),
            lambda dt: torch.fft.ifft(pf_out[dt].full_tensor().reshape(8, -1)),
            ident=lambda dt:
                p20_(dt).to(torch.complex64 if dt == torch.float32 else torch.complex128))
    pf2_out = {dt: par.pfft2(img_(dt), mesh) for dt in sharded_in}
    sharded("pfft2 2048^2",
            lambda dt: par.pfft2(img_(dt), mesh), lambda dt: torch.fft.fft2(img_(dt)))
    sharded("pifft2 2048^2", lambda dt: par.pifft2(pf2_out[dt], mesh),
            lambda dt: torch.fft.ifft2(pf2_out[dt].full_tensor()),
            ident=lambda dt:
                img_(dt).to(torch.complex64 if dt == torch.float32 else torch.complex128))
    m2_out = {dt: par.modwt2d_sharded(img_(dt), "db4", 5, mesh) for dt in sharded_in}
    sharded("modwt2d_sharded db4 L5 2048^2 (K1)",
            lambda dt: par.modwt2d_sharded(img_(dt), "db4", 5, mesh),
            lambda dt: modwt_2d(img_(dt), "db4", 5), need=("K1",))
    sharded("imodwt2d_sharded db4 L5 2048^2 (K2)",
            lambda dt: par.imodwt2d_sharded(m2_out[dt], "db4", mesh),
            lambda dt: imodwt_2d(m2_out[dt].full_tensor(), "db4"), ident=img_, need=("K2",))
    torch.cuda.empty_cache()
    print(json.dumps({"sharded": "launches of phase 4j", "launches": sharded_launches}), flush=True)
    for k, v in sharded_launches.items():
        launches[k] += v

    # the examples, on the card, in this one-rank world
    from jwave_tpu_torch.examples import (adaptive_example, continuous_wavelets_example,
                                          cwt_example, denoise_example, image_pipeline_example,
                                          lifting_compression_example, modwt_example,
                                          scattering_classify_example, sharded_example,
                                          sliding_window_example, timefreq_example)
    example_s = {}
    for module in (sharded_example, adaptive_example, continuous_wavelets_example, cwt_example,
                   denoise_example, image_pipeline_example, lifting_compression_example,
                   modwt_example, scattering_classify_example, sliding_window_example,
                   timefreq_example):
        t0 = time.perf_counter()
        module.main()
        if module is cwt_example:
            module.inverse_demo()
        torch.cuda.synchronize()
        example_s[module.__name__.rsplit(".", 1)[1]] = time.perf_counter() - t0
    require(jt.config.conv_precision() == "highest", "an example left the dial changed")
    print(json.dumps({"examples": "each main() on the card returned", "seconds": example_s}),
          flush=True)
    torch.cuda.synchronize()

    # ---- 5. times --------------------------------------------------------
    # each timed run starts with a cold 50 MB L2, as a caller with fresh data
    # would find it (utils.profiling.median_ms)
    def median_ms(fn, reps=REPS, device=False):
        return profiling.median_ms(fn, reps, device)

    def pair(kernel, plain):
        """plain, kernel, kernel, plain, device time; the mean of each side's
        two medians, and the kernel side's wall time."""
        p1, k1 = median_ms(plain, device=True), median_ms(kernel, device=True)
        k2, p2 = median_ms(kernel, device=True), median_ms(plain, device=True)
        return (k1 + k2) / 2, (p1 + p2) / 2, None, median_ms(kernel)

    def turns(kernel, plain, library):
        """plain, library, kernel, kernel, library, plain, device time:
        (kernel, plain, library) ms, each the mean of two medians, and the
        kernel's wall time."""
        p1, l1 = median_ms(plain, device=True), median_ms(library, device=True)
        k1, k2 = median_ms(kernel, device=True), median_ms(kernel, device=True)
        l2, p2 = median_ms(library, device=True), median_ms(plain, device=True)
        return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2, median_ms(kernel)

    g0, h0 = _modwt_base_filters("db4")
    c32 = cuda_modwt.modwt_cascade(x, g0, h0, 5)
    done8 = cuda_pyramid.levels_done(65536, 2, 8)
    ximg = torch.as_tensor(img, device=dev)
    lo, hi = fb.dec_lo, fb.dec_hi
    fb_r = jt.get_filter("db4")
    rlo, rhi = fb_r.rec_lo, fb_r.rec_hi

    # One PyTorch call per kernel that computes the same function (library_ms;
    # the port never calls these), each checked against the plain version
    # once at the kernel's bound before it is timed. K1: conv1d of the input
    # padded circularly by (M-1)(2^J-1) = 217 on the left with the J+1
    # equivalent level filters (the cascade's response to an impulse, 218
    # taps, flipped: conv1d correlates) as output channels. K2, the adjoint:
    # conv1d of the coefficients padded by 217 on the right, J+1 input
    # channels, one output. K3: one matmul with the dense operator of a
    # 65536-sample row's pyramid (65536^2 f32, 17.2 GB), whose row i is the
    # plain version run on e_i in float64, built 1024 rows at a time. K4/K5:
    # one matmul with the dense 2048x2048 pass operator (the plain version
    # run on the identity in float64, then cast). K6: its plain
    # one-scatter_add_ route.
    pad = 7 * (2**5 - 1)
    delta = torch.zeros((1, 1024), dtype=torch.float64, device=dev)
    delta[0, 0] = 1.0
    eq = cuda_modwt.modwt_cascade_torch(delta, g0, h0, 5)[0, :, :pad + 1]  # (6, 218)
    w_k1 = eq.flip(-1).unsqueeze(1).float().contiguous()                   # (6, 1, 218)
    w_k2 = eq.unsqueeze(0).float().contiguous()                            # (1, 6, 218)
    x_pad = torch.cat([x[:, -pad:], x], dim=-1).unsqueeze(1).contiguous()
    c_pad = torch.cat([c32, c32[..., :pad]], dim=-1).contiguous()
    eye = torch.eye(2048, dtype=torch.float64, device=dev)
    op_k4 = cuda_pyramid.pyramid_rows_torch(eye, lo, hi, 6).t().float().contiguous()
    op_k5 = cuda_pyramid.ipyramid_rows_torch(eye, rlo, rhi, 1.0, 6).t().float().contiguous()
    del eye, delta
    t_op = time.perf_counter()
    op_k3 = torch.empty((65536, 65536), dtype=torch.float32, device=dev)
    for i0 in range(0, 65536, 1024):
        e_blk = torch.zeros((1024, 65536), dtype=torch.float64, device=dev)
        e_blk.diagonal(i0).fill_(1.0)
        op_k3[i0:i0 + 1024] = cuda_pyramid.pyramid_rows_torch(e_blk, lo, hi, done8).float()
    del e_blk
    torch.cuda.synchronize()
    print(json.dumps({"built": "K3's dense 65536^2 operator", "gb": op_k3.numel() * 4 / 1e9,
                      "s": time.perf_counter() - t_op}), flush=True)
    conv1d = torch.nn.functional.conv1d
    library = {
        "K1": lambda: conv1d(x_pad, w_k1),
        "K2": lambda: conv1d(c_pad, w_k2).squeeze(1),
        "K3": lambda: torch.matmul(x, op_k3),
        "K4": lambda: torch.matmul(op_k4, ximg.t()),
        "K5": lambda: torch.matmul(op_k5, ximg.t()),
        "K6": lambda: cuda_reassign.reassign_torch(contrib, k_idx, 64),
    }
    lib_refs = {
        "K1": lambda: cuda_modwt.modwt_cascade_torch(x.double(), g0, h0, 5),
        "K2": lambda: cuda_modwt.imodwt_cascade_torch(c32.double(), g0, h0),
        "K3": lambda: cuda_pyramid.pyramid_rows_torch(x.double(), lo, hi, done8),
        "K4": lambda: cuda_pyramid.pyramid_rows_transposed_torch(ximg.double(), lo, hi, 6),
        "K5": lambda: cuda_pyramid.ipyramid_rows_transposed_torch(ximg.double(), rlo, rhi, 1.0, 6),
        "K6": lambda: cuda_reassign.reassign_torch(contrib.to(torch.complex128), k_idx, 64),
    }
    for k, fn in library.items():
        got, ref = fn(), lib_refs[k]()
        if got.is_complex():
            got, ref = torch.view_as_real(got), torch.view_as_real(ref)
        compare(f"library call for {k} against its plain version", got, ref, F32_BOUND)
        del got, ref
    torch.cuda.synchronize()

    timing = {
        "K1": turns(lambda: cuda_modwt.modwt_cascade(x, g0, h0, 5),
                    lambda: cuda_modwt.modwt_cascade_torch(x, g0, h0, 5), library["K1"]),
        "K2": turns(lambda: cuda_modwt.imodwt_cascade(c32, g0, h0),
                    lambda: cuda_modwt.imodwt_cascade_torch(c32, g0, h0), library["K2"]),
        "K1+K2": pair(lambda: jt.imodwt(jt.modwt(x, "Daubechies 4", 5), "Daubechies 4"),
                      lambda: cuda_modwt.imodwt_cascade_torch(
                          cuda_modwt.modwt_cascade_torch(x, g0, h0, 5), g0, h0)),
        "K3": turns(lambda: cuda_pyramid.pyramid_rows(x, lo, hi, done8),
                    lambda: cuda_pyramid.pyramid_rows_torch(x, lo, hi, done8), library["K3"]),
        "K4": turns(lambda: cuda_pyramid.pyramid_rows_transposed(ximg, lo, hi, 6),
                    lambda: cuda_pyramid.pyramid_rows_transposed_torch(ximg, lo, hi, 6),
                    library["K4"]),
        "fwt2d": pair(lambda: jt.fwt2d(ximg, "db4", 6, 6),
                      lambda: cuda_pyramid.pyramid_rows_transposed_torch(
                          cuda_pyramid.pyramid_rows_transposed_torch(ximg, lo, hi, 6), lo, hi, 6)),
        "K5": turns(lambda: cuda_pyramid.ipyramid_rows_transposed(ximg, rlo, rhi, 1.0, 6),
                    lambda: cuda_pyramid.ipyramid_rows_transposed_torch(ximg, rlo, rhi, 1.0, 6),
                    library["K5"]),
        "ifwt2d": pair(lambda: jt.ifwt2d(ximg, "db4", 6, 6),
                       lambda: cuda_pyramid.ipyramid_rows_transposed_torch(
                           cuda_pyramid.ipyramid_rows_transposed_torch(ximg, rlo, rhi, 1.0, 6),
                           rlo, rhi, 1.0, 6)),
        "fwt": pair(lambda: jt.fwt(x, "db4", 8),
                    lambda: cuda_pyramid.pyramid_rows_torch(x, lo, hi, done8)),
        "K6": turns(lambda: cuda_reassign.reassign(contrib, k_idx, 64),
                    lambda: cuda_reassign.reassign_torch(contrib, k_idx, 64), library["K6"]),
        "ssq_cwt": pair(lambda: jt.ssq_cwt(xs, ssq_scales, morlet, ssq_fs),
                        lambda: jt.ssq_cwt(xs, ssq_scales, morlet, ssq_fs, reassign="scatter")),
    }
    del x_pad, c_pad, op_k3, op_k4, op_k5
    torch.cuda.empty_cache()
    # K7 on fwt's output: kernel, plain version, and one matmul with the
    # dense 65536^2 synthesis operator of a row (row i the plain version run
    # on e_i in float64), built as K3's was, after K3's is freed
    y8 = cuda_pyramid.pyramid_rows(x, lo, hi, done8)
    t_op = time.perf_counter()
    op_k7 = torch.empty((65536, 65536), dtype=torch.float32, device=dev)
    for i0 in range(0, 65536, 1024):
        e_blk = torch.zeros((1024, 65536), dtype=torch.float64, device=dev)
        e_blk.diagonal(i0).fill_(1.0)
        op_k7[i0:i0 + 1024] = cuda_pyramid.ipyramid_rows_torch(e_blk, rlo, rhi, 1.0, done8).float()
    del e_blk
    torch.cuda.synchronize()
    print(json.dumps({"built": "K7's dense 65536^2 operator", "gb": op_k7.numel() * 4 / 1e9,
                      "s": time.perf_counter() - t_op}), flush=True)
    compare("library call for K7 against its plain version", torch.matmul(y8, op_k7),
            cuda_pyramid.ipyramid_rows_torch(y8.double(), rlo, rhi, 1.0, done8), F32_BOUND)
    timing["K7"] = turns(lambda: cuda_pyramid.ipyramid_rows(y8, rlo, rhi, 1.0, done8),
                         lambda: cuda_pyramid.ipyramid_rows_torch(y8, rlo, rhi, 1.0, done8),
                         lambda: torch.matmul(y8, op_k7))
    timing["ifwt"] = pair(lambda: jt.ifwt(y8, "db4", 8),
                          lambda: cuda_pyramid.ipyramid_rows_torch(y8, rlo, rhi, 1.0, done8))
    del op_k7
    torch.cuda.empty_cache()
    # K8 and K9 at db4 L6 64x65536: kernel, plain version, and the conv form
    # they replace: one conv1d of 64 output channels of 442 taps, stride 64,
    # on the circularly extended input (K8), one conv_transpose1d and its
    # fold (K9), both inside the dial; each checked against the plain
    # version first
    w_k8 = _bank(lo, hi, 6, 65536, x)
    x_k8 = torch.cat([x, x[:, :w_k8.shape[-1] - 1]], dim=-1)[:, None].contiguous()
    y6 = cuda_wpt.wpt_rows(x, lo, hi, 6)

    def conv_k8():
        with jt.config.dial():
            return conv1d(x_k8, w_k8, stride=64)

    library["K8"] = lambda: conv_k8().reshape(64, 65536)
    library["K9"] = lambda: wpt_conv_inverse(y6, rlo, rhi, 6)
    compare("library call for K8 against its plain version", library["K8"](),
            cuda_wpt.wpt_analysis_torch(x.double(), lo, hi, 6), F32_BOUND)
    compare("library call for K9 against its plain version", library["K9"](),
            cuda_wpt.wpt_synthesis_torch(y6.double(), rlo, rhi, 6), F32_BOUND)
    timing["K8"] = turns(lambda: cuda_wpt.wpt_rows(x, lo, hi, 6),
                         lambda: cuda_wpt.wpt_analysis_torch(x, lo, hi, 6), conv_k8)
    timing["K9"] = turns(lambda: cuda_wpt.iwpt_rows(y6, rlo, rhi, 6),
                         lambda: cuda_wpt.wpt_synthesis_torch(y6, rlo, rhi, 6), library["K9"])
    timing["wpt"] = pair(lambda: jt.wpt(x, "db4", 6),
                         lambda: cuda_wpt.wpt_analysis_torch(x, lo, hi, 6))
    timing["iwpt"] = pair(lambda: jt.iwpt(y6, "db4", 6),
                          lambda: cuda_wpt.wpt_synthesis_torch(y6, rlo, rhi, 6))
    for k in ("K8", "K9"):
        print(json.dumps({"time": f"{k} db4 L6 64x65536", "ms": timing[k][0],
                          "first_design_ms": FIRST_DESIGN_MS[f"{k} 64x65536"], "card": card}),
              flush=True)
    # the packet cell's axis pass (8 frames of 2048^2 as 16384 rows of 2048,
    # db4 L6): the rotated K8 and K9 beside their plain versions, and K8 (K9)
    # in place followed by the transposing copy that the separable path made
    # before the rotated forms, in turns, device ms and their bound
    x2048 = torch.as_tensor(np.random.default_rng(15).standard_normal((16384, 2048)),
                            dtype=torch.float32, device=dev)
    bound_2048 = 2 * 4 * x2048.numel() / HBM_BYTES_S * 1e3
    for kernel_w, rotated_w, plain_w, in_place_w in (
            ("K8.rotated", lambda: cuda_wpt.wpt_rows_rotated(x2048, lo, hi, 6, 2048),
             lambda: cuda_wpt.wpt_analysis_rotated_torch(x2048, lo, hi, 6, 2048),
             lambda: cuda_wpt.wpt_rows(x2048, lo, hi, 6).view(8, 2048, 2048).transpose(
                 1, 2).contiguous()),
            ("K9.rotated", lambda: cuda_wpt.iwpt_rows_rotated(x2048, rlo, rhi, 6, 2048),
             lambda: cuda_wpt.wpt_synthesis_rotated_torch(x2048, rlo, rhi, 6, 2048),
             lambda: cuda_wpt.iwpt_rows(x2048, rlo, rhi, 6).view(8, 2048, 2048).transpose(
                 1, 2).contiguous())):
        timing[kernel_w] = pair(rotated_w, plain_w)
        c1, c2 = median_ms(in_place_w, device=True), median_ms(in_place_w, device=True)
        print(json.dumps({"time": f"{kernel_w} on 16384 rows of 2048 in groups of 2048, db4 "
                                  "L6: rotated, plain, and in place then a transposing copy",
                          "ms": timing[kernel_w][0], "plain_ms": timing[kernel_w][1],
                          "in_place_and_copy_ms": (c1 + c2) / 2, "bound_ms": bound_2048,
                          "card": card}), flush=True)
    # the 2D FWT cell's axis pass (the same rows): K4 and K5 in groups of
    # 2048 beside their plain versions, and K3 (K7) in place followed by the
    # transposing copy that the separable path makes, in turns
    for kernel_g, grouped_g, plain_g, in_place_g in (
            ("K4.grouped",
             lambda: cuda_pyramid.pyramid_rows_transposed(x2048, lo, hi, 6, group=2048),
             lambda: cuda_pyramid.pyramid_rows_transposed_torch(x2048, lo, hi, 6, group=2048),
             lambda: cuda_pyramid.pyramid_rows(x2048, lo, hi, 6).view(8, 2048, 2048).transpose(
                 1, 2).contiguous()),
            ("K5.grouped",
             lambda: cuda_pyramid.ipyramid_rows_transposed(x2048, rlo, rhi, 1.0, 6, group=2048),
             lambda: cuda_pyramid.ipyramid_rows_transposed_torch(x2048, rlo, rhi, 1.0, 6,
                                                                 group=2048),
             lambda: cuda_pyramid.ipyramid_rows(x2048, rlo, rhi, 1.0, 6).view(
                 8, 2048, 2048).transpose(1, 2).contiguous())):
        timing[kernel_g] = pair(grouped_g, plain_g)
        c1, c2 = median_ms(in_place_g, device=True), median_ms(in_place_g, device=True)
        print(json.dumps({"time": f"{kernel_g} on 16384 rows of 2048 in groups of 2048, db4 "
                                  "L6: grouped, plain, and in place then a transposing copy",
                          "ms": timing[kernel_g][0], "plain_ms": timing[kernel_g][1],
                          "in_place_and_copy_ms": (c1 + c2) / 2, "bound_ms": bound_2048,
                          "card": card}), flush=True)
    del x2048
    # K8's and K9's plans at the main shape and at wpt's full-depth chunks
    # that are whole rows: a stage set's, the buffer's and a block's bytes,
    # the blocks an SM holds (the occupancy calculator), the persistent grid,
    # items a block, registers and spills (-Xptxas -v), and the time
    ptx = wpt_ptxas(cuda_build.BUILD_LOG.get("wpt", (0.0, ""))[1])
    print(json.dumps({"ptxas": "wpt.cu", **ptx}), flush=True)
    require(all(v["spill_stores"] == 0 and v["spill_loads"] == 0 for v in ptx.values()),
            f"K8/K9 spill: {ptx}")
    for rows_p, n_p, lv_p in ((64, 65536, 6), (4096, 1024, 6), (262144, 16, 4)):
        x_p = x.reshape(rows_p, n_p)
        for name_p, inverse_p, fn_p in (("K8", False, cuda_wpt._k8), ("K9", True, cuda_wpt._k9)):
            plan_p = cuda_wpt.wpt_plan(n_p, lv_p, 8, inverse_p)
            grid_p = cuda_wpt.wpt_grid(dev, rows_p, n_p, lv_p, 8, inverse_p, plan_p)
            items_p = cuda_wpt.wpt_items(rows_p, n_p, plan_p)
            print(json.dumps({
                "plan": f"{name_p} {rows_p}x{n_p} db4 L{lv_p}", **plan_p._asdict(),
                "blocks_per_sm": cuda_wpt.wpt_blocks_per_sm(torch.cuda.current_device(), n_p,
                                                            lv_p, 8, inverse_p, plan_p),
                "sms": torch.cuda.get_device_properties(0).multi_processor_count,
                "grid": grid_p, "items": items_p,
                "items_a_block": [items_p // grid_p, -(-items_p // grid_p)],
                "ptxas": ptx.get(f"{name_p} db4"),
                "ms": median_ms(lambda: fn_p(x_p, lo, hi, lv_p), device=True),
                "first_design_ms": FIRST_DESIGN_MS[f"{name_p} {rows_p}x{n_p}"],
                "card": card}), flush=True)
    del x_k8
    shapes = {"K1": ("modwt db4 L5 64x65536", 64 * 65536, "Msamples_per_s"),
              "K2": ("imodwt db4 L5 64x65536", 64 * 65536, "Msamples_per_s"),
              "K1+K2": ("modwt+imodwt db4 L5 64x65536 (entry step)", 64 * 65536, "Msamples_per_s"),
              "K3": ("fwt db4 L8 64x65536", 64 * 65536, "Msamples_per_s"),
              "fwt": ("fwt db4 L8 64x65536 through jt.fwt (K3)", 64 * 65536, "Msamples_per_s"),
              "K7": ("ifwt db4 L8 64x65536", 64 * 65536, "Msamples_per_s"),
              "ifwt": ("ifwt db4 L8 64x65536 through jt.ifwt (K7)", 64 * 65536,
                       "Msamples_per_s"),
              "K4": ("one K4 pass db4 L6 2048x2048", 2048 * 2048, "Mpix_per_s"),
              "fwt2d": ("fwt2d db4 L6 2048x2048 (K4 x2)", 2048 * 2048, "Mpix_per_s"),
              "K5": ("one K5 pass db4 L6 2048x2048", 2048 * 2048, "Mpix_per_s"),
              "ifwt2d": ("ifwt2d db4 L6 2048x2048 (K5 x2)", 2048 * 2048, "Mpix_per_s"),
              "K6": ("reassign 8x64x65536 K=64 (ssq_cwt's block)", 8 * 64 * 65536,
                     "Mcoeff_per_s"),
              "K6.fused": ("K6's fused form 8x64x65536 K=64 (W, dW in; plain = squeeze_torch)",
                           8 * 64 * 65536, "Mcoeff_per_s"),
              "K6.peak": ("peak kernel 8x64x65536 (plain = torch.amax)", 8 * 64 * 65536,
                          "Mcoeff_per_s"),
              "K8": ("wpt_rows db4 L6 64x65536", 64 * 65536, "Msamples_per_s"),
              "K9": ("iwpt_rows db4 L6 64x65536", 64 * 65536, "Msamples_per_s"),
              "wpt": ("wpt db4 L6 64x65536 through jt.wpt (K8)", 64 * 65536, "Msamples_per_s"),
              "iwpt": ("iwpt db4 L6 64x65536 through jt.iwpt (K9)", 64 * 65536,
                       "Msamples_per_s"),
              "ssq_cwt": ("ssq_cwt 8x65536 f32, 64 scales (K6's fused form; plain = scatter route)",
                          8 * 64 * 65536, "Mcoeff_per_s"),
              "K3.rotated": ("pyramid_rows_rotated db4 L6 65536x256 (plain = K4's)",
                             65536 * 256, "Msamples_per_s"),
              "K7.rotated": ("ipyramid_rows_rotated db4 L6 65536x256 (plain = K5's)",
                             65536 * 256, "Msamples_per_s"),
              "K8.rotated": ("wpt_rows_rotated db4 L6 16384x2048 in groups of 2048 (the WPT "
                             "facade's 2D axis pass; plain = wpt_analysis_rotated_torch)",
                             16384 * 2048, "Msamples_per_s"),
              "K9.rotated": ("iwpt_rows_rotated db4 L6 16384x2048 in groups of 2048 (the WPT "
                             "facade's 2D axis pass; plain = wpt_synthesis_rotated_torch)",
                             16384 * 2048, "Msamples_per_s"),
              "K4.grouped": ("pyramid_rows_transposed db4 L6 16384x2048 in groups of 2048 (the "
                             "FWT facade's 2D axis pass; plain = pyramid_rows_transposed_torch)",
                             16384 * 2048, "Msamples_per_s"),
              "K5.grouped": ("ipyramid_rows_transposed db4 L6 16384x2048 in groups of 2048 (the "
                             "FWT facade's 2D axis pass; plain = "
                             "ipyramid_rows_transposed_torch)", 16384 * 2048, "Msamples_per_s")}
    fft = jt.ConvolutionMethod.FFT
    fft_ms = median_ms(lambda: jt.imodwt(jt.modwt(x, "Daubechies 4", 5, method=fft),
                                         "Daubechies 4", method=fft))
    print(json.dumps({"time": "modwt+imodwt torch FFT path (cuFFT, for context)",
                      "shape": "db4 L5 64x65536", "ms": fft_ms,
                      "Msamples_per_s": 64 * 65536 / fft_ms / 1e3, "card": card}), flush=True)
    # byte floors (device time): the same bytes moved without the kernel's
    # arithmetic, by K4/K5 themselves with no level and by torch copies and
    # reductions. K6's moves more than K6 does: the two clones read and write
    # 12 B a coefficient (806 MB), K6 reads them and writes 8 B a bin entry
    # (671 MB at 64 bins)
    floors = {}
    k1_out = torch.empty_like(c32)
    for k, label, shape, fn in (
            ("K1", "six copies of each input row (expand(-1, 6, -1).contiguous()), the bytes "
             "of K1", "64x65536 -> 64x6x65536",
             lambda: x.unsqueeze(1).expand(-1, 6, -1).contiguous()),
            ("K2", "sum over the 6 rows of the coefficients, the bytes of K2", "64x6x65536",
             lambda: c32.sum(1)),
            ("K3", "copy of the rows (clone), the bytes of K3", "64x65536", lambda: x.clone()),
            ("K6", "copies of the contributions and the bin indices (two clones), 806 MB "
             "moved against K6's 671", "8x64x65536",
             lambda: (contrib.clone(), k_idx.clone())),
            ("K4", "K4 pass with 0 levels (staging and transposed store only)", "2048x2048",
             lambda: cuda_pyramid.pyramid_rows_transposed(ximg, lo, hi, 0)),
            ("K5", "K5 pass with 0 levels (staging and transposed store only)", "2048x2048",
             lambda: cuda_pyramid.ipyramid_rows_transposed(ximg, rlo, rhi, 1.0, 0)),
            (None, "fill_ of a 64x6x65536 tensor, K1's output bytes written alone",
             "64x6x65536", lambda: k1_out.fill_(1.0)),
            (None, "copy of the image (clone), the bytes of one K4 or K5 pass", "2048x2048",
             lambda: ximg.clone()),
            (None, "transposed copy of the image (t().contiguous())", "2048x2048",
             lambda: ximg.t().contiguous())):
        ms = median_ms(fn, device=True)
        if k:
            floors[k] = ms
        print(json.dumps({"time": label, "shape": shape, "ms": ms, "card": card}), flush=True)
    floors["K7"] = floors["K8"] = floors["K9"] = floors["K3"]  # the same rows in and out
    # where K7's time goes: 1, 2, 4 and 8 levels of db4 (one launch each, the
    # same bytes but for the coarser cones), and Haar's one tap pair at 8
    fb_haar = jt.get_filter("Haar")
    k7_levels = {f"db4 L{lv}": median_ms(lambda lv=lv: cuda_pyramid.ipyramid_rows(
        x, rlo, rhi, 1.0, lv), device=True) for lv in (1, 2, 4, 8)}
    k7_levels["Haar L8"] = median_ms(lambda: cuda_pyramid.ipyramid_rows(
        x, fb_haar.rec_lo, fb_haar.rec_hi, 1.0, 8), device=True)
    print(json.dumps({"time": "K7 by levels, 64x65536 (device ms)", **k7_levels, "card": card}),
          flush=True)
    # K7 on ifwt3d's rows (65536 of 256, db4 L8: whole rows, 32 an item),
    # and the plans: a stage set's and a block's bytes, the blocks an SM
    # holds (the occupancy calculator), the persistent grid, items a block
    x256 = torch.as_tensor(np.random.default_rng(9).standard_normal((65536, 256)),
                           dtype=torch.float32, device=dev)
    print(json.dumps({"time": "K7 on 65536 rows of 256, db4 L8 (ifwt3d's rows)",
                      "ms": median_ms(lambda: cuda_pyramid.ipyramid_rows(x256, rlo, rhi, 1.0, 8),
                                      device=True),
                      "bound_ms": 2 * 4 * x256.numel() / HBM_BYTES_S * 1e3, "card": card}),
          flush=True)
    # the volume's axis passes (65536 rows of 256, db4 L6): the rotated K3
    # and K7 beside their plain versions (K4's and K5's, in f32 on the card)
    # and K3 and K7 in place with the transposing copy that followed them
    # before the rotated forms, in turns, device ms and their bound
    bound_256, bounds_rot = 2 * 4 * x256.numel() / HBM_BYTES_S * 1e3, {}
    for kernel_r, rotated_r, plain_r, in_place_r in (
            ("K3.rotated", lambda: cuda_pyramid.pyramid_rows_rotated(x256, lo, hi, 6),
             lambda: cuda_pyramid.pyramid_rows_transposed_torch(x256, lo, hi, 6),
             lambda: cuda_pyramid.pyramid_rows(x256, lo, hi, 6).t().contiguous()),
            ("K7.rotated", lambda: cuda_pyramid.ipyramid_rows_rotated(x256, rlo, rhi, 1.0, 6),
             lambda: cuda_pyramid.ipyramid_rows_transposed_torch(x256, rlo, rhi, 1.0, 6),
             lambda: cuda_pyramid.ipyramid_rows(x256, rlo, rhi, 1.0, 6).t().contiguous())):
        timing[kernel_r] = pair(rotated_r, plain_r)
        c1, c2 = median_ms(in_place_r, device=True), median_ms(in_place_r, device=True)
        bounds_rot[kernel_r] = (bound_256, "bytes")
        print(json.dumps({"time": f"{kernel_r} on 65536 rows of 256, db4 L6: rotated, plain, "
                                  "and in place then a transposing copy",
                          "rotated_ms": timing[kernel_r][0], "plain_ms": timing[kernel_r][1],
                          "in_place_and_copy_ms": (c1 + c2) / 2, "bound_ms": bound_256,
                          "share": bound_256 / timing[kernel_r][0], "card": card}), flush=True)
    del x256
    for rows_p, n_p, lv_p in ((64, 65536, done8), (65536, 256, 8)):
        plan_p = cuda_pyramid.k7_plan(n_p, lv_p, 8)
        grid_p = cuda_pyramid.k7_grid(dev, rows_p, n_p, lv_p, 8, plan_p)
        items_p = cuda_pyramid.k7_items(rows_p, n_p, plan_p)
        print(json.dumps({"plan": f"K7 {rows_p}x{n_p} db4 L{lv_p}", **plan_p._asdict(),
                          "blocks_per_sm": cuda_pyramid.k7_blocks_per_sm(
                              torch.cuda.current_device(), n_p, lv_p, 8, plan_p),
                          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
                          "grid": grid_p, "items": items_p,
                          "items_a_block": [items_p // grid_p, -(-items_p // grid_p)]}),
              flush=True)
    # K3 where its tiled levels leave a tail and K6 on two bin chunks
    for label, shape, fn in (
            ("K3 with a tail: fwt db4 L16 (8 tiled levels, a tail of 8, one launch)",
             "64x65536", lambda: cuda_pyramid.pyramid_rows(x, lo, hi, 16)),
            ("K6 at 128 bins (two bin chunks, each staging k_idx and c again)",
             "8x64x65536 K=128", lambda: cuda_reassign.reassign(contrib, k_idx128, 128))):
        print(json.dumps({"time": label, "shape": shape, "ms": median_ms(fn, device=True),
                          "wall_ms": median_ms(fn), "card": card}), flush=True)
    # K6's fused form and the peak kernel (the default threshold) at ssq_cwt's
    # 8 x 65536 block and at the ssq cell's chunk, 2 rows of 2^20: device ms
    # beside their bounds (W and dW read once and the plane written once; W
    # read once), their plain versions (squeeze_torch, the eager phase
    # transform then the scatter; torch.amax), in turns, and the eager phase
    # transform, bin index and unfused K6 that they replace. The peak kernel
    # is held to torch.amax bit for bit at each shape first. The kernels
    # line takes the 8 x 65536 block's times.
    wgt_f = torch.as_tensor(wgt, dtype=torch.float32, device=dev)
    grid_f = _bin_grid(bins, None, dev)
    fused_bounds = {}
    for rows_f, n_f in ((8, 65536), (2, 2**20)):
        xf = torch.as_tensor(np.random.default_rng(10).standard_normal((rows_f, n_f)),
                             dtype=torch.float32, device=dev)
        wf, dwf = _cwt_and_derivative(xf, ssq_scales, morlet, ssq_fs, jt.PaddingType.SYMMETRIC)
        shape_f = f"{rows_f}x64x{n_f}"
        peak_case(shape_f, wf)
        thr_f = cuda_reassign.row_threshold(wf, None)
        g_f = _default_gamma(wf)
        coeffs = rows_f * 64 * n_f

        def eager_f(wf=wf, dwf=dwf, g_f=g_f):
            return cuda_reassign.reassign(*_reassign_inputs(wf, dwf, wgt_f, bins, g_f, "clip"), 64)

        row = {"shape": f"{shape_f} K=64", "card": card}
        for label, kernel, plain, nbytes in (
                ("fused", lambda: cuda_reassign.squeeze(wf, dwf, wgt_f, thr_f, grid_f, "clip"),
                 lambda: cuda_reassign.squeeze_torch(wf, dwf, wgt_f, g_f, bins, "clip"),
                 (16 + 8) * coeffs),
                ("peak", lambda: cuda_reassign.row_peaks(wf),
                 lambda: torch.amax(wf.real ** 2 + wf.imag ** 2, dim=(-2, -1)), 8 * coeffs)):
            p1, k1 = median_ms(plain, device=True), median_ms(kernel, device=True)
            k2, p2 = median_ms(kernel, device=True), median_ms(plain, device=True)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            bound_ms = nbytes / HBM_BYTES_S * 1e3
            row.update({f"{label}_ms": ms, f"{label}_plain_ms": plain_ms,
                        f"{label}_bound_ms": bound_ms, f"{label}_share": bound_ms / ms})
            if rows_f == 8:
                key = "K6." + label
                timing[key] = (ms, plain_ms, None, median_ms(kernel))
                fused_bounds[key] = (bound_ms, "bytes")
        row["fused_with_peak_ms"] = median_ms(
            lambda: cuda_reassign.squeeze(wf, dwf, wgt_f, None, grid_f, "clip"), device=True)
        row["eager_then_unfused_ms"] = median_ms(eager_f, device=True)
        print(json.dumps({"time": "K6 fused form and peak kernel", **row}), flush=True)
        del xf, wf, dwf, thr_f, g_f
        torch.cuda.empty_cache()
    # The 1D inverse's route before K7 (ifwt, the facade's reverse and K3's
    # backward ran it): the synthesis butterflies. Each level uploads its
    # taps by a copy that waits for the stream, so the host cannot enqueue
    # ahead of a spin: its device time is the sum of its kernels' times in one
    # profiled call (warm L2), beside the wall time of a call.
    old_wall = median_ms(lambda: synthesis_levels(y8, rlo, rhi, done8))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        synthesis_levels(y8, rlo, rhi, done8)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    require(len(on_card) > 0, "the profiler saw no kernel of synthesis_levels")
    print(json.dumps({"time": "ifwt db4 L8 by its route before K7 (synthesis_levels, cuDNN "
                              "butterflies): sum of its kernels' device times, and wall",
                      "shape": "64x65536", "kernels": len(on_card),
                      "ms": sum(e.time_range.elapsed_us() for e in on_card) / 1e3,
                      "wall_ms": old_wall, "card": card}), flush=True)
    compare("ifwt(fwt(x)) = x, db4 L8 64x65536 (K7)", jt.ifwt(y8, "db4", 8), x, F32_BOUND)
    del y8
    # ifwt3d (the facade's 3D reverse) db4 256^3 and ifwt2d_sharded 2048^2
    # before and after K7, in turns (before, after, after, before): before
    # runs the same calls with the 1D inverse they reach set back to the
    # butterflies, device time (the spin) and wall
    from jwave_tpu_torch import api as jt_api
    from jwave_tpu_torch.parallel import sharded as par_sharded
    from jwave_tpu_torch.transforms import ndim as jt_ndim

    def ifwt_butterflies(y, wavelet, level=None):
        fb_b = jt.get_filter(wavelet)
        n_b = y.shape[-1]
        lv = n_b.bit_length() - 1 if level is None else level
        return synthesis_levels(y, fb_b.rec_lo, fb_b.rec_hi,
                                cuda_pyramid.levels_done(n_b, fb_b.transform_wavelength, lv),
                                fb_b.recon_gain)

    def ifwt3d_butterflies(y, wavelet, lp=None, lq=None, lr=None):
        return jt_ndim.reverse_3d(lambda v, lvl: ifwt_butterflies(v, wavelet, lvl), y, lp, lq, lr)

    def before(fn):
        def run():
            saved = jt_api.ifwt, jt_api.ifwt3d, par_sharded._PASSES["ifwt"]
            jt_api.ifwt = par_sharded._PASSES["ifwt"] = ifwt_butterflies
            jt_api.ifwt3d = ifwt3d_butterflies
            try:
                return fn()
            finally:
                jt_api.ifwt, jt_api.ifwt3d, par_sharded._PASSES["ifwt"] = saved
        return run

    vol_c = fwt3_out[torch.float32].full_tensor()
    for label, fn in (("ifwt3d db4 256^3 (the facade's 3D reverse)",
                       lambda: fwt_f.reverse(vol_c)),
                      ("ifwt2d_sharded db4 L6 2048^2 (one rank)",
                       lambda: par.ifwt2d_sharded(fwt2_out[torch.float32], "db4", mesh, 6, 6))):
        old_fn = before(fn)
        compare(f"{label}: after against before", full(fn()), full(old_fn()), F32_BOUND)
        b1, a1 = median_ms(old_fn, 10, device=True), median_ms(fn, 10, device=True)
        a2, b2 = median_ms(fn, 10, device=True), median_ms(old_fn, 10, device=True)
        print(json.dumps({"time": f"{label}, before (butterflies) and after (K7)",
                          "before_ms": (b1 + b2) / 2, "after_ms": (a1 + a2) / 2,
                          "before_wall_ms": median_ms(old_fn, 10),
                          "after_wall_ms": median_ms(fn, 10), "card": card}), flush=True)
    del vol_c
    # the WPT consumers before (the conv form: ops.composite's route for
    # every tensor before K8/K9) and after (K8, K9), in turns, device time
    # (the spin) and wall
    from jwave_tpu_torch.ops import composite as jt_composite

    def conv_route(fn):
        def run():
            saved = jt_composite._on_kernel
            jt_composite._on_kernel = lambda t: False
            try:
                return fn()
            finally:
                jt_composite._on_kernel = saved
        return run

    vol_w3 = full(wpt3_out[torch.float32])
    img_w2 = full(wpt2_out[torch.float32])
    for label, fn in (("wpt db4 L6 64x65536", lambda: jt.wpt(x, "db4", 6)),
                      ("iwpt db4 L6 64x65536", lambda: jt.iwpt(y6, "db4", 6)),
                      ("wpt db4 full depth 64x65536 (3 fused chunks)", lambda: jt.wpt(x, "db4")),
                      ("WPT facade 2D forward 2048^2 db4 full depth", lambda: wpt_f.forward(ximg)),
                      ("WPT facade 2D reverse 2048^2 db4 L6", lambda: wpt_f.reverse(img_w2, 6, 6)),
                      ("WPT facade 3D forward 256^3 db4 L4 (wpt3d)",
                       lambda: wpt_f.forward(vol_w3, 4, 4, 4)),
                      ("WPT facade 3D reverse 256^3 db4 L4 (iwpt3d)",
                       lambda: wpt_f.reverse(vol_w3, 4, 4, 4)),
                      ("wpt2d_sharded db4 L6 2048^2 (one rank)",
                       lambda: par.wpt2d_sharded(ximg, "db4", mesh, 6, 6)),
                      ("iwpt2d_sharded db4 L6 2048^2 (one rank)",
                       lambda: par.iwpt2d_sharded(wpt2_out[torch.float32], "db4", mesh, 6, 6))):
        old_fn = conv_route(fn)
        compare(f"{label}: after against before", full(fn()), full(old_fn()), F32_BOUND)
        b1, a1 = median_ms(old_fn, 10, device=True), median_ms(fn, 10, device=True)
        a2, b2 = median_ms(fn, 10, device=True), median_ms(old_fn, 10, device=True)
        print(json.dumps({"time": f"{label}, before (the conv form) and after (K8, K9)",
                          "before_ms": (b1 + b2) / 2, "after_ms": (a1 + a2) / 2,
                          "first_design_ms": FIRST_DESIGN_MS[label.split(" (")[0]],
                          "before_wall_ms": median_ms(old_fn, 10),
                          "after_wall_ms": median_ms(fn, 10), "card": card}), flush=True)
    del vol_w3, img_w2, y6
    sep_ms = median_ms(lambda: ndim.reverse_2d(lambda v, lvl: jt.ifwt(v, "db4", lvl), ximg, 6, 6))
    dense_ms = median_ms(lambda: cuda_reassign.reassign_dense_torch(contrib, k_idx, 64))
    for label, shape, ms in (
            ("ifwt2d separable torch-butterfly path (before K5, for context)",
             "db4 L6 2048x2048", sep_ms),
            ("reassign plain bin loop (reassign='dense', for context)",
             "8x64x65536 K=64", dense_ms)):
        print(json.dumps({"time": label, "shape": shape, "ms": ms, "card": card}), flush=True)
    # the new paths: the entry step's gradient beside autograd of the plain
    # versions, and the calls of 4d-4g (no plain version: eager torch)
    xg = x.detach().requires_grad_()
    wg = torch.as_tensor(np.random.default_rng(7).standard_normal((64, 65536)),
                         dtype=torch.float32, device=dev)

    def entry_grad(mw, imw):
        return torch.autograd.grad((imw(mw(xg)) * wg).sum(), xg)

    timing["entry grad"] = pair(
        lambda: entry_grad(lambda a: jt.modwt(a, "db4", 5), lambda c: jt.imodwt(c, "db4")),
        lambda: entry_grad(lambda a: cuda_modwt.modwt_cascade_torch(a, g0, h0, 5),
                           lambda c: cuda_modwt.imodwt_cascade_torch(c, g0, h0)))
    shapes["entry grad"] = ("grad of (imodwt(modwt(x)) * w).sum(), db4 L5 64x65536 "
                            "(plain = autograd of the plain versions)", 64 * 65536,
                            "Msamples_per_s")
    # fwt2d's gradient: forward K4 x2, backward K5 x2
    ximg_g = ximg.detach().requires_grad_()
    w_img = torch.as_tensor(np.random.default_rng(7).standard_normal((2048, 2048)),
                            dtype=torch.float32, device=dev)
    timing["fwt2d grad"] = pair(
        lambda: torch.autograd.grad((jt.fwt2d(ximg_g, "db4", 6, 6) * w_img).sum(), ximg_g),
        lambda: torch.autograd.grad((k4x2_plain(ximg_g, fb4, 6) * w_img).sum(), ximg_g))
    shapes["fwt2d grad"] = ("grad of (fwt2d(x) * w).sum(), db4 L6 2048x2048, backward K5 x2 "
                            "(plain = autograd of the plain versions)", 2048 * 2048,
                            "Mpix_per_s")
    # ifwt2d's gradient: forward K5 x2, backward K4 x2
    timing["ifwt2d grad"] = pair(
        lambda: torch.autograd.grad((jt.ifwt2d(ximg_g, "db4", 6, 6) * w_img).sum(), ximg_g),
        lambda: torch.autograd.grad((k5x2_plain(ximg_g, fb4, 6) * w_img).sum(), ximg_g))
    shapes["ifwt2d grad"] = ("grad of (ifwt2d(x) * w).sum(), db4 L6 2048x2048, backward K4 x2 "
                             "(plain = autograd of the plain versions)", 2048 * 2048,
                             "Mpix_per_s")
    st_t = sl.init(stream[:, :wlen])
    chunk = stream[:, wlen:wlen + step]
    xbench = torch.as_tensor(np.random.default_rng(25).standard_normal((8, 65536)),
                             dtype=torch.float32, device=dev)
    calls = {
        "denoise_modwt_8x64K (db4 L4, universal soft)": (lambda: jt.denoise(xbench, "db4", 4),
                                                          8 * 65536),
        "modwt_mra db4 L5 64x65536": (lambda: jt.modwt_mra(x, "db4", 5), 64 * 65536),
        "one sliding update, 8 streams, db4 L8, chunk 64": (lambda: sl.update(st_t, chunk),
                                                            8 * 64),
        "wigner_ville 8x4096, 512 bins": (lambda: jt.wigner_ville(xw, 1.0, n_bins=512),
                                          8 * 4096),
        "superlet 8x16384, 64 freqs, order 16": (lambda: jt.superlet(xsl, sl_freqs, 1000.0),
                                                 8 * 16384),
        "ewt -> iewt 8x16384, 5 modes": (lambda: jt.iewt(jt.ewt(xe, boundaries=ewt_b)),
                                         8 * 16384),
        "vmd K=3 N=2048, 300 iterations": (lambda: jt.vmd(xv, 3), 2048),
        "matching_pursuit 16 atoms 4x2048": (lambda: jt.matching_pursuit(xm, 16), 4 * 2048),
        "analytic_signal 8x65536": (lambda: jt.analytic_signal(xan), 8 * 65536),
    }
    for label, (fn, count) in calls.items():
        reps = 5 if label.startswith("vmd") else REPS
        ms = median_ms(fn, reps)
        print(json.dumps({"time": label, "ms": ms, "Msamples_per_s": count / ms / 1e3,
                          "card": card}), flush=True)

    # 4h's calls: device time (the spin; a call that waits for the stream, as
    # each butterfly's tap upload does, carries its host gaps into it) and
    # wall. WPT fused against level by level in each direction, in turns, with
    # the sum of its kernels' device times in one profiled call (warm L2) and
    # its byte bound: 64x65536 f32 read once and written once.
    def device_events(fn):
        """(name, ms) of each kernel and copy on the card in one profiled call."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def busy_ms(fn):
        ev = device_events(fn)
        return sum(ms for _, ms in ev), len(ev)

    yw_f, yw_l = jt.wpt(xp, "db4", 6), jt.wpt(xp, "db4", 6, fused=False)
    xa_t = torch.as_tensor(xa_np, device=dev)        # timed on the card: no upload inside
    stream_t = torch.as_tensor(stream_np, device=dev)
    wpt_bytes = 2 * xp.numel() * 4
    wpt_bound = wpt_bytes / HBM_BYTES_S * 1e3
    for direction, fused_fn, level_fn in (
            ("wpt", lambda: jt.wpt(xp, "db4", 6), lambda: jt.wpt(xp, "db4", 6, fused=False)),
            ("iwpt", lambda: jt.iwpt(yw_f, "db4", 6),
             lambda: jt.iwpt(yw_l, "db4", 6, fused=False))):
        f1, l1 = median_ms(fused_fn, device=True), median_ms(level_fn, device=True)
        l2, f2 = median_ms(level_fn, device=True), median_ms(fused_fn, device=True)
        (bf, nf), (bl, nl) = busy_ms(fused_fn), busy_ms(level_fn)
        print(json.dumps({
            "time": f"{direction} db4 L6 64x65536: fused (one composite conv) against level by "
                    "level (six butterflies)",
            "fused_ms": (f1 + f2) / 2, "level_ms": (l1 + l2) / 2,
            "fused_wall_ms": median_ms(fused_fn), "level_wall_ms": median_ms(level_fn),
            "fused_kernels_busy_ms": bf, "fused_kernels": nf,
            "level_kernels_busy_ms": bl, "level_kernels": nl,
            "bound_ms": wpt_bound, "bound_by": "bytes", "bound_bytes": wpt_bytes,
            "Msamples_per_s_fused": xp.numel() / ((f1 + f2) / 2) / 1e3, "card": card}),
            flush=True)
    del yw_f, yw_l
    buf_t = xp.clone()
    calls_h = {
        "wpt -> iwpt db4 L6 64x65536 interleaved": (
            lambda: jt.iwpt(jt.wpt(xp, "db4", 6, layout="interleaved"), "db4", 6,
                            layout="interleaved"), 64 * 65536),
        "WPT facade 2D forward 2048x2048 db4 full depth": (lambda: wpt_t.forward(img_w),
                                                            2048 * 2048),
        "best_basis db4 8x65536 max level 6": (lambda: jt.best_basis(xbb, "db4", 6), 8 * 65536),
        "best_basis_2d db4 512x512 L4": (lambda: jt.best_basis_2d(img512, "db4", 4), 512 * 512),
        "AED over FWT db4 64x100000 forward (6 K3 launches)": (
            lambda: aed_b.forward(xa_t), 64 * 100000),
        "shifting_forward db4 64x65536": (lambda: jt.shifting_forward(xp, "db4"), 64 * 65536),
        "lifting_fwt -> lifting_ifwt CDF 9/7 L8 64x65536 periodic": (
            lambda: jt.lifting_ifwt(jt.lifting_fwt(xp, "CDF 9/7", 8), "CDF 9/7", 8), 64 * 65536),
        "dtcwt -> idtcwt L6 8x65536": (lambda: jt.idtcwt(jt.dtcwt(xd, 6)), 8 * 65536),
        "dtcwt2d -> idtcwt2d L4 512x512": (lambda: jt.idtcwt2d(jt.dtcwt2d(img512, 4)),
                                           512 * 512),
        "denoise_dtcwt 512x512 L4": (lambda: jt.denoise_dtcwt(img512, 4), 512 * 512),
        "InPlaceFastWaveletTransform.forward_in_place 64x65536 (K3)": (
            lambda: ip.forward_in_place(buf_t), 64 * 65536),
        "forward_streaming db4 L5 2^20 samples, chunks of 65536 (16 K1)": (
            lambda: eff.forward_streaming(stream_t, 5, 65536), 1 << 20),
        "PooledMODWTTransform round trip db4 L5 64x65536 (K1, K2)": (pooled_round, 64 * 65536),
        "CompressorMagnitude 2048x2048": (lambda: comp.compress(img_w), 2048 * 2048),
    }
    for label, (fn, count) in calls_h.items():
        ms = median_ms(fn, 10, device=True)
        print(json.dumps({"time": label, "ms": ms, "wall_ms": median_ms(fn, 10),
                          "Msamples_per_s": count / ms / 1e3, "card": card}), flush=True)
    del buf_t, xa_t, stream_t
    # 4i's calls: device time (the spin) and wall; time_fn's mean of the same
    # call (host clock, a synchronize after each); from one profiled call the
    # busy time, its kernels and cuFFT's share; the peak memory of a warm call
    # above its input; the FFT rounds' bytes and their time at 3.35 TB/s
    for label, (fn, count, unit) in scat_calls.items():
        ms = median_ms(fn, device=True)
        ev = device_events(fn)
        busy = sum(t for _, t in ev)
        fft_ms = sum(t for name, t in ev if "fft" in name.lower())
        print(json.dumps({"time": label + " f32 (cuFFT, no kernel of this package)", "ms": ms,
                          "wall_ms": median_ms(fn), "time_fn_ms": time_fn_ms[label],
                          "busy_ms": busy, "kernels": len(ev), "cufft_ms": fft_ms,
                          "cufft_share_of_busy": fft_ms / busy,
                          "peak_memory_mb": peak[label] / 2**20, "fft_bytes": fft_bytes[label],
                          "fft_bytes_ms": fft_bytes[label] / HBM_BYTES_S * 1e3,
                          unit: count / ms / 1e3, "card": card}), flush=True)
    for key, (ms, plain_ms, lib_ms, wall_ms) in timing.items():
        label, count, unit = shapes[key]
        extra = {"library_ms": lib_ms} if lib_ms is not None else {}
        print(json.dumps({"time": key, "shape": label, "ms": ms, "plain_ms": plain_ms, **extra,
                          "wall_ms": wall_ms, unit: count / ms / 1e3,
                          f"plain_{unit}": count / plain_ms / 1e3, "card": card}), flush=True)
    torch.cuda.synchronize()

    # 4j's calls beside their single-device counterparts, in turns: device
    # time (the spin) and wall. On one rank the difference is the sharded
    # layer's own cost: the block layout, the collectives of a one-rank NCCL
    # group, the DTensor around the result; the halo and tile FWTs are timed
    # without gather_pyramid's host permutation
    for label, (shard_fn, single_fn) in sharded_calls.items():
        s1, o1 = median_ms(single_fn, 10, device=True), median_ms(shard_fn, 10, device=True)
        o2, s2 = median_ms(shard_fn, 10, device=True), median_ms(single_fn, 10, device=True)
        ms_sh, ms_si = (o1 + o2) / 2, (s1 + s2) / 2
        print(json.dumps({"time": f"sharded {label}", "ms": ms_sh, "single_ms": ms_si,
                          "overhead_ms": ms_sh - ms_si, "wall_ms": median_ms(shard_fn, 10),
                          "single_wall_ms": median_ms(single_fn, 10), "card": card}), flush=True)
    torch.cuda.synchronize()

    # The least time the card could take for each kernel's work at the timed
    # shape: the larger of the bytes it must move (each input read once, each
    # output written once) over 3.35 TB/s and its FLOPs over the 67 TFLOP/s
    # float32 rate (H100 SXM data sheet, at 700 W). All nine are bound by
    # bytes. K1/K2: 64x65536 in, 64x6x65536 out (or the reverse), 2M FMAs
    # per sample and level; K3 and K7: 64x65536 in and out, ~2N*M FMAs a row;
    # K4/K5 one pass: 2048^2 in and out, the same FMAs per row; K6: the
    # complex64 contributions and int32 bins in, the complex64 plane out, 2
    # adds each; K8/K9 db4 L6: 64x65536 in and out, M FMAs a sample and level
    # (K8.rotated/K9.rotated: the same at 16384x2048, the packet cell's rows;
    # K4.grouped/K5.grouped: K4's and K5's at 16384x2048, the 2D FWT cell's).
    hbm, f32_rate = HBM_BYTES_S, 67e12
    b, n_s, lv, m8 = 64, 65536, 5, 8
    work = {"K1": (4 * b * n_s * (lv + 2), 2 * 2 * m8 * b * n_s * lv),
            "K2": (4 * b * n_s * (lv + 2), 2 * 2 * m8 * b * n_s * lv),
            "K3": (2 * 4 * b * n_s, 2 * 2 * n_s * m8 * b),
            "K4": (2 * 4 * 2048 * 2048, 2 * 2 * 2048 * m8 * 2048),
            "K5": (2 * 4 * 2048 * 2048, 2 * 2 * 2048 * m8 * 2048),
            "K6": (contrib.numel() * (8 + 4) + 8 * 64 * contrib.shape[-1] * 8,
                   2 * contrib.numel()),
            "K7": (2 * 4 * b * n_s, 2 * 2 * n_s * m8 * b),
            "K8": (2 * 4 * b * n_s, 2 * m8 * 6 * b * n_s),
            "K9": (2 * 4 * b * n_s, 2 * m8 * 6 * b * n_s),
            "K8.rotated": (2 * 4 * 16384 * 2048, 2 * m8 * 6 * 16384 * 2048),
            "K9.rotated": (2 * 4 * 16384 * 2048, 2 * m8 * 6 * 16384 * 2048),
            "K4.grouped": (2 * 4 * 16384 * 2048, 2 * 2 * 2048 * m8 * 16384),
            "K5.grouped": (2 * 4 * 16384 * 2048, 2 * 2 * 2048 * m8 * 16384)}
    bounds = {}
    for k, (nbytes, flops) in work.items():
        t_bytes, t_ops = nbytes / hbm * 1e3, flops / f32_rate * 1e3
        bounds[k] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    bounds.update(fused_bounds)  # K6's fused form and the peak kernel, at 8x64x65536
    bounds.update(bounds_rot)  # the rotated K3 and K7, at 65536x256 db4 L6
    # they record no gradient: ssq_cwt takes the unfused K6 where one is recorded
    for k in ("K6.fused", "K6.peak"):
        backward[k] = ("none: records no gradient (the unfused K6 takes a recorded one)", None)

    csrc = "jwave_tpu_torch/csrc/"
    table = [
        ("K1 modwt_cascade", "modwt.cu", "jwave_tpu/ops/pallas_modwt.py:53"),
        ("K2 imodwt_cascade", "modwt.cu", "jwave_tpu/ops/pallas_modwt.py:93"),
        ("K3 pyramid_rows", "pyramid.cu", "jwave_tpu/ops/pallas_pyramid.py:299"),
        ("K4 pyramid_rows_transposed", "pyramid.cu", "jwave_tpu/ops/pallas_pyramid.py:141"),
        ("K5 ipyramid_rows_transposed", "pyramid.cu", "jwave_tpu/ops/pallas_pyramid.py:538"),
        ("K6 reassign", "reassign.cu", "jwave_tpu/ops/pallas_reassign.py:29"),
        # the XLA-fused phase transform and bin index that feed _reassign_kernel
        ("K6.fused reassign_kernel<Phase> (W and dW in)", "reassign.cu",
         "jwave_tpu/transforms/ssq.py:162-200"),
        # the default threshold's max |W|^2, an XLA reduction on the TPU
        ("K6.peak ssq_peak_kernel", "reassign.cu", "jwave_tpu/transforms/ssq.py:327"),
        # no pallas_call: the counterpart of the XLA/MXU fused inverse pyramid
        ("K7 ipyramid_rows", "pyramid.cu", "jwave_tpu/ops/mxu_pyramid.py:159"),
        # no pallas_call: the counterparts of the MXU tile form of the fused WPT
        ("K8 wpt_rows", "wpt.cu", "jwave_tpu/ops/mxu_wpt.py:87"),
        ("K9 iwpt_rows", "wpt.cu", "jwave_tpu/ops/mxu_wpt.py:125"),
        # no kernel: the volume's axis passes, an XLA transpose between them
        ("K3.rotated pyramid_rows_rotated", "pyramid.cu", "jwave_tpu/transforms/ndim.py:38"),
        ("K7.rotated ipyramid_rows_rotated", "pyramid.cu", "jwave_tpu/transforms/ndim.py:54"),
        # no kernel: the packet cell's 2D axis passes, an XLA transpose between them
        ("K8.rotated wpt_rows_rotated", "wpt.cu", "jwave_tpu/transforms/ndim.py:16"),
        ("K9.rotated iwpt_rows_rotated", "wpt.cu", "jwave_tpu/transforms/ndim.py:30"),
        # no kernel: a stack's 2D FWT axis passes, an XLA transpose between them
        ("K4.grouped pyramid_rows_transposed(group=)", "pyramid.cu",
         "jwave_tpu/transforms/ndim.py:16"),
        ("K5.grouped ipyramid_rows_transposed(group=)", "pyramid.cu",
         "jwave_tpu/transforms/ndim.py:30"),
    ]
    # the rotated forms count as K3's and K7's launches; their own are phase
    # 4a''s, the volume's main path, and are not told apart in phase 4j
    for k, (side, base) in {"K3.rotated": ("forward", "K3"),
                            "K7.rotated": ("reverse", "K7")}.items():
        launches[k] = main_launches[k] = vol_launches[side][base]
        sharded_launches[k] = None
    # the rotated K8 and K9 count as K8's and K9's launches; phase 4a'' (the
    # packet cell's main path) counts theirs
    for k, (side, base) in {"K8.rotated": ("forward", "K8"),
                            "K9.rotated": ("reverse", "K9")}.items():
        launches[k] = main_launches[k] = stack_launches[side][base]
        sharded_launches[k] = None
    # K4 and K5 in groups count as K4's and K5's launches; phase 4a''' (the
    # 2D FWT cell's main path) counts theirs
    for k, (side, base) in {"K4.grouped": ("forward", "K4"),
                            "K5.grouped": ("reverse", "K5")}.items():
        launches[k] = main_launches[k] = frames_launches[side][base]
        sharded_launches[k] = None
    kernels = []
    for (name, src, replaces) in table:
        k = name.split()[0]
        # K6's own row counts the unfused form's launches; K6.fused the fused form's
        fused = launches["K6.fused"], sharded_launches["K6.fused"]
        own = (launches[k] - fused[0], sharded_launches[k] - fused[1]) if k == "K6" else (
            launches[k], sharded_launches[k])
        kernels.append({"name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
                        "launches": own[0], "max_abs_err": errors[k],
                        "main_path_launches": main_launches[k],
                        "phase_4j_launches": own[1],
                        "ms": timing[k][0], "plain_ms": timing[k][1],
                        "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                        "share_of_bound": bounds[k][0] / timing[k][0],
                        "library_ms": timing[k][2], "floor_ms": floors.get(k),
                        "backward": {"route": backward[k][0], "max_abs_err": backward[k][1]}})
    bench_phase(card)
    census_phase(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


#: bench rows that must launch each kernel (K5 has none: bench.py has no ifwt2d row)
BENCH_KERNELS = {
    "K1": ("modwt_db4_L5", "modwt_db4_L5_pallas", "modwt_db4_L5_bf16dial",
           "denoise_modwt_8x64K", "sliding_modwt_w512_L8_step64", "pallas_smoke"),
    "K2": ("denoise_modwt_8x64K", "pallas_smoke"),
    "K3": ("fwt1d_db4_L8", "fwt1d_db4_L8_256x16K_pallas", "fwt3d_db4_L4_256", "pallas_smoke"),
    "K4": ("fwt2d_db4_L6_2048", "fwt2d_db4_L6_2048_bf16dial"),
    "K6": ("ssq_cwt_64scales_8x64K",),
    "K6.fused": ("ssq_cwt_64scales_8x64K",),
    "K7": ("pallas_smoke",),
    "K8": ("wpt_db4_L6",),
}
#: the sweep's lines: its three sections, then the card's rows
SWEEP_KEYS = ("modwt_sweep_us", "wpt_sweep", "cwt_sweep", "fwt1d_db4_L8_conv_us",
              "wpt_db4_L6_conv_us", "fwt2d_db4_L6_2048_default_us", "fwt2d_db4_L6_2048_high_us",
              "fwt2d_db4_L6_2048_highest_us", "wpt_fwd_interleaved_us")


def bench_phase(card: str):
    """Phase 6: the port's bench entry point on the card, in this process:
    bench.main() (every row of bench.py), bench.sweep() and pallas_smoke().
    The rows' lines are read here and summed up one line a row."""
    import contextlib
    import io
    import os
    import re

    from jwave_tpu_torch import bench

    t0 = time.perf_counter()
    os.environ["BENCH_BUDGET_S"] = "300"
    outs = {}
    for label, fn in (("rows", bench.main), ("sweep", bench.sweep),
                      ("smoke", bench.pallas_smoke)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = fn()
        outs[label] = (result, [ln for ln in buf.getvalue().splitlines() if ln])
    details, rows_out = outs["rows"]
    headline = json.loads(rows_out[-1])
    print(json.dumps({"bench": "headline", **headline}), flush=True)
    require(headline["metric"] == "MODWT-db4-L5 throughput per chip"
            and headline["unit"] == "Msamples/s" and headline["value"] > 0
            and headline["device"] == card and headline["partial"] is False,
            f"the bench's last line is not its headline: {rows_out[-1][:300]}")
    src = (ROOT / "bench.py").read_text()
    names = (set(re.findall(r'\brow\(\s*"([^"]+)"', src))
             | set(re.findall(r'details\["([^"]+)"\]', src)))
    rows = {k: v for k, v in details.items() if isinstance(v, dict)}
    require(set(rows) == names and len(names) == 28,
            f"bench rows {sorted(set(rows) ^ names)} differ from bench.py's")
    for name, r in rows.items():
        brief = {k: r.get(k) for k in ("ms", "wall_ms", "host_syncs", "launches", "err", "bound")
                 if k in r}
        if name == "sliding_modwt_w512_L8_step64":
            brief.update({k: r[k] for k in ("us_per_update", "us_recompute_per_window",
                                             "wall_us_per_update_in_chain") if k in r})
        if name == "modwt_sweep_us_b8_L4":
            brief.update({k: v for k, v in r.items() if k[0].isdigit()})
        print(json.dumps({"bench_row": name, **brief, **{k: r[k] for k in (
            "skipped", "error", "ok", "picks_equal") if k in r}}), flush=True)
    require(bench.failures(details) == [], f"bench rows with errors: {bench.failures(details)}")
    require(not [k for k, r in rows.items() if "skipped" in r],
            f"bench rows skipped: {[k for k, r in rows.items() if 'skipped' in r]}")
    require(all(r["err"] <= r["bound"] for r in rows.values() if "err" in r),
            "a bench row's error is over its bound")
    for k, row_names in BENCH_KERNELS.items():
        for name in row_names:
            got = rows[name].get("launches", {}).get(k, 0)
            require(got > 0, f"bench row {name} launched {k} {got} times")
    sweep_lines = [d for d in map(json.loads, (ln for ln in outs["sweep"][1] if ln[0] == "{"))
                   if "build_s" not in d]
    require({next(iter(d)) for d in sweep_lines} == set(SWEEP_KEYS),
            f"sweep lines {[next(iter(d)) for d in sweep_lines]}")
    for d in sweep_lines:
        print(json.dumps({"bench_sweep": d}), flush=True)
    smoke = outs["smoke"][0]
    print(json.dumps({"bench": "pallas_smoke", **smoke}), flush=True)
    require(smoke["ok"] and details["pallas_smoke"]["ok"], f"pallas_smoke: {smoke}")
    print(json.dumps({"bench": "phase 6 seconds", "s": time.perf_counter() - t0,
                      "bench_elapsed_s": headline["elapsed_s"]}), flush=True)
    torch.cuda.synchronize()


def census_phase(card: str):
    """Phase 7: the parity census on the card. Every case of
    tests/torch_census_cases.py that runs on the card (``Case.card``), in
    each of its dtypes: the port's call on CUDA tensors against the same
    call on the CPU in float64 (raise or return and the exception's class,
    structure, shapes, values within the case's bound, discrete outputs
    exactly), its dtypes against the CPU's in the same input dtype, and
    every output tensor on the card. A difference in a leaf the case names
    as a near-tie (float32 taking the other side of a tie) is printed, not
    failed. The launch counts are set to 0 before the phase and read after
    it; the card-only cases at the kernels' eligibility edges print theirs,
    and each that names a kernel must launch it in float32."""
    import torch_census_cases as census

    import jwave_tpu_torch as jt
    from jwave_tpu_torch import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    runs, cases, mismatches, ties = 0, 0, [], []
    for c in census.CASES:
        if not c.card:
            continue
        cases += 1
        for dtype in c.card_dtypes:
            before = ops.launch_counts()
            bad, tied = census.run_on_card(c, jt, dtype)
            runs += 1
            mismatches += [f"{c.name} [{dtype}] {b}" for b in bad]
            ties += [f"{c.name} [{dtype}] {t}" for t in tied]
            if c.file.startswith("card"):
                after = ops.launch_counts()
                edge = {k: after[k] - before[k] for k in after if after[k] > before[k]}
                print(json.dumps({"census_edge": c.name, "dtype": dtype, "ok": not bad,
                                  "launches": edge}), flush=True)
                if c.kernel and dtype == "float32" and c.kernel not in edge:
                    mismatches.append(f"{c.name} [{dtype}] launched no {c.kernel}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for line in mismatches[:60]:
        print(json.dumps({"census_mismatch": line}), flush=True)
    for line in ties:
        print(json.dumps({"census_near_tie": line}), flush=True)
    print(json.dumps({"census": "phase 7", "cases": cases, "runs": runs,
                      "mismatches": len(mismatches), "near_ties": len(ties),
                      "launches": launches, "s": time.perf_counter() - t0, "card": card}),
          flush=True)
    require(not mismatches, f"census: {len(mismatches)} mismatches, first {mismatches[:3]}")
    # every census case on the card pins gamma, so the peak kernel does not run here
    require(all(launches[k] > 0 for k in launches if k != "K6.peak"),
            f"census: a kernel was not launched: {launches}")


if __name__ == "__main__":
    sys.exit(main())
