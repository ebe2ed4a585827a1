"""Another commit's kernels against this tree's, in one process on one CUDA
card: the kernels and their consumers.

    python3 tools/ab_times.py --parent build/parent [--rounds 6] [--reps 25]
                              [--variants parent new] [--calls TEXT ...]
                              [--out build/ab_times.jsonl] [--trace] [--k3-plans]
                              [--k7-plans] [--wpt-plans] [--rot-plans]

``--parent`` is another commit's tree, unpacked (``git archive <commit> |
tar -x -C build/parent``). Its ``jwave_tpu_torch`` is imported under another
name beside this tree's, so the two share one process, one CUDA context and
one card, and whatever slows the host slows both. Each variant's K1, K3, K4,
K6, K7, K8 and K9 are first held against the plain version (1e-5 of max|ref|),
and K6's fused form against the eager phase transform and the unfused K6.

The calls are the consumers of K1 (K1 alone at 64 x 65536 db4 L5 and at
``denoise``'s 8 x 65536 db4 L4, the entry step ``imodwt(modwt(x))`` and its
gradient, whose backward runs K1 as K2's adjoint, ``modwt_mra`` at 64 x
65536, ``denoise`` db4 L4 8 x 65536) and of K4 (one K4 pass and ``fwt2d`` at
2048^2 db4 L6, the gradient of ``ifwt2d`` there, whose backward runs K4 as
K5's adjoint), K3 and ``fwt`` at 64 x 65536 db4 L8, K6 at 8 x 64 x 65536 on
64 bins (uniform random indices in [0, 64], 64 dropped) and ``ssq_cwt`` at
8 x 65536 with 64 scales, K6's fused form with the peak kernel (the default
threshold) and the peak kernel alone on the W and dW of ``ssq_cwt`` at 8 x
64 x 65536 and 2 x 64 x 2^20 (a tree without them runs the same functions
by its route: the eager phase transform then K6, and ``torch.amax``), K7 (alone at 64 x 65536 db4 L1, L2, L4 and L8 and
Haar L8, and on 65536 rows of 256 at full depth; K3 and K7 in place on
65536 rows of 256 at db4 L6), ``ifwt`` db4 L8 64 x 65536, the gradient of ``fwt``
there, whose backward runs K7 as K3's adjoint, ``ifwt3d`` db4 256^3 through
the FWT facade's reverse, and ``ifwt2d_sharded`` db4 L6 2048^2 in a one-rank
NCCL world), K8 and K9 (db4 L6 64 x 65536, and the chunks of ``wpt`` at
full depth on 65536 that are whole rows: 4096 rows of 1024 at L6, 262144
of 16 at L4; a tree without them runs the same function by
its route, the conv form of ``ops.composite``) and their consumers
(``wpt`` and ``iwpt`` at L6 and full depth, the WPT facade's 2D forward
and reverse at 2048^2 and its 3D forward and reverse at 256^3 L4,
``wpt2d_sharded`` and ``iwpt2d_sharded`` L6 2048^2 in the one-rank
world), the volume's axis passes on 65536 rows of 256 at db4 L6 (the
rotated K3 and K7, or, in a tree without them, K3 and K7 in place and the
transposing copy that followed them) and their consumers (the FWT facade's
3D forward and reverse at 256^3 L6), and K2 and one K5 pass, which no
consumer here isolates. The
registers and spills of each K8/K9 build (``-Xptxas -v``) and their plans
are printed first.
``--variants`` keeps one or both trees (one alone measures
one tree in a process of its own: the inputs are made by the plain
versions, so no other kernel runs there), and ``--calls`` keeps the calls
whose name contains one of the given texts.

Each round times every call in the turns A B B A over its variants, the
first variant alternating from round to round, three ways, each the median
of ``--reps`` runs after a 128 MB write that flushes the 50 MB L2:

  device  CUDA events after a ~5 ms GPU spin, so the host's launches are
          queued before the first event: the device's time alone;
  wall    CUDA events with no spin: a host slower than the device shows;
  host    perf_counter around the call, with no sync: the time to enqueue.

Every measurement goes to ``--out`` as a JSON line; stdout gets one summary
line per call and variant (median, min and max over the rounds of the mean
of the round's two turns) and per call the ratio new/parent, with the ways
whose rounds disagree on its side of 1 listed as "unresolved" (the spread
exceeds the gap). With ``--trace``, one profiled call of each variant of
the host-bound calls kept prints its heaviest host ops and its kernels'
device time. With ``--k3-plans``, this tree's K3 at 64 x 65536 db4 L8 is
timed (device) once for each tile of 2048 to 16384 samples and each block of
128 to 512 threads, after the rounds: the sweep that ``K3_TILE`` and
``K3_TILE_THREADS`` were chosen from. With ``--k7-plans``, this tree's K7 at
64 x 65536 db4 L1, L4 and L8 and on 65536 rows of 256 is timed (device, the
median of 3) for each tile of 1024 to 8192 samples and 64, 128 and 256
compute threads, with the blocks an SM and the grid each plan gets: the
sweep that ``K7_TILE``, ``K7_TILE_ONE_LEVEL`` and ``K7_THREADS`` were chosen
from. With ``--wpt-plans``, this tree's K8 and K9 at 64 x 65536 db4 L6, on
4096 rows of 1024 at L6 and on 262144 rows of 16 at L4 (whole rows) are
timed (device, the median of 3) for tiles of 2048 to 8192 samples, 128 and
256 compute threads and grids of 3, 4 and 5 blocks an SM (where the
occupancy calculator allows them), with each plan's items a block: the
sweep that ``WPT_TILE``, ``WPT_THREADS`` and ``WPT_BLOCKS_PER_SM`` were
chosen from. With ``--rot-plans``, this tree's rotated K3 and K7 on
65536 rows of 256 at db4 L6 are timed (device, the median of 3) for items
of 2048 to 8192 floats and 64, 128 and 256 compute threads, with the blocks
an SM: the sweep that ``ROT_ITEM``, ``K3_ROT_THREADS`` and the rotated K7's
plan were chosen from. Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def _load(name: str, package_dir: Path):
    """Import the package at ``package_dir`` under the module name ``name``."""
    init = package_dir / "__init__.py"
    spec = importlib.util.spec_from_file_location(name, init,
                                                  submodule_search_locations=[str(package_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _modules(name: str):
    sub = {k: importlib.import_module(f"{name}.{k}") for k in
           ("ops.cuda_build", "ops.cuda_modwt", "ops.cuda_pyramid", "ops.cuda_reassign",
            "ops.composite", "transforms.modwt", "transforms.ssq")}
    try:
        sub["ops.cuda_wpt"] = importlib.import_module(f"{name}.ops.cuda_wpt")
    except ModuleNotFoundError:  # a tree from before K8/K9
        sub["ops.cuda_wpt"] = None
    return sys.modules[name], sub


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab_times.jsonl")
    ap.add_argument("--variants", nargs="+", default=["parent", "new"],
                    choices=["parent", "new"])
    ap.add_argument("--calls", nargs="+", default=[""])
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--k3-plans", action="store_true")
    ap.add_argument("--k7-plans", action="store_true")
    ap.add_argument("--wpt-plans", action="store_true")
    ap.add_argument("--rot-plans", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_times: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0)
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)

    sys.path.insert(0, str(ROOT))
    from jwave_tpu_torch.bench import F32_BOUND

    _load("jwave_tpu_torch_parent", args.parent.resolve() / "jwave_tpu_torch")
    new_jt, new = _modules("jwave_tpu_torch")
    par_jt, par = _modules("jwave_tpu_torch_parent")
    trees = [new, par] if "parent" in args.variants else [new]
    with ThreadPoolExecutor(8) as ex:
        for j in [ex.submit(m["ops.cuda_build"].library, k) for m in trees
                  for k in ("modwt", "pyramid", "reassign", "wpt")
                  if (m["ops.cuda_build"].CSRC / f"{k}.cu").exists()]:
            j.result()
    for label, m in zip(("new", "parent"), trees):
        cw = m["ops.cuda_wpt"]
        if cw is None:
            continue
        cb = m["ops.cuda_build"]
        if "wpt" not in cb.BUILD_LOG:  # built by an earlier process: build again for the report
            (ROOT / "build").mkdir(exist_ok=True)
            kept, cb.BUILD_DIR = cb.BUILD_DIR, Path(tempfile.mkdtemp(dir=ROOT / "build"))
            cb._LIBS.pop("wpt", None)
            cb.library("wpt")
            cb.BUILD_DIR = kept
        log = cb.BUILD_LOG["wpt"][1]
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        plans = {f"{k} 64x65536 db4 L6": cw.wpt_plan(65536, 6, 8, k == "K9")._asdict()
                 for k in ("K8", "K9")}
        print(json.dumps({"wpt_build": label, "ptxas": regs, "plans": plans}), flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def dev_t(shape, grad=False):
        t = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
        return t.requires_grad_() if grad else t

    x, x8, img = dev_t((64, 65536)), dev_t((8, 65536)), dev_t((2048, 2048))
    x256, vol = dev_t((65536, 256)), dev_t((256, 256, 256))
    x1024, x16 = x.reshape(4096, 1024), x.reshape(262144, 16)
    xg, img_g = dev_t((64, 65536), True), dev_t((2048, 2048), True)
    w, w_img = dev_t((64, 65536)), dev_t((2048, 2048))
    g0, h0 = new["transforms.modwt"]._modwt_base_filters("db4")
    fb, haar = new_jt.get_filter("db4"), new_jt.get_filter("Haar")
    lo, hi = fb.dec_lo, fb.dec_hi
    c32 = new["ops.cuda_modwt"].modwt_cascade_torch(x, g0, h0, 5)
    contrib = torch.complex(dev_t((8, 64, 65536)), dev_t((8, 64, 65536)))
    k_idx = torch.as_tensor(rng.integers(0, 65, (8, 64, 65536)), dtype=torch.int32, device=dev)
    ssq_scales = new_jt.generate_log_scales(1e-5, 1e-2, 64)
    ssq_new = new["transforms.ssq"]
    ssq_bins = ssq_new._default_bins(ssq_scales, 1.0, None)
    ssq_wgt = torch.as_tensor(ssq_scales ** -0.5 * ssq_new._log_measure(ssq_scales),
                              dtype=torch.float32, device=dev)
    ssq_blocks = {f"{r}x64x{n}": ssq_new._cwt_and_derivative(
        dev_t((r, n)), ssq_scales, new_jt.MorletWavelet(1.0, 1.0), 1e6,
        new_jt.PaddingType.SYMMETRIC) for r, n in ((8, 65536), (2, 2**20))}

    sharded = any(c in lab for c in args.calls
                  for lab in ("ifwt2d_sharded db4 L6 2048^2", "wpt2d_sharded db4 L6 2048^2",
                              "iwpt2d_sharded db4 L6 2048^2"))
    if sharded:  # a one-rank NCCL world for the sharded inverse, as chip_smoke.py forms it
        import os
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                          WORLD_SIZE="1")
        importlib.import_module("jwave_tpu_torch.parallel").initialize_distributed()

    def calls(jt, m):
        cm, cp, cr = m["ops.cuda_modwt"], m["ops.cuda_pyramid"], m["ops.cuda_reassign"]
        grad = torch.autograd.grad
        morlet = jt.MorletWavelet(1.0, 1.0)
        facade = jt.TransformBuilder.create("Fast Wavelet Transform", "db4")
        extra = {}
        if sharded:
            par_m = importlib.import_module(f"{jt.__name__}.parallel")
            mesh = par_m.make_mesh()
            img_s = par_m.fwt2d_sharded(img, "db4", mesh, 6, 6)
            extra["ifwt2d_sharded db4 L6 2048^2"] = (
                lambda: par_m.ifwt2d_sharded(img_s, "db4", mesh, 6, 6))
            extra["wpt2d_sharded db4 L6 2048^2"] = (
                lambda: par_m.wpt2d_sharded(img, "db4", mesh, 6, 6))
            img_w = par_m.wpt2d_sharded(img, "db4", mesh, 6, 6)
            extra["iwpt2d_sharded db4 L6 2048^2"] = (
                lambda: par_m.iwpt2d_sharded(img_w, "db4", mesh, 6, 6))
        ssq_m = m["transforms.ssq"]
        for label, (w_b, dw_b) in ssq_blocks.items():
            if hasattr(cr, "squeeze"):
                grid = ssq_m._bin_grid(ssq_bins, None, dev)
                extra[f"K6 fused + peak {label}"] = (
                    lambda w_b=w_b, dw_b=dw_b, grid=grid: cr.squeeze(w_b, dw_b, ssq_wgt, None,
                                                                     grid, "clip"))
                extra[f"peak {label}"] = lambda w_b=w_b: cr.row_peaks(w_b)
            else:  # the same functions by this tree's route
                def eager(w_b=w_b, dw_b=dw_b):
                    g = 10.0 * math.sqrt(torch.finfo(torch.float32).eps) * torch.sqrt(
                        (w_b.real ** 2 + w_b.imag ** 2).amax(dim=(-2, -1), keepdim=True))
                    return cr.reassign(*ssq_m._reassign_inputs(w_b, dw_b, ssq_wgt, ssq_bins, g,
                                                               "clip"), 64)

                extra[f"K6 fused + peak {label}"] = eager
                extra[f"peak {label}"] = lambda w_b=w_b: torch.amax(
                    w_b.real ** 2 + w_b.imag ** 2, dim=(-2, -1))
        cw, comp = m["ops.cuda_wpt"], m["ops.composite"]
        wpt_f = jt.TransformBuilder.create("Wavelet Packet Transform", "db4")
        for label, y, lv in (("64x65536 db4 L6", x, 6), ("4096x1024 db4 L6", x1024, 6),
                             ("262144x16 db4 L4", x16, 4)):
            if cw is not None:
                extra[f"K8 {label}"] = lambda y=y, lv=lv: cw.wpt_rows(y, lo, hi, lv)
                extra[f"K9 {label}"] = lambda y=y, lv=lv: cw.iwpt_rows(y, fb.rec_lo, fb.rec_hi, lv)
            else:  # the same functions by this tree's route: the conv form
                extra[f"K8 {label}"] = lambda y=y, lv=lv: comp.wpt_fused_forward(y, lo, hi, lv)
                extra[f"K9 {label}"] = lambda y=y, lv=lv: comp.wpt_fused_inverse(
                    y, fb.rec_lo, fb.rec_hi, lv)
        extra.update({
            "wpt db4 L6 64x65536": lambda: jt.wpt(x, "db4", 6),
            "iwpt db4 L6 64x65536": lambda: jt.iwpt(x, "db4", 6),
            "wpt db4 full depth 64x65536": lambda: jt.wpt(x, "db4"),
            "iwpt db4 full depth 64x65536": lambda: jt.iwpt(x, "db4"),
            "WPT facade 2D forward db4 2048^2": lambda: wpt_f.forward(img),
            "WPT facade 2D reverse db4 L6 2048^2": lambda: wpt_f.reverse(img, 6, 6),
            "WPT facade 3D forward db4 L4 256^3": lambda: wpt_f.forward(vol, 4, 4, 4),
            "iwpt3d db4 L4 256^3 (WPT facade 3D reverse)": lambda: wpt_f.reverse(vol, 4, 4, 4),
        })
        if hasattr(cp, "pyramid_rows_rotated"):
            extra["K3 rotated 65536x256 db4 L6"] = lambda: cp.pyramid_rows_rotated(x256, lo, hi, 6)
            extra["K7 rotated 65536x256 db4 L6"] = lambda: cp.ipyramid_rows_rotated(
                x256, fb.rec_lo, fb.rec_hi, 1.0, 6)
        else:  # the same functions by this tree's route: in place, then a transposing copy
            extra["K3 rotated 65536x256 db4 L6"] = (
                lambda: cp.pyramid_rows(x256, lo, hi, 6).t().contiguous())
            extra["K7 rotated 65536x256 db4 L6"] = lambda: cp.ipyramid_rows(
                x256, fb.rec_lo, fb.rec_hi, 1.0, 6).t().contiguous()
        extra["fwt3d db4 L6 256^3"] = lambda: facade.forward(vol, 6, 6, 6)
        extra["ifwt3d db4 L6 256^3"] = lambda: facade.reverse(vol, 6, 6, 6)
        return {
            "K3 64x65536 db4 L8": lambda: cp.pyramid_rows(x, lo, hi, 8),
            "fwt db4 L8 64x65536": lambda: jt.fwt(x, "db4", 8),
            "fwt db4 full depth 64x65536": lambda: jt.fwt(x, "db4"),
            "K6 8x64x65536 K=64": lambda: cr.reassign(contrib, k_idx, 64),
            "ssq_cwt 8x65536, 64 scales": lambda: jt.ssq_cwt(x8, ssq_scales, morlet, 1e6),
            "K2 64x65536 db4 L5": lambda: cm.imodwt_cascade(c32, g0, h0),
            "K5 one pass db4 L6 2048^2":
                lambda: cp.ipyramid_rows_transposed(img, fb.rec_lo, fb.rec_hi, 1.0, 6),
            "K1 64x65536 db4 L5": lambda: cm.modwt_cascade(x, g0, h0, 5),
            "entry step modwt+imodwt db4 L5 64x65536":
                lambda: jt.imodwt(jt.modwt(x, "Daubechies 4", 5), "Daubechies 4"),
            "entry grad db4 L5 64x65536":
                lambda: grad((jt.imodwt(jt.modwt(xg, "db4", 5), "db4") * w).sum(), xg),
            "modwt_mra db4 L5 64x65536": lambda: jt.modwt_mra(x, "db4", 5),
            "denoise db4 L4 8x65536": lambda: jt.denoise(x8, "db4", 4),
            "K1 8x65536 db4 L4": lambda: cm.modwt_cascade(x8, g0, h0, 4),
            "K4 one pass db4 L6 2048^2": lambda: cp.pyramid_rows_transposed(img, lo, hi, 6),
            "fwt2d db4 L6 2048^2": lambda: jt.fwt2d(img, "db4", 6, 6),
            "ifwt2d grad db4 L6 2048^2":
                lambda: grad((jt.ifwt2d(img_g, "db4", 6, 6) * w_img).sum(), img_g),
            "K7 64x65536 db4 L8": lambda: cp.ipyramid_rows(x, fb.rec_lo, fb.rec_hi, 1.0, 8),
            **{f"K7 64x65536 db4 L{lv}": (lambda lv=lv: cp.ipyramid_rows(x, fb.rec_lo, fb.rec_hi,
                                                                        1.0, lv))
               for lv in (1, 2, 4)},
            "K7 64x65536 Haar L8": lambda: cp.ipyramid_rows(x, haar.rec_lo, haar.rec_hi, 1.0, 8),
            "ifwt db4 L8 64x65536": lambda: jt.ifwt(x, "db4", 8),
            "fwt grad db4 L8 64x65536": lambda: grad((jt.fwt(xg, "db4", 8) * w).sum(), xg),
            "ifwt3d db4 256^3": lambda: facade.reverse(vol),
            "K7 65536x256 full depth": lambda: cp.ipyramid_rows(x256, fb.rec_lo, fb.rec_hi, 1.0, 8),
            "K3 65536x256 db4 L6": lambda: cp.pyramid_rows(x256, lo, hi, 6),
            "K7 65536x256 db4 L6": lambda: cp.ipyramid_rows(x256, fb.rec_lo, fb.rec_hi, 1.0, 6),
            **extra,
        }

    variants = {"parent": calls(par_jt, par), "new": calls(new_jt, new)}
    variants = {v: {k: f for k, f in t.items() if any(c in k for c in args.calls)}
                for v, t in variants.items() if v in args.variants}

    # each variant's K1, K3, K4, K6 and K7 against the plain version, in float64
    cm = new["ops.cuda_modwt"]
    cp = new["ops.cuda_pyramid"]
    cr = new["ops.cuda_reassign"]
    refs = {"K1 64x65536 db4 L5": cm.modwt_cascade_torch(x.double(), g0, h0, 5),
            "K3 64x65536 db4 L8": cp.pyramid_rows_torch(x.double(), lo, hi, 8),
            "K4 one pass db4 L6 2048^2": cp.pyramid_rows_transposed_torch(img.double(), lo, hi, 6),
            "K6 8x64x65536 K=64": torch.view_as_real(
                cr.reassign_torch(contrib.to(torch.complex128), k_idx, 64)),
            "K7 64x65536 db4 L8": cp.ipyramid_rows_torch(x.double(), fb.rec_lo, fb.rec_hi, 1.0, 8),
            "K7 65536x256 full depth": cp.ipyramid_rows_torch(x256.double(), fb.rec_lo,
                                                              fb.rec_hi, 1.0, 8),
            "K3 65536x256 db4 L6": cp.pyramid_rows_torch(x256.double(), lo, hi, 6),
            "K7 65536x256 db4 L6": cp.ipyramid_rows_torch(x256.double(), fb.rec_lo, fb.rec_hi,
                                                          1.0, 6),
            "K3 rotated 65536x256 db4 L6": cp.pyramid_rows_transposed_torch(x256.double(), lo,
                                                                            hi, 6),
            "K7 rotated 65536x256 db4 L6": cp.ipyramid_rows_transposed_torch(
                x256.double(), fb.rec_lo, fb.rec_hi, 1.0, 6),
            "K8 64x65536 db4 L6": new["ops.cuda_wpt"].wpt_analysis_torch(x.double(), lo, hi, 6),
            "K9 64x65536 db4 L6": new["ops.cuda_wpt"].wpt_synthesis_torch(x.double(), fb.rec_lo,
                                                                         fb.rec_hi, 6)}
    for label, (w_b, dw_b) in ssq_blocks.items():  # the eager phase transform, K6 in float64
        c_b, k_b = ssq_new._reassign_inputs(w_b, dw_b, ssq_wgt, ssq_bins,
                                            ssq_new._default_gamma(w_b), "clip")
        refs[f"K6 fused + peak {label}"] = torch.view_as_real(
            cr.reassign_torch(c_b.to(torch.complex128), k_b, 64))
        del c_b, k_b
    for v, table in variants.items():
        for key, ref in refs.items():
            if key not in table:
                continue
            got = table[key]()
            got = torch.view_as_real(got) if got.is_complex() else got
            torch.cuda.synchronize()
            rel = float((got.double() - ref).abs().max() / ref.abs().max())
            print(json.dumps({"check": f"{v}: {key} against its plain version", "rel": rel,
                              "bound": F32_BOUND}), flush=True)
            if not rel <= F32_BOUND:
                print(f"ab_times: {v} {key} disagrees with its plain version", file=sys.stderr)
                return 1
    del refs

    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)

    def measure(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        dev_ms, wall_ms, host_ms = [], [], []
        for spin in (True, False):
            for _ in range(args.reps):
                flush.fill_(1.0)
                if spin:
                    torch.cuda._sleep(10_000_000)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                b.record()
                b.synchronize()
                (dev_ms if spin else wall_ms).append(a.elapsed_time(b))
                if not spin:
                    host_ms.append((t1 - t0) * 1e3)
        return {"device": float(np.median(dev_ms)), "wall": float(np.median(wall_ms)),
                "host": float(np.median(host_ms))}

    names = list(variants)
    calls_kept = list(next(iter(variants.values())))
    ways = ("device", "wall", "host")
    rounds: dict = {}  # (call, variant) -> list of per-round means
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w") as log:
        log.write(json.dumps({"card": card}) + "\n")
        for r in range(args.rounds):
            seq = names[r % len(names):] + names[:r % len(names)]
            for key in calls_kept:
                got: dict = {}
                for v in seq + seq[::-1]:
                    t = measure(variants[v][key])
                    got.setdefault(v, []).append(t)
                    log.write(json.dumps({"round": r, "call": key, "variant": v, **t}) + "\n")
                for v, ts in got.items():
                    rounds.setdefault((key, v), []).append(
                        {w_: (ts[0][w_] + ts[1][w_]) / 2 for w_ in ways})
            log.flush()
            print(json.dumps({"round": r, "done": True}), flush=True)

    for key in calls_kept:
        for v in names:
            rs = rounds.get((key, v))
            if not rs:
                continue
            print(json.dumps({"call": key, "variant": v, "card": card, **{
                w_: {"median": float(np.median([x_[w_] for x_ in rs])),
                     "min": min(x_[w_] for x_ in rs), "max": max(x_[w_] for x_ in rs)}
                for w_ in ways}}), flush=True)
        if (key, "new") in rounds and (key, "parent") in rounds:
            ratios = {w_: [x_[w_] / y_[w_]
                           for x_, y_ in zip(rounds[(key, "new")], rounds[(key, "parent")])]
                      for w_ in ways}
            print(json.dumps({"call": key, "ratio": "new/parent", **{
                w_: {"median": float(np.median(v_)), "min": min(v_), "max": max(v_)}
                for w_, v_ in ratios.items()},
                "unresolved": [w_ for w_, v_ in ratios.items() if min(v_) < 1 < max(v_)]}),
                flush=True)

    if args.k3_plans:
        for tile in (2048, 4096, 8192, 16384):
            plan = cp.k3_plan(65536, 8, len(lo), tile=tile)
            for threads in (128, 192, 256, 384, 512):
                cp.K3_TILE_THREADS, kept = threads, cp.K3_TILE_THREADS
                ms = measure(lambda: cp._k3(x, lo, hi, 8, plan=plan))["device"]
                cp.K3_TILE_THREADS = kept
                print(json.dumps({"k3_plan": plan._asdict(), "threads": threads,
                                  "device_ms": ms, "card": card}), flush=True)

    if args.k7_plans:
        for label, y, lv in (("64x65536 db4 L1", x, 1), ("64x65536 db4 L4", x, 4),
                             ("64x65536 db4 L8", x, 8), ("65536x256 db4 L8", x256, 8)):
            for tile in (1024, 2048, 4096, 8192):
                for consumers in (64, 128, 256):
                    plan = cp.k7_plan(y.shape[1], lv, len(fb.rec_lo), tile, consumers + 32)
                    if plan.smem_bytes > cp.SMEM_LIMIT:
                        continue
                    ms = float(np.median([measure(lambda: cp._k7(y, fb.rec_lo, fb.rec_hi, 1.0, lv,
                                                                 plan))["device"]
                                          for _ in range(3)]))
                    print(json.dumps({"k7_plan": label, "tile": tile, "threads": plan.threads,
                                      "smem_bytes": plan.smem_bytes,
                                      "blocks_per_sm": cp.k7_blocks_per_sm(
                                          torch.cuda.current_device(), y.shape[1], lv,
                                          len(fb.rec_lo), plan),
                                      "grid": cp.k7_grid(dev, y.shape[0], y.shape[1], lv,
                                                         len(fb.rec_lo), plan),
                                      "device_ms": ms, "card": card}), flush=True)

    if args.rot_plans:
        bound_ms = 2 * 4 * x256.numel() / 3.35e12 * 1e3
        for item in (2048, 4096, 8192):
            for consumers in (64, 128, 256):
                plan = cp.k3_rotated_plan(256, item, consumers + 32)
                ms = float(np.median([measure(lambda: cp._k3_rotated(x256, lo, hi, 6,
                                                                     plan))["device"]
                                      for _ in range(3)]))
                print(json.dumps({"rot_plan": "K3 65536x256 db4 L6", **plan._asdict(),
                                  "blocks_per_sm": cp.k3_rotated_blocks_per_sm(
                                      torch.cuda.current_device(), 256, 6, 8, plan),
                                  "device_ms": ms, "bound_ms": bound_ms, "card": card}),
                      flush=True)
                plan = cp.k7_plan(256, 6, 8, item, consumers + 32, rotated=True)
                ms = float(np.median([measure(lambda: cp._k7_rotated(
                    x256, fb.rec_lo, fb.rec_hi, 1.0, 6, plan))["device"] for _ in range(3)]))
                print(json.dumps({"rot_plan": "K7 65536x256 db4 L6", "tile": plan.tile,
                                  "rows": plan.rows, "threads": plan.threads,
                                  "smem_bytes": plan.smem_bytes,
                                  "blocks_per_sm": cp.k7_blocks_per_sm(
                                      torch.cuda.current_device(), 256, 6, 8, plan, True),
                                  "device_ms": ms, "bound_ms": bound_ms, "card": card}),
                      flush=True)

    if args.wpt_plans:
        cw = new["ops.cuda_wpt"]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for label, y, lv in (("64x65536 db4 L6", x, 6), ("4096x1024 db4 L6", x1024, 6),
                             ("262144x16 db4 L4", x16, 4)):
            for tile in (2048, 4096, 8192):
                for consumers in (128, 256):
                    for key, fn in (("K8", cw._k8), ("K9", cw._k9)):
                        inverse = key == "K9"
                        plan = cw.wpt_plan(y.shape[1], lv, 8, inverse, tile, consumers + 32)
                        if plan.smem_bytes > cw.SMEM_LIMIT:
                            continue
                        fits = cw.wpt_blocks_per_sm(torch.cuda.current_device(), y.shape[1], lv,
                                                    8, inverse, plan)
                        items = cw.wpt_items(y.shape[0], y.shape[1], plan)
                        for per_sm in (3, 4, 5):
                            if per_sm > fits:
                                continue
                            grid = min(items, sms * per_sm)
                            ms = float(np.median([measure(
                                lambda: fn(y, lo, hi, lv, 1.0, False, plan, grid))["device"]
                                for _ in range(3)]))
                            print(json.dumps({"wpt_plan": f"{key} {label}", **plan._asdict(),
                                              "blocks_per_sm": per_sm, "fits_per_sm": fits,
                                              "grid": grid, "items": items,
                                              "items_per_block": items / grid,
                                              "device_ms": ms, "card": card}), flush=True)

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        for key in ("denoise db4 L4 8x65536", "ifwt2d grad db4 L6 2048^2",
                    "entry grad db4 L5 64x65536"):
            for v in ("parent", "new"):
                if v not in variants or key not in variants[v]:
                    continue
                fn = variants[v][key]
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                avg = prof.key_averages()
                ev = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:10]
                kern = sorted((e for e in avg if e.self_device_time_total > 0),
                              key=lambda e: -e.self_device_time_total)[:10]
                print(json.dumps({"trace": key, "variant": v, "host_ops_self_us": [
                    [e.key[:60], e.count, round(e.self_cpu_time_total, 1)] for e in ev],
                    "kernels_device_us": [[e.key[:60], e.count, round(e.self_device_time_total, 1)]
                                          for e in kern]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
