"""Sharding tour (the JAX package's ``examples/sharded_example.py``): the
five patterns of :mod:`jwave_tpu_torch.parallel` on every rank of the
process group, one device each. Rank 0 prints. On the CPU:

    torchrun --nproc-per-node 4 -m jwave_tpu_torch.examples.sharded_example --device cpu

With no process group (``python -m ...``) it runs in a one-rank world.
"""
import numpy as np
import torch
import torch.distributed as dist

import jwave_tpu_torch as jt
from jwave_tpu_torch.parallel import (
    batch_sharded,
    cwt_batch_scale_sharded,
    cwt_scale_sharded,
    cwt_time_sharded,
    fwt2d_sharded,
    fwt_halo_sharded,
    gather_pyramid,
    imodwt_fft_sharded,
    initialize_distributed,
    make_mesh,
    modwt_fft_sharded,
    modwt_halo_sharded,
    ssq_scale_sharded,
)
from ._common import host, run


def main(device=None):
    device_type = torch.device(device or "cuda").type
    initialize_distributed()
    mesh = make_mesh(device_type=device_type)
    n_dev = mesh.size()
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    rng = np.random.default_rng(0)
    say(f"{n_dev} devices: {device_type}")

    # 1. data parallel: a batch of signals, zero communication
    xs = rng.standard_normal((4 * n_dev, 512))
    wpt_dp = batch_sharded(lambda b: jt.wpt(b, "db4", 4), mesh)
    say("batch-sharded WPT:", tuple(wpt_dp(xs).shape))

    # 2. CWT scales across ranks (shared signal FFT, no collectives)
    sig = rng.standard_normal(2048)
    res = cwt_scale_sharded(sig, jt.generate_log_scales(0.5, 64.0, 4 * n_dev), "morlet", mesh)
    say("scale-sharded CWT:", tuple(res.coefficients.shape))

    # 2b. synchrosqueezing: each rank squeezes its scales, one psum of planes
    fs = 1000.0
    tone = np.cos(2 * np.pi * 50.0 * np.arange(2048) / fs)
    sres = ssq_scale_sharded(
        tone, jt.generate_log_scales(0.002, 0.2, 4 * n_dev), "morlet", mesh, fs
    )
    say("scale-sharded SSQ-CWT:", tuple(sres.Tx.shape))

    # 3. 2D FWT: rows local -> all_to_all transpose -> columns local
    img = rng.standard_normal((8 * n_dev, 8 * n_dev))
    y2 = fwt2d_sharded(img, "Haar", mesh)
    say("all_to_all 2D FWT:", tuple(y2.shape))

    # 4. long signal, time axis sharded, ring-shift halo exchange
    x = rng.standard_normal(256 * n_dev)
    c = modwt_halo_sharded(x, "db4", 3, mesh)
    say("halo-sharded MODWT:", tuple(c.shape))
    y = fwt_halo_sharded(x, "db4", mesh, 3)
    single = host(jt.fwt(torch.as_tensor(x, device=y.to_local().device), "db4", 3))
    exact = np.array_equal(gather_pyramid(y, "db4", 3, n_dev), single)
    say("halo-sharded FWT bit-exact vs single device:", exact)

    # 5. 2D mesh: batch x scales
    if n_dev % 2 == 0:
        mesh2d = make_mesh((n_dev // 2, 2), ("batch", "scale"), device_type=device_type)
        sigs = rng.standard_normal((n_dev, 256))
        r = cwt_batch_scale_sharded(sigs, jt.generate_linear_scales(1.0, 8.0, 4), "morlet",
                                    mesh2d)
        say("batch x scale CWT:", tuple(r.coefficients.shape))

    # 6. distributed four-step FFT: the MODWT at depths the halo scheme
    #    cannot reach, and a CWT whose signal is never replicated: each rank
    #    only ever holds N/D samples
    n_sig = 256 * n_dev
    if n_sig % (n_dev * n_dev) == 0 and n_sig.bit_length() - 1 >= 9:
        xl = rng.standard_normal(n_sig)
        cd = modwt_fft_sharded(xl, "db8", 9, mesh)  # level-9 support >> N/D
        err = float(np.abs(host(imodwt_fft_sharded(cd, "db8", mesh)) - xl).max())
        say(f"distributed-FFT MODWT level 9: {tuple(cd.shape)}, recon err {err:.2e}")
        if n_sig & (n_sig - 1) == 0:
            rt = cwt_time_sharded(xl, jt.generate_log_scales(1.0, 32.0, 8), "morlet", mesh)
            say("time-sharded CWT:", tuple(rt.coefficients.shape))


if __name__ == "__main__":
    run(main)
