"""Incremental sliding-window MODWT analysis (the JAX package's
``examples/sliding_window_example.py``).

The window advances incrementally: each new chunk costs O(S*M*J) work
whatever the window length, and the state's coefficient matrix is always
the current window's causal MODWT. Scenario: the per-band energy of a tone
whose frequency jumps mid-stream migrates between detail levels as the
jump slides through the window.
"""
import numpy as np
import torch

import jwave_tpu_torch as jt
from ._common import host, run

FS = 1024.0
WINDOW = 512
LEVEL = 6
STEP = 64


def main(device=None):
    dev = torch.device(device or "cuda")
    # 4 seconds: 40 Hz for the first half, 160 Hz for the second
    n = int(4 * FS)
    t = np.arange(n) / FS
    sig = np.where(t < 2.0, np.sin(2 * np.pi * 40.0 * t),
                   np.sin(2 * np.pi * 160.0 * t))
    sig += 0.1 * np.random.default_rng(0).standard_normal(n)
    sig_t = torch.as_tensor(sig, device=dev)

    sl = jt.SlidingMODWT("db4", LEVEL, WINDOW)
    state = sl.init(sig_t[:WINDOW])

    # level j covers ~[FS/2^(j+1), FS/2^j]: 40 Hz -> level 4, 160 Hz -> level 2
    print(f"{'t (s)':>6} | " + " | ".join(f"W{j:<2}" for j in range(1, LEVEL + 1)))
    for pos in range(WINDOW, n, STEP):
        state = sl.update(state, sig_t[pos: pos + STEP])
        if (pos // STEP) % 8 == 0:
            # energy of each detail band over the current window
            e = np.mean(host(state.coeffs[:LEVEL]) ** 2, axis=-1)
            bars = " | ".join(f"{v:4.2f}" for v in e)
            print(f"{pos / FS:6.2f} | {bars}")

    # the final window is pure 160 Hz: its energy lives at level 2
    e = np.mean(host(state.coeffs[:LEVEL]) ** 2, axis=-1)
    if e.argmax() != 1:
        raise SystemExit(f"W2 does not dominate the final window: {e}")
    print("\nfinal window dominated by W2 (160 Hz band) — as expected")


if __name__ == "__main__":
    run(main)
