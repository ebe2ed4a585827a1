"""Hold JAX's side of the parity census traced against JAX's side eager.

    JAX_PLATFORMS=cpu python tools/census_traced_vs_eager.py [FILE ...]

The census (tests/torch_census_cases.py) runs JAX's costly calls through
``i.jit``, that is ``jax.jit``, because eagerly JAX compiles one program for
each operation and shape. This script runs each case's JAX side both ways,
``i.jit`` as ``jax.jit`` and as the identity, and compares the two
observations by the census's own rules: the same raise or return, structure,
leaf kinds, dtypes and shapes, discrete outputs exactly, values within
1e-12 of max(max|eager|, 1) in float64 (1e-6 in float32, 1e-2 in bf16: the
traced program may round in another order). FILE names census files
(``facade_1``, ``card_2``, ...); without one, all of them. Prints each case
that differs and one summary line; exits 1 if any differs. CPU only, a few
minutes a family (the eager side is the slow one).
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE), "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jwave_tpu as jw  # noqa: E402
import torch_census_cases as census  # noqa: E402

TOL = {"float64": 1e-12, "float32": 1e-6, "bfloat16": 1e-2}


def main(files: list[str]) -> int:
    files = files or sorted({c.file for c in census.CASES})
    n, differ = 0, 0
    for c in census.CASES:
        if c.file not in files:
            continue
        call = c.jax or c.port
        traced = census.observe(call, jw, census.Inputs(jax=True, dtype=c.dtype, jit=jax.jit))
        eager = census.observe(call, jw, census.Inputs(jax=True, dtype=c.dtype))
        bad = census.compare(traced, eager, TOL[c.dtype], c.exact)
        n += 1
        if bad:
            differ += 1
            print(f"{c.name}: {bad[:3]}", flush=True)
    print(f"census files {files}: {n} cases, {differ} differ traced against eager", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
