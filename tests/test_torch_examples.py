"""jwave_tpu_torch.examples against the JAX package's examples/*.py.

Each ported example's ``main(device="cpu")`` (and ``cwt_example``'s
``inverse_demo``) runs on the same seeds as its JAX twin in this process,
both in float64 (conftest turns on JAX's x64) except where the example
itself asks for float32 (``image_pipeline_example``), and the numbers each
prints are compared in order (tests/torch_examples_print.py says how
closely). ``sharded_example`` runs in a 4-rank gloo world started by
``torchrun``, against the JAX twin on 4 of conftest's virtual devices. The
two examples whose JAX twins run scattering on the CPU (tens of seconds
each) are in tests/test_torch_examples_scattering.py, so that another
worker can take them.
"""
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from torch_examples_print import ROOT, assert_same_print, check_example, jax_twin  # noqa: E402

EXAMPLES = {  # name: (entry points, roundoff floor)
    "continuous_wavelets_example": (("main",), 1e-8),
    "cwt_example": (("main", "inverse_demo"), 1e-8),
    "denoise_example": (("main",), 1e-8),
    "image_pipeline_example": ((), 1e-4),  # module-level code in JAX; main() in the port
    "lifting_compression_example": (("main",), 1e-8),
    "modwt_example": (("main",), 1e-8),
    "sliding_window_example": (("main",), 1e-8),
    "timefreq_example": (("main",), 1e-8),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_prints_what_its_jax_twin_prints(name):
    check_example(name, *EXAMPLES[name])


def test_sharded_example_in_a_four_rank_world(monkeypatch):
    """``torchrun --standalone --nproc-per-node 4 -m
    jwave_tpu_torch.examples.sharded_example --device cpu`` against the JAX
    twin on a 4-device mesh; the halo FWT is bit-exact in both."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
           "-m", "jwave_tpu_torch.examples.sharded_example", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("the 4-rank world ran past 180 s and was killed")
    assert proc.returncode == 0, err[-3000:]
    assert "bit-exact vs single device: True" in out

    devices = jax.devices()[:4]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    assert_same_print(out, jax_twin("sharded_example", ("main",)), 1e-8)
