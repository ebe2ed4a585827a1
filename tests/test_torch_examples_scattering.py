"""jwave_tpu_torch.examples against the JAX package's examples/*.py: the
two examples whose JAX twins run scattering (tests/test_torch_examples.py
has the others and says how the printed numbers are compared)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_examples_print import check_example  # noqa: E402


@pytest.mark.parametrize("name", ["adaptive_example", "scattering_classify_example"])
def test_example_prints_what_its_jax_twin_prints(name):
    check_example(name, ("main",), 1e-8)
