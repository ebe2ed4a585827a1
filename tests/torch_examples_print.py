"""Helpers of tests/test_torch_examples*.py (not a test module): run an
example of the port and its JAX twin in examples/*.py and compare what they
print.

Two printed numbers agree when they differ by at most one unit of their
last printed digit (values that agree to ~1e-9 can round apart by no more),
or when both lie below the example's roundoff floor (1e-8 in float64, 1e-4
for the float32 image pipeline), where two libraries' roundoff is all they
show. The words between the numbers must be the same.
"""
import contextlib
import importlib
import io
import re
import runpy
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _unit(tok: str) -> float:
    """One unit of the last printed digit of a printed number."""
    mant, _, exp = tok.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - decimals)


def assert_same_print(got: str, want: str, floor: float):
    g, w = NUMBER.findall(got), NUMBER.findall(want)
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want), f"the text differs:\n{got}\n---\n{want}"
    assert len(g) == len(w)
    for a, b in zip(g, w):
        va, vb = float(a), float(b)
        if abs(va) < floor and abs(vb) < floor:
            continue
        assert abs(va - vb) <= 1.0001 * max(_unit(a), _unit(b)), \
            f"printed {a} against JAX's {b}\n{got}\n---\n{want}"


def captured(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def jax_twin(name: str, entries) -> str:
    """What examples/<name>.py prints: its module-level code, then each of
    ``entries``."""
    def run():
        glb = runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="jax_example")
        for entry in entries:
            glb[entry]()
    return captured(run)


def port_print(name: str, entries) -> str:
    """What jwave_tpu_torch.examples.<name> prints on the CPU: each of
    ``entries`` (``main`` where JAX's code is at module level)."""
    module = importlib.import_module(f"jwave_tpu_torch.examples.{name}")
    return captured(lambda: [getattr(module, e)(device="cpu") for e in (entries or ("main",))])


def check_example(name: str, entries, floor: float):
    assert_same_print(port_print(name, entries), jax_twin(name, entries), floor)
