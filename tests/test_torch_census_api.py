"""The parity census: the utilities, the public signatures, and the guard
that keeps the census complete.

- The cases of tests/torch_census_cases.py with ``file="api"`` (all 67
  filter banks field by field, the lifting schemes, the scale generators,
  thresholds, the interleaved converters, ``fwt_max_level``, the result
  types, the exception classes, the wavelet classes) through both packages,
  as the other census files run theirs (``torch_census_cases.make_test``).
- The signature census: every public callable of ``jwave_tpu.__all__`` and
  ``jwave_tpu.parallel.__all__`` has the port's parameter names, order,
  kinds and defaults, and every public class the same public methods with
  the same parameters, but for the excepted names below.
- The coverage guard: every public name is called by a census case (read
  from the cases' bytecode: an attribute ``m.<name>`` of the package
  argument, or a name of ``torch_census_cases.BY_NAME``, the tuples the
  cases pass to ``getattr(m, name)``), or by a case of
  tests/torch_parallel_cases.py for the sharded names; a name that JAX
  gains later fails here until a case calls it.
- The card-only cases (chip_smoke.py's phase 7 runs them on the card) are
  held against JAX in float64 by tests/test_torch_census_card_<k>.py; here
  they also hold on the CPU's plain versions in float32, to the card's
  bounds, as the card phase compares them.
- Every case runs in one census file; the deviation list names only cases
  that exist.
"""
import dis
import enum
import glob
import inspect
import os
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jwave_tpu as jw  # noqa: E402
from jwave_tpu import parallel as jp  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch import parallel as tp  # noqa: E402

import torch_census_cases as census  # noqa: E402
import torch_parallel_cases  # noqa: E402

test_census = census.make_test("api", jt, jw, jax.jit)

CARD = [c for c in census.CASES if c.file.startswith("card")]


@pytest.mark.parametrize("c", CARD, ids=lambda c: c.name)
def test_card_cases_on_the_cpu(c):
    """The card phase's comparison (chip_smoke.py) on the CPU's plain
    versions in float32: the card-only cases are sound before they reach
    the card."""
    assert census.run_on_card(c, jt, "float32", device="cpu") == ([], [])


# --------------------------------------------------------------------------
# the signature census
# --------------------------------------------------------------------------

#: parameters only the port has, each with its default: where non-tensor
#: input goes (the card by default), on the facade's constructors and
#: ``TransformBuilder.create``; the device type of ``parallel.make_mesh``
#: (the card's by default), which JAX takes from its backend
PORT_ONLY_PARAMETERS = {"device": None, "device_type": None}
#: JAX-only methods, each with what the port has in its place
JAX_ONLY_METHODS = {
    "tree_flatten": "none needed: the port's results are plain dataclasses (dataclasses.fields)",
    "tree_unflatten": "none needed: the dataclass's own constructor",
    "to_jax": "to_torch",
}
#: port-only methods, each with the JAX name it stands beside
PORT_ONLY_METHODS = {
    "to_torch": "to_jax",
    "from_numpy": "a JAX result carried across as numpy (the device is the port's own)",
}

PUBLIC = [(jw, jt, n) for n in jw.__all__] + [(jp, tp, n) for n in jp.__all__]


def _params(fn) -> list:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return []
    return [(p.name, p.kind, _default(p.default)) for p in sig.parameters.values()
            if not (p.name in PORT_ONLY_PARAMETERS and p.default is PORT_ONLY_PARAMETERS[p.name])]


def _default(d):
    """An enum default as its class name and value: each package has its own
    enum classes."""
    return (type(d).__name__, d.value) if isinstance(d, enum.Enum) else d


def _methods(cls) -> set:
    return {k for k in dir(cls) if not k.startswith("_") and callable(getattr(cls, k))}


@pytest.mark.parametrize("mods, name", [((a, b), n) for a, b, n in PUBLIC],
                         ids=[f"{a.__name__}.{n}" for a, _, n in PUBLIC])
def test_signature(mods, name):
    ref, port = (getattr(m, name) for m in mods)
    if inspect.ismodule(ref):
        assert inspect.ismodule(port)
        return
    assert callable(port) == callable(ref)
    assert _params(port) == _params(ref), f"{name}: parameters differ"
    if inspect.isclass(ref):
        assert _methods(ref) - set(JAX_ONLY_METHODS) == _methods(port) - set(PORT_ONLY_METHODS)
        for meth in _methods(ref) - set(JAX_ONLY_METHODS):
            assert _params(getattr(port, meth)) == _params(getattr(ref, meth)), f"{name}.{meth}"


def test_excepted_methods_exist_where_they_are_named():
    """Each excepted method is a method of some public class: a rename on
    either side shows here, not as a silent gap."""
    jax_methods = set().union(*(_methods(getattr(jw, n)) for n in jw.__all__
                                if inspect.isclass(getattr(jw, n))))
    port_methods = set().union(*(_methods(getattr(jt, n)) for n in jw.__all__
                                 if inspect.isclass(getattr(jt, n))))
    assert set(JAX_ONLY_METHODS) <= jax_methods - port_methods
    assert set(PORT_ONLY_METHODS) <= port_methods - jax_methods


# --------------------------------------------------------------------------
# the coverage guard
# --------------------------------------------------------------------------

def _attributes(fn, var: str, module) -> set:
    """The attributes read off the variable ``var`` (``var.<name>``) in
    ``fn``'s code, its nested code and the module-level functions of
    ``module`` that it loads."""
    seen, names = set(), set()

    def walk(code):
        if code in seen:
            return
        seen.add(code)
        ins = list(dis.get_instructions(code))
        for a, b in zip(ins, ins[1:]):
            if (a.opname.startswith(("LOAD_FAST", "LOAD_DEREF")) and a.argval == var
                    and b.opname in ("LOAD_ATTR", "LOAD_METHOD")):
                names.add(b.argval)
            if a.opname == "LOAD_GLOBAL" and isinstance(getattr(module, a.argval, None),
                                                        types.FunctionType):
                walk(getattr(module, a.argval).__code__)
        for const in code.co_consts:
            if isinstance(const, types.CodeType):
                walk(const)

    walk(fn.__code__)
    return names


def test_every_public_name_has_a_census_case():
    called = set(census.BY_NAME)
    for c in census.CASES:
        for fn in (c.port, c.jax):
            if fn is not None:
                called |= _attributes(fn, "m", census)
    missing = sorted(set(jw.__all__) - called)
    assert not missing, f"public names no census case calls: {missing}"
    sharded = set()
    for c in torch_parallel_cases.CASES:
        sharded |= _attributes(c.port, "P", torch_parallel_cases)
    missing = sorted(set(jp.__all__) - sharded - {"make_mesh", "initialize_distributed"})
    assert not missing, f"sharded names no case of tests/torch_parallel_cases.py calls: {missing}"


def test_by_name_lists_public_names_only():
    """``BY_NAME`` counts for the guard only where it names public names."""
    assert set(census.BY_NAME) <= set(jw.__all__)


def test_the_mesh_names_are_called_by_every_rank():
    """make_mesh and initialize_distributed build the worlds that every
    sharded case runs in (tests/torch_parallel_child.py)."""
    src = (census.__file__.rsplit("/", 1)[0] + "/torch_parallel_child.py")
    text = open(src).read()
    assert "P.initialize_distributed(" in text and "P.make_mesh(" in text


def test_every_case_runs_in_one_census_file():
    """Each case's ``file`` is a census file, tests/test_torch_census_<file>.py,
    that runs ``make_test(<file>)``, and each census file runs some case."""
    here = os.path.dirname(census.__file__)
    on_disk = {os.path.basename(p)[len("test_torch_census_"):-len(".py")]
               for p in glob.glob(f"{here}/test_torch_census_*.py")}
    assert {c.file for c in census.CASES} == on_disk
    for f in on_disk:
        with open(f"{here}/test_torch_census_{f}.py") as src:
            assert f'census.make_test("{f}", jt, jw, jax.jit)' in src.read(), f


def test_deviations_name_census_cases():
    names = {c.name for c in census.CASES}
    for entry in census.DEVIATIONS.values():
        assert entry["reason"] and entry["source"].startswith("ROADMAP.md")
        assert set(entry["cases"]) <= names
        for differs in entry["cases"].values():
            assert differs
