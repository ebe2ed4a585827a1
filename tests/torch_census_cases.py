"""The parity census of jwave_tpu_torch (not a test module).

A case calls public names of one package on inputs made with numpy from a
fixed seed: ``port(m, i)`` with ``m`` the port, ``jax(m, i)`` with ``m`` the
JAX package (the port's call when the two read alike). The packages are
passed in, so this module imports neither JAX nor ``jwave_tpu`` and
``chip_smoke.py`` runs the port's side of every case on the card.

``i`` is an :class:`Inputs`: ``i.x(*shape)`` is a standard normal array of
that shape (its seed made from the shape), as numpy for JAX and as a tensor
on the side's device and in its dtype for the port; ``i.put(a)`` carries any
numpy array across the same way and ``i.kw`` holds ``device=`` for the port's
constructors. ``i.jit(fn)`` is ``jax.jit(fn)`` on JAX's side and ``fn`` on
the port's: JAX run eagerly compiles a program for each operation and
shape, where one traced call compiles one, so the costly calls that trace
(their outputs arrays, their checks static) go through it
(tools/census_traced_vs_eager.py holds the two ways equal).

:func:`observe` runs one side and flattens what it returns into leaves keyed
by their path (dataclass fields, tuple and list positions, dict keys), or
records the exception's class. :func:`compare` holds two observations to
the census's rules, in order: raise or return; structure; shapes; dtypes;
discrete outputs (integer and bool leaves, and the paths a case names in
``exact``) exactly; the rest within ``tol * max(max|ref|, 1)``.

Where JAX and the port are known to part, :data:`DEVIATIONS` says so; a
disagreement that is not there fails.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Callable

import numpy as np

#: float64 against float64: roundoff only
TOL = 1e-8
#: paths through a median, a threshold or an iteration (ADMM, pursuit)
TOL_DECIDE = 1e-6
#: a float32-input case: both packages compute in float32 in another order
TOL_F32 = 1e-5
#: the card: float32 against float64 (PERF.md section 2); through a median,
#: a threshold or an iteration; half-precision storage, one rounding of
#: 2^-9 a stored value (bf16)
CARD_TOL, CARD_TOL_DECIDE, CARD_TOL_HALF = 1e-5, 1e-4, 1e-2
#: half precision through a chain of stored levels: the plain butterflies
#: store every level, so a value of a 2D round trip is rounded up to 24
#: times (2 x 6 levels each way), 24 * 2^-9 = 4.7e-2
CARD_TOL_HALF_LEVELS = 5e-2


@dataclass
class Case:
    name: str
    file: str  # runs in tests/test_torch_census_<file>.py; "card_<k>": the kernels' edges
    port: Callable  # (jwave_tpu_torch, Inputs) -> result
    jax: Callable | None = None  # (jwave_tpu, Inputs) -> result; None: the port's call
    tol: float = TOL
    exact: tuple = ()  # float leaves (path prefixes) that are discrete decisions
    dtype: str = "float64"  # the inputs' dtype on the CPU
    card: bool = True  # also in chip_smoke.py's census phase
    card_dtypes: tuple = ("float32",)  # the inputs' dtypes on the card
    kernel: str | None = None  # the kernel a card-only case must launch in float32
    near_tie: tuple = ()  # on the card: leaves whose difference is a recorded near-tie
    half_tol: float = CARD_TOL_HALF  # on the card, in bf16 and f16


CASES: list[Case] = []


def case(**kw):
    c = Case(**kw)
    CASES.append(c)
    return c


class Inputs:
    """The inputs of one side of a case (see the module docstring)."""

    def __init__(self, jax: bool, device: str = "cpu", dtype: str = "float64", jit=None):
        self.jax, self.device, self.dtype = jax, device, dtype
        self.kw = {} if jax else {"device": device}
        self.jit = jit or (lambda fn: fn)

    def x(self, *shape, seed: int = 0):
        return self.put(np.random.default_rng([seed, *shape]).standard_normal(shape))

    def z(self, *shape, seed: int = 0):
        r = np.random.default_rng([seed + 1, *shape])
        return self.put(r.standard_normal(shape) + 1j * r.standard_normal(shape))

    def put(self, a):
        a = np.asarray(a)
        if self.jax:
            if a.dtype.kind == "f":
                return a.astype(_np_dtype(self.dtype))
            if a.dtype.kind == "c":
                return a.astype(np.complex128 if self.dtype == "float64" else np.complex64)
            return a
        import torch

        t = torch.as_tensor(a, device=self.device)
        if t.is_floating_point():
            return t.to(getattr(torch, self.dtype))
        if t.is_complex():
            return t.to(torch.complex128 if self.dtype == "float64" else torch.complex64)
        return t


def _np_dtype(name: str):
    if name == "bfloat16":
        import ml_dtypes

        return ml_dtypes.bfloat16
    return np.dtype(name)


#: Where the two packages are known to part: each entry's reason, the
#: ROADMAP.md line it comes from, and for each case that shows it what
#: :func:`compare` says there (an entry with no case cannot be reached at
#: the census's sizes). Grows only where the reference is at fault.
DEVIATIONS: dict = {
    "odd-length interleaved DFT": {
        "reason": "an interleaved real input of odd length has no (re, im) pairing; neither "
                  "package checks the length, so each raises its array library's reshape "
                  "error: numpy's TypeError in JAX, torch's RuntimeError in the port",
        "source": "ROADMAP.md, Queue 3, 'Deviations the census allows', the first item",
        "cases": {f"facade {name} | {shape}": [f"['fwd {lv}']: raise RuntimeError != TypeError"
                                               for lv in (0, 1, 2, 3, None)]
                  for name in ("Discrete Fourier Transform", "Fast Fourier Transform")
                  for shape in ("45", "3x64")},
    },
    "_Sparse.get before alloc": {
        "reason": "JAX reads self._data.get before its allocation check and raises "
                  "AttributeError; the port raises JWaveNotAllocated, as the dense containers "
                  "do in both packages",
        "source": "ROADMAP.md, Queue 3, 'Found in the reference', datatypes._Sparse.get",
        "cases": {"containers": [f"['{c} unallocated']: raise JWaveNotAllocated != AttributeError"
                                 for c in ("BlockHash", "LineHash", "SpaceHash")]},
    },
    "1D dtcwt on bf16": {
        "reason": "JAX's 1D dtcwt on bf16 input raises a TypeError from lax.complex; the port "
                  "gives complex64 highpasses, as both packages do in 2D",
        "source": "ROADMAP.md, Queue 3, 'Found in the reference', 1D dtcwt on bf16",
        "cases": {"dtcwt bf16": ["['fwd']: raise returned != TypeError",
                                 "['inv']: raise returned != TypeError"]},
    },
    "enable_x64 with float input": {
        "reason": "the port's enable_x64 sets only the dtype that integer and bool input "
                  "promotes to; float input keeps its dtype, as in torch. JAX with x64 off "
                  "computes float64 input in float32, and with x64 on (as the tests run it) "
                  "widens float32 input wherever it meets its float64 constants",
        "source": "ROADMAP.md, Queue 3, 'Deviations the census allows', enable_x64 (PR 10)",
        "cases": {"enable_x64 off": ["['dtype']: 'float64' != 'float32'"],
                  "cwt f32": [".coefficients: dtype complex64 != complex128",
                              ".time_axis: dtype float32 != float64"],
                  "ssq_cwt f32": ["result: dtype complex64 != complex128"]},
    },
    "sharded int32 geometry checks": {
        "reason": "the sharded layer omits JAX's int32 index checks (_check_doubling_bound, "
                  "pfft's overflow checks), because torch indexes in int64; they fire only "
                  "above 2^30 samples, beyond every census and test size",
        "source": "ROADMAP.md, Queue 3, 'Deviations the census allows', the sharded layer (PR 9)",
        "cases": {},
    },
}


# --------------------------------------------------------------------------
# observing and comparing
# --------------------------------------------------------------------------

@dataclass
class Raised:
    """A call that raised, as a leaf of a result (see :func:`attempt`)."""
    cls: str
    message: str


def attempt(fn):
    """``fn()``, or its exception as a :class:`Raised` leaf, so that one
    case can hold several calls that raise or return independently."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the census compares what was raised
        return Raised(type(e).__name__, str(e))


@dataclass
class Leaf:
    kind: str  # "array" (tensor or jax array), "numpy", "scalar", "exact", "container"
    dtype: str
    shape: tuple
    device: str | None  # a torch tensor's device type
    value: object


def observe(call: Callable, m, i: Inputs) -> dict:
    """Run one side: {path: Leaf}, or {"": Leaf("raise", ...)}."""
    r = attempt(lambda: call(m, i))
    out: dict = {}
    _walk(r, "", out)
    return out


def _walk(r, path: str, out: dict):
    if isinstance(r, Raised):
        out[path] = Leaf("raise", r.cls, (), None, r.message)
    elif hasattr(r, "detach") and hasattr(r, "dtype"):  # a torch tensor
        import torch

        t = r.detach()
        v = t.cpu()
        if v.is_complex():
            v = v.to(torch.complex128)
        elif v.is_floating_point():
            v = v.to(torch.float64)
        out[path] = Leaf("array", str(t.dtype).removeprefix("torch."), tuple(t.shape),
                         t.device.type, v.numpy())
    elif isinstance(r, (np.ndarray, np.generic)) or (
            hasattr(r, "__array__") and hasattr(r, "dtype") and hasattr(r, "shape")):
        kind = "numpy" if isinstance(r, (np.ndarray, np.generic)) else "array"
        a = np.asarray(r)
        name = a.dtype.name
        if a.dtype.kind == "c":
            a = a.astype(np.complex128)
        elif a.dtype.kind == "f" or name == "bfloat16":
            a = a.astype(np.float64)
        out[path] = Leaf(kind, name, a.shape, None, a)
    elif isinstance(r, (bool, int, float, complex)):
        out[path] = Leaf("scalar", type(r).__name__, (), None, r)
    elif r is None or isinstance(r, (str, enum.Enum)):
        out[path] = Leaf("exact", type(r).__name__, (), None, getattr(r, "value", r))
    elif dataclasses.is_dataclass(r):
        out[path] = Leaf("container", type(r).__name__, (), None,
                         tuple(f.name for f in dataclasses.fields(r)))
        for f in dataclasses.fields(r):
            _walk(getattr(r, f.name), f"{path}.{f.name}", out)
    elif isinstance(r, (tuple, list)):
        out[path] = Leaf("container", type(r).__name__, (), None, len(r))
        for k, v in enumerate(r):
            _walk(v, f"{path}[{k}]", out)
    elif isinstance(r, dict):
        keys = sorted(r, key=str)
        out[path] = Leaf("container", "dict", (), None, tuple(map(str, keys)))
        for k in keys:
            _walk(r[k], f"{path}[{k!r}]", out)
    elif hasattr(r, "__dict__"):
        keys = sorted(k for k in vars(r) if not k.startswith("_"))
        out[path] = Leaf("container", type(r).__name__, (), None, tuple(keys))
        for k in keys:
            _walk(getattr(r, k), f"{path}.{k}", out)
    else:
        out[path] = Leaf("exact", type(r).__name__, (), None, repr(r))


def _under(path: str, top: str) -> bool:
    return path == top or path.startswith((top + ".", top + "[")) if top else True


def _discrete(leaf: Leaf) -> bool:
    return np.asarray(leaf.value).dtype.kind in "biu"


def _max_err(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(max|got - want|, max(max|want|, 1)) over the finite entries, with
    NaN and infinities required where the reference has them."""
    g, w = np.asarray(got), np.asarray(want)
    fin = np.isfinite(w)
    if not np.array_equal(fin, np.isfinite(g)) or not np.array_equal(g[~fin], w[~fin],
                                                                      equal_nan=True):
        return float("inf"), 1.0
    if not fin.any():
        return 0.0, 1.0
    return float(np.max(np.abs(g[fin] - w[fin]))), max(float(np.max(np.abs(w[fin]))), 1.0)


def compare(got: dict, want: dict, tol: float, exact: tuple = (), dtypes: dict | None = None,
            device: str | None = None, near_tie: tuple = (), ties: list | None = None
            ) -> list[str]:
    """The census's rules, in order (module docstring); the mismatches, as
    short lines. ``dtypes``: an observation whose dtypes ``got`` must have
    (the card's reference dtypes come from the same call on the CPU in the
    same input dtype); otherwise ``want``'s. ``device``: every tensor of
    ``got`` must lie there. ``near_tie``: leaves (path prefixes) where a
    difference, or another structure, is float32 taking the other side of
    a tie (greedy pursuit picks, ROADMAP.md "Traps" and PR 10's
    ``picks_equal``; a best-basis tree): it goes to ``ties``, not to the
    mismatches, while the leaves such a tie leaves as they are (residual
    energies, a basis's cost and reconstruction) are still held to
    ``tol``."""
    bad = []
    # raise or return first, at every path where either side raised; what
    # the other side returned there is not compared further
    raised = sorted(p for p, v in (*got.items(), *want.items()) if v.kind == "raise")
    for p in dict.fromkeys(raised):
        gk, wk = (o[p].dtype if p in o and o[p].kind == "raise" else "returned"
                  for o in (got, want))
        if gk != wk:
            bad.append(f"{'raise' if p == '' else p + ': raise'} {gk} != {wk}")
        got = {k: v for k, v in got.items() if not _under(k, p)}
        want = {k: v for k, v in want.items() if not _under(k, p)}
    differ = set(got) ^ set(want)
    tied = {p for p in near_tie if any(_under(d, p) for d in differ)}
    if ties is not None and differ and all(any(_under(d, p) for p in tied) for d in differ):
        # a near-tie picked another tree: what it picked is not compared
        ties += [f"{p}: another structure" for p in sorted(tied)]
        got = {k: v for k, v in got.items() if not any(_under(k, p) for p in tied)}
        want = {k: v for k, v in want.items() if not any(_under(k, p) for p in tied)}
    if set(got) != set(want):
        return bad + [f"structure: {sorted(set(got) ^ set(want))[:6]}"]
    dt = dtypes if dtypes is not None else want
    for path in sorted(want):
        g, w = got[path], want[path]
        where = path or "result"
        if g.kind != w.kind:
            bad.append(f"{where}: kind {g.kind} != {w.kind}")
            continue
        if g.kind == "container":
            if (g.dtype, g.value) != (w.dtype, w.value):
                bad.append(f"{where}: {g.dtype} {g.value} != {w.dtype} {w.value}")
            continue
        if dt.get(path) is not None and g.dtype != dt[path].dtype:
            bad.append(f"{where}: dtype {g.dtype} != {dt[path].dtype}")
        if g.shape != w.shape:
            bad.append(f"{where}: shape {g.shape} != {w.shape}")
            continue
        if device is not None and g.device is not None and g.device != device:
            bad.append(f"{where}: on {g.device}")
        if g.kind == "exact":
            if g.value != w.value:
                bad.append(f"{where}: {g.value!r} != {w.value!r}")
            continue
        sink = ties if ties is not None and any(path.startswith(p) for p in near_tie) else bad
        if _discrete(w) or _discrete(g) or any(path.startswith(p) for p in exact):
            if not np.array_equal(np.asarray(g.value), np.asarray(w.value), equal_nan=True):
                sink.append(f"{where}: discrete values differ")
            continue
        err, scale = _max_err(np.asarray(g.value), np.asarray(w.value))
        if not err <= tol * scale:
            sink.append(f"{where}: max|err| {err:.3e} > {tol:.0e} * {scale:.3e}")
    return bad


def run_against_jax(c: Case, jt, jw, jit) -> list[str]:
    """The CPU census of one case: the port and JAX (``jit``: ``jax.jit``)
    on the same inputs in ``c.dtype``; the mismatches."""
    got = observe(c.port, jt, Inputs(jax=False, device="cpu", dtype=c.dtype))
    want = observe(c.jax or c.port, jw, Inputs(jax=True, dtype=c.dtype, jit=jit))
    return compare(got, want, c.tol, c.exact)


def card_tol(c: Case, dtype: str) -> float:
    if dtype in ("bfloat16", "float16"):
        return c.half_tol
    return CARD_TOL_DECIDE if c.tol >= TOL_DECIDE else CARD_TOL


def run_on_card(c: Case, jt, dtype: str, device: str = "cuda") -> tuple[list[str], list[str]]:
    """The card census of one case in one input dtype: the port on
    ``device`` against the port on the CPU in float64 (values, raise or
    return, shapes) and in ``dtype`` (dtypes); (mismatches, near-ties)."""
    got = observe(c.port, jt, Inputs(jax=False, device=device, dtype=dtype))
    want = observe(c.port, jt, Inputs(jax=False, device="cpu", dtype="float64"))
    same = observe(c.port, jt, Inputs(jax=False, device="cpu", dtype=dtype))
    if "" in same and same[""].kind == "raise":
        # the CPU's plain route refuses the dtype (the MODWT's FFT route on
        # bf16) where the card runs a kernel: the kernel keeps its storage
        same = {k: dataclasses.replace(v, dtype=dtype if v.dtype == "float64" else v.dtype)
                for k, v in want.items()}
    ties: list = []
    bad = compare(got, want, card_tol(c, dtype), c.exact, dtypes=same, device=device,
                  near_tie=c.near_tie, ties=ties)
    return bad, ties


def deviation(name: str) -> list[str]:
    """The mismatches :data:`DEVIATIONS` records for a case (none if it is
    not there)."""
    for entry in DEVIATIONS.values():
        if name in entry["cases"]:
            return entry["cases"][name]
    return []


def cases_of(file: str) -> list[Case]:
    """The cases tests/test_torch_census_<file>.py runs. ``--dist loadfile``
    gives a file one worker, and JAX's side costs most where a file first
    calls a function (its programs compile), so each file keeps a few
    functions together (CHANGES.md, PR 11)."""
    return [c for c in CASES if c.file == file]


def make_test(file: str, jt, jw, jit):
    """The test of one census file: each case of :func:`cases_of` through
    the port ``jt`` and the JAX package ``jw`` (``jit``: ``jax.jit``) on the
    CPU, in float64
    (float32 or bf16 where the case says so), held to :func:`compare`'s
    rules (raise or return, structure, shapes, dtypes, discrete outputs
    exactly, values within ``tol * max(max|ref|, 1)``: 1e-8; 1e-6 through a
    median, a threshold or an iteration; 1e-5 in float32). A disagreement
    fails unless :data:`DEVIATIONS` records it for the case, word for word.
    The kernel-edge cases (``file="card_<k>"``) run here in float64 as the rest
    do; chip_smoke.py runs them on the card in their ``card_dtypes``."""
    import pytest
    import torch

    torch.set_num_threads(2)

    @pytest.mark.parametrize("c", cases_of(file), ids=lambda c: c.name)
    def test_census(c):
        assert run_against_jax(c, jt, jw, jit) == deviation(c.name)

    return test_census


# --------------------------------------------------------------------------
# 1. the facade: every builder name, ten banks, five shapes, levels None and
#    0-3 forward and back, and decompose (the re-anchor's 425 cases)
# --------------------------------------------------------------------------

BANKS = ("Haar", "Haar orthogonal", "Daubechies 4", "Symlet 8", "Coiflet 2", "BiOrthogonal 3/5",
         "Legendre 3", "CDF 5/3", "Battle 23", "Discrete Mayer")
SHAPES = ((64,), (45,), (16, 32), (8, 8, 16), (3, 64))
BUILDER_NAMES = ("Fast Wavelet Transform", "Wavelet Packet Transform", "Shifting Wavelet Transform",
                 "Lifting Wavelet Transform", "Maximal Overlap Discrete Wavelet Transform",
                 "Ancient Egyptian Decomposition",
                 "Ancient Egyptian Decomposition Wavelet Packet Transform")
#: names the builder maps to a transform above
ALIASES = ("MODWT", "Ancient Egyptian Decomposition Fast Wavelet Transform")
FOURIER_NAMES = ("Discrete Fourier Transform", "Fast Fourier Transform")


def _facade(m, i, name, bank, shape):
    t = m.TransformBuilder.create(name, bank, **i.kw)
    x = i.x(*shape)
    out = {"identify": m.TransformBuilder.identify(t)}
    for lv in (None, 0, 1, 2, 3):
        args = () if lv is None else (lv,) * len(shape)
        y = attempt(lambda: i.jit(lambda v: t.forward(v, *args))(x))
        out[f"fwd {lv}"] = y
        if not isinstance(y, Raised):
            out[f"rev {lv}"] = attempt(lambda: i.jit(lambda v: t.reverse(v, *args))(y))
    dec = attempt(lambda: t.decompose(x))
    out["decompose"] = dec
    if not isinstance(dec, Raised):
        out["recompose past the last row"] = attempt(lambda: t.recompose(dec, 9))
    return out


def _shape_id(shape) -> str:
    return "x".join(map(str, shape))


# Each name meets every shape once (the 3D one only under the FWT: the
# other names run the same separable 3D code), with a bank that cycles
# over the even or the odd ones, alternating by name, so that each bank
# meets several names, each at another shape. The full product (462 cases) costs the JAX
# side ~350 s of compiling on the CPU: a new program for each transform
# object, shape and level.
for _k, _name in enumerate(BUILDER_NAMES):
    for _j, _shape in enumerate(SHAPES):
        if len(_shape) == 3 and _name != "Fast Wavelet Transform":
            continue
        _bank = BANKS[(2 * _j + _k) % len(BANKS)]
        case(name=f"facade {_name} | {_bank} | {_shape_id(_shape)}", file=f"facade_{1 + _k % 3}",
             port=lambda m, i, n=_name, b=_bank, s=_shape: _facade(m, i, n, b, s))
for _name in ALIASES:
    case(name=f"facade {_name} | Daubechies 4 | 64", file="facade_3",
         port=lambda m, i, n=_name: _facade(m, i, n, "Daubechies 4", (64,)))
for _name in FOURIER_NAMES:
    for _shape in SHAPES:
        case(name=f"facade {_name} | {_shape_id(_shape)}", file="facade_2",
             port=lambda m, i, n=_name, s=_shape: _facade(m, i, n, None, s))
case(name="facade unknown name", file="facade_1",
     port=lambda m, i: m.TransformBuilder.create("Fast Wavelet Transfrom", "Haar", **i.kw))
case(name="facade Fast Wavelet Transform f32", file="facade_1", dtype="float32", tol=TOL_F32,
     port=lambda m, i: _facade(m, i, "Fast Wavelet Transform", "Daubechies 4", (16, 32)))


FACADE_CLASSES = (("FastWaveletTransform", ("Haar",)), ("WaveletPacketTransform", ("Haar",)),
                  ("ShiftingWaveletTransform", ("Haar",)), ("LiftingWaveletTransform", ()),
                  ("MODWTTransform", ("Haar",)), ("DiscreteFourierTransform", ()),
                  ("FastFourierTransform", ()), ("WaveletTransform", ("Haar",)),
                  ("BasicTransform", ()))


def _classes(m, i):
    x = i.x(16)
    out = {}
    for cls, args in FACADE_CLASSES:
        t = getattr(m, cls)(*args, **i.kw)
        out[cls] = {"name": t.name, "wavelet": t.get_wavelet(),
                    "fwd": attempt(lambda: t.forward(x, 1))}
    aed = m.AncientEgyptianDecomposition(m.FastWaveletTransform("Haar", **i.kw), 4, **i.kw)
    out["AncientEgyptianDecomposition"] = aed.forward(i.x(12))
    cwt = m.ContinuousWaveletTransform("mexican hat", m.PaddingType.PERIODIC, **i.kw)
    out["ContinuousWaveletTransform"] = {"fft": cwt.transform_fft(x, i.put([1.0, 2.0]), 2.0),
                                         "forward": attempt(lambda: cwt.forward(x))}
    t = m.Transform(m.FastWaveletTransform("Haar", **i.kw))
    out["Transform"] = {"fwd": t.forward(x), "wavelet": t.get_wavelet(),
                        "not basic": attempt(lambda: m.Transform("Haar"))}
    return out


case(name="facade classes", file="facade_3", port=_classes)


# --------------------------------------------------------------------------
# 2. the discrete family
# --------------------------------------------------------------------------

_MODES = ("off", "on", "auto")


def _with_dial(m, i, mode: str, fn):
    """``fn()`` with both mxu dials at ``mode``. JAX's 'auto' resolves to
    'on' on its TPU and to 'off' on the CPU, for backend reasons; the port
    keeps the TPU's behaviour (ROADMAP.md, Queue 3), so JAX runs 'auto'
    cases as 'on'."""
    if i.jax and mode == "auto":
        mode = "on"
    m.config.set_mxu_butterfly(mode)
    m.config.set_mxu_dft(mode)
    try:
        return fn()
    finally:
        m.config.set_mxu_butterfly("auto")
        m.config.set_mxu_dft("auto")


def _wpt_pair(m, i, shape, bank, level, fused, layout):
    x = i.x(*shape)
    y = attempt(lambda: i.jit(lambda v: m.wpt(v, bank, level, fused=fused, layout=layout))(x))
    inv = x if isinstance(y, Raised) else y
    return {"wpt": y, "iwpt": attempt(
        lambda: i.jit(lambda v: m.iwpt(v, bank, level, fused=fused, layout=layout))(inv))}


_WPT_KINDS = (("Haar", True), ("Haar", False), ("Daubechies 4", True))
for _shape in ((1,), (2,), (16,), (1, 64), (100,), (2, 3, 32)):
    for _bank, _fused in _WPT_KINDS[:1] if _shape == (1, 64) else _WPT_KINDS:
        for _level in (None, 2) if _shape[-1] < 64 else (None,):
            case(name=f"wpt {_shape_id(_shape)} {_bank} L{_level} fused={_fused}",
                 file="discrete_1",
                 port=lambda m, i, s=_shape, b=_bank, lv=_level, f=_fused:
                 _wpt_pair(m, i, s, b, lv, f, "subband"))
for _mode in _MODES:
    for _shape, _level in (((2, 256), 3), ((128,), 1), ((64,), 2), ((256,), 0)):
        for _fused in (True, False):
            case(name=f"wpt interleaved dial={_mode} {_shape_id(_shape)} L{_level} fused={_fused}",
                 file="discrete_1",
                 port=lambda m, i, d=_mode, s=_shape, lv=_level, f=_fused: _with_dial(
                     m, i, d, lambda: _wpt_pair(m, i, s, "Daubechies 2", lv, f, "interleaved")))
    case(name=f"wpt subband dial={_mode}", file="discrete_1",
         port=lambda m, i, d=_mode: _with_dial(
             m, i, d, lambda: _wpt_pair(m, i, (2, 256), "Daubechies 2", 3, True, "subband")))
def _dtype(a) -> str:
    return str(a.dtype).removeprefix("torch.")


def _x64_off(m, i, fn):
    """``fn()`` with enable_x64(False), then each package's state as it was
    (JAX: on, as tests/conftest.py sets it)."""
    saved = None if i.jax else m.config._X64
    m.config.enable_x64(False)
    try:
        return fn()
    finally:
        if i.jax:
            m.config.enable_x64(True)
        else:
            m.config._X64 = saved


case(name="enable_x64 off", file="discrete_1", card=False,
     port=lambda m, i: _x64_off(m, i, lambda: {"dtype": _dtype(m.fwt(i.x(16), "Haar"))}))
case(name="wpt layout converters", file="discrete_1",
     port=lambda m, i: [m.wpt_interleaved_to_subband(i.x(2, 256), 3),
                        m.wpt_subband_to_interleaved(i.x(2, 256), 3)])
case(name="wpt unknown layout", file="discrete_1",
     port=lambda m, i: m.wpt(i.x(64), "Haar", 2, layout="tiles"))
case(name="wpt f32", file="discrete_1", dtype="float32", tol=TOL_F32,
     port=lambda m, i: _wpt_pair(m, i, (2, 3, 32), "Daubechies 4", None, True, "subband"))


def _shift_pair(m, i, n, bank):
    x = i.x(n)
    y = attempt(lambda: m.shifting_forward(x, bank))
    return {"fwd": y, "rev": attempt(lambda: m.shifting_reverse(x if isinstance(y, Raised) else y,
                                                                 bank))}


for _n, _bank in ((1, "Haar"), (2, "Daubechies 4"), (3, "Haar"), (16, "Daubechies 4")):
    case(name=f"shifting {_n} {_bank}", file="discrete_2",
             port=lambda m, i, n=_n, b=_bank: _shift_pair(m, i, n, b))


def _lifting(m, i, shape, scheme, boundary, level):
    x = i.x(*shape)
    out = {"dwt": attempt(lambda: i.jit(lambda v: m.lifting_dwt(v, scheme, boundary))(x))}
    if not isinstance(out["dwt"], Raised):
        out["idwt"] = attempt(lambda: i.jit(lambda a, d: m.lifting_idwt(a, d, scheme, boundary))(
            *out["dwt"]))
    out["fwt"] = attempt(lambda: i.jit(lambda v: m.lifting_fwt(v, scheme, level, boundary))(x))
    if not isinstance(out["fwt"], Raised):
        out["ifwt"] = attempt(lambda: i.jit(lambda v: m.lifting_ifwt(v, scheme, level, boundary))(
            out["fwt"]))
    return out


for _scheme in ("CDF 5/3", "CDF 9/7", "Haar lifting"):
    for _boundary in ("periodic", "symmetric", "zero"):
        for _shape, _level in (((64,), None), ((7,), 1)):
            case(name=f"lifting {_scheme} {_boundary} {_shape_id(_shape)} L{_level}",
                 file="discrete_2",
                 port=lambda m, i, s=_shape, sc=_scheme, b=_boundary, lv=_level:
                 _lifting(m, i, s, sc, b, lv))
case(name="lifting facade", file="discrete_2",
     port=lambda m, i: m.LiftingWaveletTransform("CDF 5/3", **i.kw).forward(i.x(64), 3))


def _dtcwt_pair(m, i, shape, levels, l1, two_d):
    x = i.x(*shape)
    fwd, inv = (m.dtcwt2d, m.idtcwt2d) if two_d else (m.dtcwt, m.idtcwt)
    r = attempt(lambda: i.jit(lambda v: fwd(v, levels, l1))(x))
    return {"fwd": r, "inv": r if isinstance(r, Raised) else attempt(lambda: i.jit(inv)(r))}


for _shape, _levels, _l1 in (((64,), 3, "sym4"), ((2, 100), 2, "sym4"), ((16,), 1, "db2"),
                             ((8,), 4, "sym4")):
    case(name=f"dtcwt {_shape_id(_shape)} L{_levels} {_l1}", file="discrete_3",
         port=lambda m, i, s=_shape, lv=_levels, l1=_l1: _dtcwt_pair(m, i, s, lv, l1, False))
for _shape, _levels in (((2, 16, 16), 2),):
    case(name=f"dtcwt2d {_shape_id(_shape)} L{_levels}", file="discrete_3",
         port=lambda m, i, s=_shape, lv=_levels: _dtcwt_pair(m, i, s, lv, "sym4", True))
case(name="dtcwt bf16", file="discrete_3", dtype="bfloat16", tol=CARD_TOL_HALF, card=False,
     port=lambda m, i: _dtcwt_pair(m, i, (64,), 3, "sym4", False))


#: a node's cost and its children's can tie in exact arithmetic (where a
#: block is too short to transform, the children copy the parent), and
#: float32 then keeps the other side of the tie: on the card the tree may
#: differ from float64's, while the cost and the reconstruction may not
BASIS_TIES = ("['bb'].nodes", "['bb'].coefficients")


def _best_basis(m, i, shape, max_level, cost, threshold):
    bb = m.best_basis(i.x(*shape), "Daubechies 4", max_level, cost, threshold)
    return {"bb": bb, "rec": m.best_basis_reconstruct(bb)}


for _cost, _thr in (("shannon", 0.0), ("threshold", 0.5), ("l1", 0.0), ("threshold", 0.0),
                    ("entropy", 0.0)):
    for _shape, _ml in (((3, 64), 3),):
        case(name=f"best_basis {_cost} {_thr} {_shape_id(_shape)} {_ml}", file="discrete_4",
             port=lambda m, i, s=_shape, ml=_ml, c=_cost, t=_thr: _best_basis(m, i, s, ml, c, t),
             exact=("['bb'].nodes",), near_tie=BASIS_TIES)


def _best_basis_2d(m, i, shape, max_level, cost):
    bb = m.best_basis_2d(i.x(*shape), "Haar", max_level, cost)
    return {"bb": bb, "rec": m.best_basis_2d_reconstruct(bb)}


for _cost in ("l1",):
    for _shape, _ml in (((8, 16), None),):
        case(name=f"best_basis_2d {_cost} {_shape_id(_shape)} {_ml}", file="discrete_4",
             port=lambda m, i, s=_shape, ml=_ml, c=_cost: _best_basis_2d(m, i, s, ml, c),
             exact=("['bb'].nodes",), near_tie=BASIS_TIES)


def _compress(m, i, cls, threshold, shape):
    c = getattr(m, cls)(threshold)
    y = c.compress(i.x(*shape))
    return {"y": y, "rate": c.compression_rate(y), "magnitude": c.magnitude}


COMPRESSORS = ("CompressorMagnitude", "CompressorPeaksAverage")
for _cls in COMPRESSORS:
    for _thr in (0.5, 2.0):
        for _shape in ((64,), (8, 16)):
            case(name=f"compress {_cls} {_thr} {_shape_id(_shape)}", file="discrete_3",
                 port=lambda m, i, c=_cls, t=_thr, s=_shape: _compress(m, i, c, t, s))
    case(name=f"compress {_cls} threshold 0", file="discrete_3",
         port=lambda m, i, c=_cls: getattr(m, c)(0.0))
case(name="compress base class", file="discrete_3",
     port=lambda m, i: m.Compressor(1.0).compress(i.x(16)))


def _fwt_tools(m, i, shape, bank, level):
    x = i.x(*shape)
    y = attempt(lambda: i.jit(lambda v: m.fwt(v, bank, level))(x))
    out = {"fwt": y}
    if not isinstance(y, Raised):
        out["ifwt"] = attempt(lambda: i.jit(lambda v: m.ifwt(v, bank, level))(y))
        parts = attempt(lambda: m.fwt_split(y, level))
        out["split"] = parts
        if not isinstance(parts, Raised):
            out["merge"] = attempt(lambda: m.fwt_merge(parts))
    dec = attempt(lambda: i.jit(lambda v: m.fwt_decompose(v, bank))(x))
    out["decompose"] = dec
    if not isinstance(dec, Raised):
        out["recompose"] = attempt(lambda: i.jit(lambda d: m.fwt_recompose(d, bank, level))(dec))
    return out


for _shape in ((1,), (2,), (3,), (4,), (16,), (100,), (256,), (2, 3, 64)):
    for _level in (None, 0, 1, 3):
        case(name=f"fwt tools {_shape_id(_shape)} L{_level}", file="discrete_5",
             port=lambda m, i, s=_shape, lv=_level: _fwt_tools(m, i, s, "Daubechies 4", lv))
case(name="fwt tools f32", file="discrete_5", dtype="float32", tol=TOL_F32,
     port=lambda m, i: _fwt_tools(m, i, (16,), "Daubechies 4", None))


def _fwt2d_pair(m, i, shape, bank, lr, lc):
    x = i.x(*shape)
    y = attempt(lambda: i.jit(lambda v: m.fwt2d(v, bank, lr, lc))(x))
    return {"fwt2d": y, "ifwt2d": y if isinstance(y, Raised) else attempt(
        lambda: i.jit(lambda v: m.ifwt2d(v, bank, lr, lc))(y))}


for _shape, _lr, _lc, _bank in (((16, 32), None, None, "Daubechies 4"),
                                ((4, 16), 1, 2, "Haar orthogonal"),
                                ((12, 16), None, None, "Daubechies 4")):
    case(name=f"fwt2d {_shape_id(_shape)} {_bank} {_lr},{_lc}", file="discrete_6",
         port=lambda m, i, s=_shape, b=_bank, lr=_lr, lc=_lc: _fwt2d_pair(m, i, s, b, lr, lc))


def _aed(m, i, n):
    x = i.x(n)
    y = i.jit(lambda u: m.aed_forward(u, lambda v: m.fwt(v, "Daubechies 4")))(x)
    return {"fwd": y,
            "rev": i.jit(lambda u: m.aed_reverse(u, lambda v: m.ifwt(v, "Daubechies 4")))(y)}


for _n in (7, 100):
    case(name=f"aed {_n}", file="discrete_4", port=lambda m, i, n=_n: _aed(m, i, n))


def _variants(m, i):
    x = i.x(64)
    inplace = m.InPlaceFastWaveletTransform("Daubechies 4", **i.kw)
    y = inplace.forward_in_place(i.x(64))
    eff = m.EfficientMODWTTransform("Daubechies 4", **i.kw)
    return {"inplace": y, "inplace_rev": inplace.reverse_in_place(y * 1),
            "pooled_wpt": m.PooledWaveletPacketTransform("Haar", **i.kw).forward(x, 3),
            "pooled_fft": m.PooledFastFourierTransform(**i.kw).forward(x),
            "pooled_modwt": m.PooledMODWTTransform("Haar", **i.kw).forward_modwt(x, 2),
            "streaming": eff.forward_streaming(i.x(100), 2, 16),
            "parallel_wpt": m.ParallelWaveletPacketTransform("Haar", **i.kw).forward(x, 2),
            "parallel_dft": m.ParallelDiscreteFourierTransform(**i.kw).forward(x),
            "parallel": m.ParallelTransform(m.FastWaveletTransform("Haar", **i.kw)).forward(
                i.x(8, 16))}


case(name="variants", file="discrete_4", port=_variants)


CONTAINERS = (("Line", (4,)), ("LineFull", (4,)), ("LineHash", (4,)), ("Block", (2, 3)),
              ("BlockFull", (2, 3)), ("BlockHash", (2, 3)), ("Space", (2, 2, 2)),
              ("SpaceFull", (2, 2, 2)), ("SpaceHash", (2, 2, 2)))


def _containers(m, i):
    out = {}
    for cls, dims in CONTAINERS:
        c = getattr(m, cls)(*dims)
        out[cls + " unallocated"] = attempt(lambda: c.get(*(0,) * len(dims)))
        c.alloc()
        c.set(*(1,) * len(dims), 2.5)
        out[cls] = {"get": c.get(*(1,) * len(dims)), "zero": c.get(*(0,) * len(dims)),
                    "numpy": c.to_numpy(), "outside": attempt(lambda: c.get(*(9,) * len(dims)))}
    out["bad dims"] = attempt(lambda: m.Line(0))
    return out


case(name="containers", file="discrete_4", port=_containers)


# --------------------------------------------------------------------------
# 3. the MODWT family
# --------------------------------------------------------------------------

NS = (1, 2, 3, 7, 16, 33, 64, 100, 128, 256)
MODWT_BANKS = ("Haar", "Daubechies 4", "Symlet 8", "Coiflet 2")


def _modwt_levels(m, i, n, bank, method, boundary):
    x = i.x(2, n)
    meth = getattr(m.ConvolutionMethod, method)
    out = {}
    for lv in range(7):
        c = attempt(lambda: i.jit(
            lambda v: m.modwt(v, bank, lv, meth, 16, boundary, boundary == "periodic"))(x))
        out[f"modwt {lv}"] = c
        if not isinstance(c, Raised):
            out[f"imodwt {lv}"] = attempt(lambda: i.jit(lambda v: m.imodwt(v, bank, meth, 16))(c))
    return out


# each (method, boundary, bank) at levels 0-6 and one length, the lengths
# cycling over the grid (each method meets eight of its ten)
_k = 0
for _method in ("AUTO", "DIRECT", "FFT"):
    for _boundary in ("periodic", "reflection"):
        for _bank in MODWT_BANKS:
            _n = NS[(3 * _k) % 10]
            case(name=f"modwt {_method} {_boundary} {_bank} N{_n}",
                 file="modwt_2" if _method == "DIRECT" else "modwt_1",
                 port=lambda m, i, n=_n, b=_bank, me=_method, bd=_boundary:
                 _modwt_levels(m, i, n, b, me, bd))
            _k += 1
for _method in ("PALLAS", "MXU"):
    case(name=f"modwt {_method} on float64 raises", file="modwt_1", card=False,
         port=lambda m, i, me=_method: m.modwt(i.x(64), "Haar", 2,
                                               getattr(m.ConvolutionMethod, me)))
case(name="modwt unknown boundary", file="modwt_1",
     port=lambda m, i: m.modwt(i.x(64), "Haar", 2, boundary="circular"))
case(name="modwt level 14", file="modwt_1", port=lambda m, i: m.modwt(i.x(64), "Haar", 14))
case(name="modwt f32", file="modwt_1", dtype="float32", tol=TOL_F32,
     port=lambda m, i: _modwt_levels(m, i, 100, "Daubechies 4", "AUTO", "periodic"))


def _mra(m, i, shape, bank, level, boundary):
    return m.modwt_mra(i.x(*shape), bank, level, boundary)


for _shape, _bank, _level, _boundary in (((2, 100), "Haar", 4, "reflection"),
                                         ((2, 3, 16), "Coiflet 2", 1, "periodic")):
    case(name=f"modwt_mra {_shape_id(_shape)} {_bank} L{_level} {_boundary}", file="modwt_2",
         port=lambda m, i, s=_shape, b=_bank, lv=_level, bd=_boundary: _mra(m, i, s, b, lv, bd))


def _stats(m, i, shape, bank, level, unbiased):
    x, y = i.x(*shape), i.x(*shape, seed=1)
    return {"var": attempt(lambda: i.jit(lambda u: m.modwt_variance(u, bank, level, unbiased))(x)),
            "ci": attempt(lambda: i.jit(
                lambda u: m.modwt_variance_ci(u, bank, level, 0.9, unbiased))(x)),
            "cov": attempt(lambda: i.jit(
                lambda u, v: m.modwt_covariance(u, v, bank, level, unbiased))(x, y)),
            "corr": attempt(lambda: i.jit(
                lambda u, v: m.modwt_correlation(u, v, bank, level, unbiased))(x, y)),
            "spectrum": attempt(lambda: i.jit(
                lambda u: m.wavelet_log_spectrum(u, bank, level, unbiased))(x))}


for _shape, _bank, _level, _unbiased in (((256,), "Daubechies 4", 4, True),
                                         ((2, 128), "Haar", 3, False)):
    case(name=f"modwt statistics {_shape_id(_shape)} {_bank} L{_level} unbiased={_unbiased}",
         file="modwt_3",
         port=lambda m, i, s=_shape, b=_bank, lv=_level, u=_unbiased: _stats(m, i, s, b, lv, u))

for _kind, _level in (("fgn", None), ("fractal", None)):
    case(name=f"hurst_exponent {_kind} L{_level}", file="modwt_3",
         port=lambda m, i, k=_kind, lv=_level: i.jit(
             lambda v: m.hurst_exponent(v, "Daubechies 4", lv, k))(i.x(2, 512)))


def _modwt_1d(m, i, n, level):
    flat = m.modwt_1d(i.x(n), "Daubechies 4", level)
    return {"flat": flat, "back": m.imodwt_1d(flat, "Daubechies 4", level)}


for _n, _level in ((100, 3),):
    case(name=f"modwt_1d {_n} L{_level}", file="modwt_3",
         port=lambda m, i, n=_n, lv=_level: _modwt_1d(m, i, n, lv))


def _modwt_2d(m, i, shape, bank, level):
    x = i.x(*shape)
    c = i.jit(lambda v: m.modwt_2d(v, bank, level))(x)
    return {"c": c, "back": i.jit(lambda v: m.imodwt_2d(v, bank))(c),
            "mra": i.jit(lambda v: m.modwt_mra_2d(v, bank, level))(x)}


for _shape, _bank, _level in (((2, 12, 20), "Daubechies 4", 2),):
    case(name=f"modwt_2d {_shape_id(_shape)} {_bank} L{_level}", file="modwt_3",
         port=lambda m, i, s=_shape, b=_bank, lv=_level: _modwt_2d(m, i, s, b, lv))


def _facade_modwt(m, i, method):
    t = m.MODWTTransform("Daubechies 4", getattr(m.ConvolutionMethod, method), 64, **i.kw)
    c = t.forward_modwt(i.x(100), 3)
    t.set_convolution_method(m.ConvolutionMethod.DIRECT)
    c2 = t.forward_modwt_2d(i.x(8, 16), 2)
    return {"c": c, "back": t.inverse_modwt(c), "c2": c2, "back2": t.inverse_modwt_2d(c2),
            "decompose": attempt(lambda: t.decompose(i.x(64)))}


for _method in ("AUTO",):
    case(name=f"MODWTTransform {_method}", file="modwt_3",
         port=lambda m, i, me=_method: _facade_modwt(m, i, me))


def _sliding(m, i, window, level, steps):
    x = i.x(2, window + sum(steps))
    st = i.jit(lambda v: m.sliding_modwt_init(v, "Daubechies 4", level))(x[..., :window])
    out = {"init": st}
    t = window
    for k, s in enumerate(steps):
        st = i.jit(lambda u, v: m.sliding_modwt_update(u, v, "Daubechies 4", level))(
            st, x[..., t:t + s])
        out[f"update {k}"] = st
        t += s
    sl = m.SlidingMODWT("Haar", 2, 16)
    s0 = sl.init(x[..., :16])
    out["SlidingMODWT"] = sl.update(s0, x[..., 16:19])
    return out


for _window, _level, _steps in ((64, 3, (1, 5)),):
    case(name=f"sliding W{_window} L{_level} {_steps}", file="modwt_4",
         port=lambda m, i, w=_window, lv=_level, s=_steps: _sliding(m, i, w, lv, s))


def _denoise(m, i, shape, method, mode, threshold):
    return i.jit(lambda v: m.denoise(v, "Daubechies 4", 3, mode, threshold, method))(i.x(*shape))


for _method, _thr, _mode in (("universal", None, "soft"), ("sure", None, "hard"),
                             ("bayes", None, "soft"), ("universal", 0.3, "hard"),
                             ("sure", None, "garrote")):
    case(name=f"denoise {_method} {_thr} {_mode}", file="modwt_4", tol=TOL_DECIDE,
         port=lambda m, i, me=_method, mo=_mode, t=_thr: _denoise(m, i, (2, 256), me, mo, t))
case(name="denoise unknown method", file="modwt_4",
     port=lambda m, i: m.denoise(i.x(64), "Haar", 2, method="minimax"))
for _method in ("bayes",):
    case(name=f"denoise_2d {_method}", file="modwt_4", tol=TOL_DECIDE,
         port=lambda m, i, me=_method: i.jit(lambda v: m.denoise_2d(v, "Haar", 2, "soft", me))(
             i.x(32, 32)))


# --------------------------------------------------------------------------
# 4. the continuous layer
# --------------------------------------------------------------------------

CWAVELETS = (("morlet", ()), ("mexican hat", ()), ("paul", (4,)), ("dog", (2,)), ("meyer", ()),
             ("morse", (20.0, 3.0)))
PADDINGS = ("ZERO", "SYMMETRIC", "PERIODIC", "CONSTANT")


def _scales(m, i):
    """Scales as a caller passes them: float64 numpy, whatever the signal's
    dtype."""
    return m.generate_log_scales(0.05, 2.0, 6)


def _wavelet_methods(m, i, name, args):
    w = m.get_continuous_wavelet(name, *args)
    t, om = i.put(np.linspace(-4.0, 4.0, 33)), i.put(np.linspace(-6.0, 6.0, 33))
    return {"w": w, "psi": w.psi(t), "psi_hat": w.psi_hat(om),
            "psi_scaled": w.psi_scaled(t, 2.0, 0.5),
            "psi_hat_scaled": w.psi_hat_scaled(om, 2.0, 0.5),
            "admissibility": w.admissibility_constant(), "support": w.effective_support(),
            "bandwidth": w.bandwidth()}


# each wavelet at one padding, the paddings cycling over the wavelets
for _k, (_name, _args) in enumerate(CWAVELETS):
    case(name=f"cwavelet {_name}", file="continuous_1",
         port=lambda m, i, n=_name, a=_args: _wavelet_methods(m, i, n, a))
    for _pad in (PADDINGS[_k % 4],):
        case(name=f"cwt {_name} {_pad}", file="continuous_1",
             port=lambda m, i, n=_name, a=_args, p=_pad: m.cwt(
                 i.x(2, 100), _scales(m, i), m.get_continuous_wavelet(n, *a), 10.0,
                 getattr(m.PaddingType, p)))
case(name="cwavelet unknown", file="continuous_1",
     port=lambda m, i: m.get_continuous_wavelet("gabor"))
for _shape in ((1,), (2,)):
    case(name=f"cwt {_shape_id(_shape)}", file="continuous_1",
         port=lambda m, i, s=_shape: m.cwt(i.x(*s), _scales(m, i), "morlet", 10.0))

case(name="cwt no scales", file="continuous_1",
     port=lambda m, i: m.cwt(i.x(64), np.zeros(0), "morlet"))
case(name="cwt f32", file="continuous_1", dtype="float32", tol=TOL_F32,
     port=lambda m, i: m.cwt(i.x(2, 100), _scales(m, i), "morlet", 10.0))


def _cwt_family(m, i, shape, wavelet):
    x, s = i.x(*shape), _scales(m, i)
    r = i.jit(lambda v: m.cwt(v, s, wavelet, 10.0))(x)
    return {"direct": m.cwt_direct(x, s, wavelet, 10.0),
            "chunked": i.jit(lambda v: m.cwt_chunked(v, s, wavelet, 10.0, scale_chunk=4))(x),
            "icwt": i.jit(m.icwt)(r), "icwt named": i.jit(lambda v: m.icwt(v, wavelet, 1e-8))(r),
            "xwt": i.jit(lambda u, v: m.xwt(u, v, s, wavelet, 10.0))(x, i.x(*shape, seed=1))}


for _shape, _wavelet in (((2, 100), "mexican hat"),):
    case(name=f"cwt family {_shape_id(_shape)} {_wavelet}", file="continuous_1",
         port=lambda m, i, s=_shape, w=_wavelet: _cwt_family(m, i, s, w))
    # a ratio of smoothed spectra: where an autospectrum is small, it keeps
    # fewer digits than the transforms it divides
    case(name=f"wavelet_coherence {_shape_id(_shape)} {_wavelet}", file="continuous_2",
         tol=TOL_DECIDE,
         port=lambda m, i, s=_shape, w=_wavelet: i.jit(lambda u, v: m.wavelet_coherence(
             u, v, _scales(m, i), w, 10.0, boxcar=3))(i.x(*s), i.x(*s, seed=1)))


def _tone(m, i, batch=()):
    t = np.arange(256) / 100.0
    x = np.cos(2 * np.pi * 12.0 * t) + 0.5 * np.cos(2 * np.pi * 30.0 * t)
    return i.put(np.broadcast_to(x, batch + (256,)).copy())


def _ssq(m, i, batch, frequencies, out_of_range, reassign, gamma):
    r = i.jit(lambda v: m.ssq_cwt(v, m.generate_log_scales(0.01, 0.5, 24), "morlet", 100.0,
                                  frequencies=frequencies, gamma=gamma,
                                  out_of_range=out_of_range, reassign=reassign))(_tone(m, i, batch))
    ridge = i.jit(lambda v: m.extract_ridge(v, 2, 2.0, 2))(r)
    return {"ssq": r, "issq": m.issq_cwt(r), "band": m.issq_cwt(r, "morlet", (8.0, 20.0)),
            "ridge": ridge, "tube": i.jit(lambda v, k: m.ridge_tube_mask(v, k, 2))(r, ridge[0]),
            "tube issq": m.issq_cwt(r, None, m.ridge_tube_mask(r, ridge[0][..., 0, :], 1))}


# The default |W| threshold, 10 sqrt(eps) of max|W|, follows the dtype, so a
# float32 call keeps other coefficients than float64's: the card runs the
# cases that pin gamma
for _batch, _freqs, _oor, _reassign, _gamma in (((), None, "clip", "auto", None),
                                                ((2,), 16, "drop", "dense", 1e-4)):
    case(name=f"ssq_cwt {_batch} {_freqs} {_oor} {_reassign} gamma={_gamma}", file="continuous_3",
         tol=TOL_DECIDE, exact=("['ridge']",), card=_gamma is not None,
         port=lambda m, i, b=_batch, f=_freqs, o=_oor, r=_reassign, g=_gamma:
         _ssq(m, i, b, f, o, r, g))
case(name="ssq_cwt bad options", file="continuous_3",
     port=lambda m, i: [attempt(lambda: m.ssq_cwt(i.x(64), _scales(m, i), out_of_range="wrap")),
                        attempt(lambda: m.ssq_cwt(i.x(64), _scales(m, i), reassign="sort")),
                        attempt(lambda: m.ssq_cwt(i.x(64), _scales(m, i), "mexican hat"))])
case(name="ssq_cwt f32", file="continuous_3", dtype="float32", tol=TOL_F32,
     port=lambda m, i: m.ssq_cwt(_tone(m, i), m.generate_log_scales(0.01, 0.5, 24), "morlet",
                                 100.0, gamma=1e-3).Tx)


def _analytic(m, i, shape):
    x = i.x(*shape)
    return {"fft": m.fft(x), "ifft": m.ifft(m.fft(x)), "fft axis 0": attempt(lambda: m.fft(x, 0)),
            "analytic": m.analytic_signal(x), "envelope": m.envelope(x),
            "inst freq": attempt(lambda: m.instantaneous_frequency(x, 10.0))}


for _shape in ((1,), (2,), (2, 3, 16)):
    case(name=f"fft analytic {_shape_id(_shape)}", file="continuous_2",
         port=lambda m, i, s=_shape: _analytic(m, i, s))
case(name="fft complex", file="continuous_2",
     port=lambda m, i: {"fft": m.fft(i.z(2, 16)), "ifft": m.ifft(i.z(2, 16), 0)})


# --------------------------------------------------------------------------
# 5. the analysis layer
# --------------------------------------------------------------------------

def _chirp(m, i, batch=(), n=256):
    t = np.arange(n) / 100.0
    x = np.cos(2 * np.pi * (5.0 + 4.0 * t) * t) + 0.5 * np.cos(2 * np.pi * 30.0 * t)
    return i.put(np.broadcast_to(x + 0.1 * np.random.default_rng(n).standard_normal(n),
                                 batch + (n,)).copy())


for _batch, _mult, _omax in (((2,), True, 3),):
    case(name=f"superlet {_batch} multiplicative={_mult}", file="analysis_1",
         port=lambda m, i, b=_batch, mu=_mult, o=_omax: i.jit(lambda v: m.superlet(
             v, i.put(np.linspace(4.0, 30.0, 6)), 100.0, 3.0, 1, o, mu))(_chirp(m, i, b)))


def _ewt(m, i, batch, n_modes):
    x = _chirp(m, i, batch)
    r = m.ewt(x, n_modes)
    b = m.ewt_boundaries(x, n_modes)
    return {"ewt": r, "iewt": m.iewt(r), "boundaries": b,
            "boundaries sep": m.ewt_boundaries(x, n_modes, 4),
            "bank": m.ewt_filter_bank(256, b), "given": m.ewt(x, None, b),
            # in the input's dtype: on the card float32, so not exact there
            "given as array": m.ewt(x, None, i.put(b)),
            "bank from array": m.ewt_filter_bank(256, i.put(b))}


for _batch, _k in (((), 3), ((2,), 4)):
    case(name=f"ewt {_batch} K{_k}", file="analysis_1",
         exact=("['boundaries", "['ewt'].boundaries", "['given'].boundaries"),
         port=lambda m, i, b=_batch, k=_k: _ewt(m, i, b, k))
case(name="ewt f32", file="analysis_1", dtype="float32", tol=TOL_F32, exact=(".boundaries",),
     port=lambda m, i: m.ewt(_chirp(m, i), 3))
case(name="ewt without modes or boundaries", file="analysis_1", port=lambda m, i: m.ewt(i.x(64)))

for _batch, _bins, _tw, _lw in (((2,), 64, 31, 15),):
    case(name=f"wigner_ville {_batch} {_bins} {_tw} {_lw}", file="analysis_1",
         port=lambda m, i, b=_batch, nb=_bins, tw=_tw, lw=_lw: m.wigner_ville(
             _chirp(m, i, b, 128), 100.0, nb, tw, lw))

for _init, _dc, _tau in (("uniform", False, 0.0), ("zero", True, 0.1)):
    case(name=f"vmd {_init} dc={_dc} tau={_tau}", file="analysis_1", tol=TOL_DECIDE,
         port=lambda m, i, it=_init, dc=_dc, ta=_tau: m.vmd(_chirp(m, i, (), 128), 2, 500.0, ta, it,
                                                            25, dc))
case(name="vmd unknown init", file="analysis_1",
     port=lambda m, i: m.vmd(i.x(64), 2, init="random"))


def _pursuit(m, i, batch, n_atoms, fps):
    d = m.gabor_dictionary(128, None, fps)
    return {"dict": d, "mp": m.matching_pursuit(_chirp(m, i, batch, 128), n_atoms, d),
            "mp default": m.matching_pursuit(_chirp(m, i, batch, 128), 3)}


for _batch, _atoms, _fps in (((2,), 3, 4),):
    case(name=f"matching_pursuit {_batch} {_atoms} {_fps}", file="analysis_1", tol=TOL_DECIDE,
         near_tie=("['mp'].alphas", "['mp'].betas", "['mp'].atom_idx", "['mp'].positions",
                   "['mp'].residual", "['mp default'].alphas", "['mp default'].betas",
                   "['mp default'].atom_idx", "['mp default'].positions",
                   "['mp default'].residual"),
         port=lambda m, i, b=_batch, a=_atoms, f=_fps: _pursuit(m, i, b, a, f))


def _scattering1d(m, i, batch, J, Q, Q2, oversampling):
    r = i.jit(lambda v: m.scattering1d(v, J, Q, 100.0, Q2, oversampling=oversampling))(
        _chirp(m, i, batch))
    return {"r": r, "features": r.features()}


for _batch, _J, _Q, _Q2, _os in (((2,), 3, 2, 2, 1),):
    case(name=f"scattering1d {_batch} J{_J} Q{_Q} Q2{_Q2} os{_os}", file="analysis_2",
         port=lambda m, i, b=_batch, J=_J, Q=_Q, Q2=_Q2, o=_os: _scattering1d(m, i, b, J, Q, Q2, o))
case(name="scattering_filter_bank", file="analysis_2",
     port=lambda m, i: m.scattering_filter_bank(512, 4, 4, 1))


def _scattering2d(m, i, shape, J, L):
    r = i.jit(lambda v: m.scattering2d(v, J, L))(i.x(*shape))
    return {"r": r, "features": r.features()}


for _shape, _J, _L in (((2, 32, 16), 2, 2),):
    case(name=f"scattering2d {_shape_id(_shape)} J{_J} L{_L}", file="analysis_2",
         port=lambda m, i, s=_shape, J=_J, L=_L: _scattering2d(m, i, s, J, L))
case(name="scattering_filter_bank_2d", file="analysis_2",
     port=lambda m, i: m.scattering_filter_bank_2d(32, 32, 2, 4))

for _shape, _levels, _sigma in (((16, 16), 2, 0.5),):
    case(name=f"denoise_dtcwt {_shape_id(_shape)} L{_levels} {_sigma}", file="analysis_3",
         tol=TOL_DECIDE,
         port=lambda m, i, s=_shape, lv=_levels, sg=_sigma: i.jit(
             lambda v: m.denoise_dtcwt(v, lv, sg, 5))(i.x(*s)))


# --------------------------------------------------------------------------
# 6. the utilities
# --------------------------------------------------------------------------

def _bank(m, name):
    return m.get_filter(name)


case(name="available_filters", file="api",
     port=lambda m, i: {"names": m.available_filters(),
                        "junit": [f.name for f in m.junit_passing_filters()]})
case(name="unknown filter", file="api", port=lambda m, i: m.get_filter("Daubechies 99"))
for _name in ("Haar", "Haar orthogonal", "Daubechies 1", "Daubechies 2", "Daubechies 3",
              "Daubechies 4", "Daubechies 5", "Daubechies 6", "Daubechies 7", "Daubechies 8",
              "Daubechies 9", "Daubechies 10", "Daubechies 11", "Daubechies 12", "Daubechies 13",
              "Daubechies 14", "Daubechies 15", "Daubechies 16", "Daubechies 17", "Daubechies 18",
              "Daubechies 19", "Daubechies 20", "Symlet 2", "Symlet 3", "Symlet 4", "Symlet 5",
              "Symlet 6", "Symlet 7", "Symlet 8", "Symlet 9", "Symlet 10", "Symlet 11", "Symlet 12",
              "Symlet 13", "Symlet 14", "Symlet 15", "Symlet 16", "Symlet 17", "Symlet 18",
              "Symlet 19", "Symlet 20", "Coiflet 1", "Coiflet 2", "Coiflet 3", "Coiflet 4",
              "Coiflet 5", "Legendre 1", "Legendre 2", "Legendre 3", "BiOrthogonal 1/1",
              "BiOrthogonal 1/3", "BiOrthogonal 1/5", "BiOrthogonal 2/2", "BiOrthogonal 2/4",
              "BiOrthogonal 2/6", "BiOrthogonal 2/8", "BiOrthogonal 3/1", "BiOrthogonal 3/3",
              "BiOrthogonal 3/5", "BiOrthogonal 3/7", "BiOrthogonal 3/9", "BiOrthogonal 4/4",
              "BiOrthogonal 5/5", "BiOrthogonal 6/8", "CDF 5/3", "CDF 9/7", "Battle 23",
              "Discrete Mayer"):
    case(name=f"filter {_name}", file="api", exact=(".",),
         port=lambda m, i, n=_name: _bank(m, n))
for _alias in ("db4", "sym8", "haar", "coif2", "bior3.5"):
    case(name=f"filter alias {_alias}", file="api", exact=(".",),
         port=lambda m, i, n=_alias: _bank(m, n))


def _schemes(m, i):
    return {"names": m.lifting_schemes(),
            "schemes": [m.get_scheme(n) for n in m.lifting_schemes()],
            "unknown": attempt(lambda: m.get_scheme("CDF 13/7"))}


case(name="lifting schemes", file="api", port=_schemes)
for _lo, _hi, _num in ((0.5, 64.0, 8), (1.0, 1.0, 1), (2.0, 16.0, 0), (-1.0, 4.0, 3)):
    case(name=f"scale generators {_lo} {_hi} {_num}", file="api",
         port=lambda m, i, lo=_lo, hi=_hi, n=_num: {
             "log": attempt(lambda: m.generate_log_scales(lo, hi, n)),
             "linear": attempt(lambda: m.generate_linear_scales(lo, hi, n))})


def _thresholds(m, i, shape):
    c = i.x(*shape)
    return {"soft": m.soft_threshold(c, 0.5), "hard": m.hard_threshold(c, 0.5),
            "soft 0": m.soft_threshold(c, 0.0), "mad": m.mad_sigma(c)}


for _shape in ((1,), (7,), (2, 3, 16)):
    case(name=f"thresholds {_shape_id(_shape)}", file="api", tol=TOL_DECIDE,
         port=lambda m, i, s=_shape: _thresholds(m, i, s))
case(name="thresholds f32", file="api", dtype="float32", tol=TOL_F32,
     port=lambda m, i: _thresholds(m, i, (2, 3, 16)))


def _converters(m, i, shape):
    z = np.random.default_rng([7, *shape]).standard_normal(shape) * (1 + 1j)
    x = m.complex_to_interleaved(z)
    return {"interleaved": x, "complex": m.interleaved_to_complex(x),
            "from arrays": m.interleaved_to_complex(m.complex_to_interleaved(i.put(z)))}


for _shape in ((1,), (5,), (2, 8)):
    case(name=f"interleaved converters {_shape_id(_shape)}", file="api",
         port=lambda m, i, s=_shape: _converters(m, i, s))
case(name="fwt_max_level", file="api",
     port=lambda m, i: [m.fwt_max_level(n) for n in (1, 2, 4, 64, 1024)])


RESULT_TYPES = ("CWTResult", "SSQResult", "ScatteringResult", "Scattering2DResult", "VMDResult",
                "MPResult", "GaborDictionary", "DTCWTResult", "DTCWT2DResult", "EWTResult",
                "BestBasis", "BestBasis2D", "SlidingState", "FilterBank", "LiftingScheme")
EXCEPTIONS = ("JWaveException", "JWaveError", "JWaveFailure", "JWaveNotAllocated", "JWaveNotFound",
              "JWaveNotImplemented", "JWaveNotKnown", "JWaveNotValid")
CWAVELET_CLASSES = (("MorletWavelet", (1.5, 0.8)), ("MexicanHatWavelet", (2.0,)),
                    ("PaulWavelet", (2,)), ("DOGWavelet", (4, 1.5)), ("MeyerWavelet", ()),
                    ("MorseWavelet", (10.0, 2.0)))


def _fields(cls) -> tuple:
    return tuple(f.name for f in dataclasses.fields(cls)) if dataclasses.is_dataclass(cls) else ()


case(name="result types", file="api",
     port=lambda m, i: {n: _fields(getattr(m, n)) for n in RESULT_TYPES})
case(name="exception classes", file="api",
     port=lambda m, i: {n: [c.__name__ for c in getattr(m, n).__mro__] for n in EXCEPTIONS})
case(name="cwavelet classes", file="api",
     port=lambda m, i: {n: getattr(m, n)(*a) for n, a in CWAVELET_CLASSES})

#: the public names the cases reach as ``getattr(m, name)``, not as
#: ``m.<name>``: each tuple above is the one place its names are listed
#: (the coverage guard of tests/test_torch_census_api.py reads them here)
BY_NAME = (*(n for n, _ in FACADE_CLASSES), *COMPRESSORS, *(n for n, _ in CONTAINERS),
           *RESULT_TYPES, *EXCEPTIONS, *(n for n, _ in CWAVELET_CLASSES))


# --------------------------------------------------------------------------
# 7. the card's own: the kernels' eligibility edges, through the public
#    names (chip_smoke.py runs these on the card in float32, bf16 and f16,
#    against the port's CPU float64 run; tests/test_torch_census_card_<k>.py
#    hold them against JAX in float64 and tests/test_torch_census_api.py
#    runs the card's comparison on the CPU's plain versions)
# --------------------------------------------------------------------------

HALF = ("float32", "bfloat16", "float16")
#: K1/K2 store float32 or bf16; JAX's MODWT takes no f16 where it runs no
#: kernel (its FFT route refuses half input on the CPU), and neither does
#: the port
MODWT_HALF = ("float32", "bfloat16")


def _round_trip(m, i, shape, bank, level):
    c = m.modwt(i.x(*shape), bank, level)
    return {"modwt": c, "imodwt": m.imodwt(c, bank)}


# levels 0 (raises) and 1; deep enough that K1/K2 split their levels into
# groups (db4 L10 at 1024: two groups forward, three back) and run some
# unstaged (db4 L11 at 3000, sym8 L12 at 4100); lengths that are not a
# multiple of the 2048-sample tile; batches of 1 and odd
case(name="card modwt 3x64 Daubechies 4 L0", file="card_1", card_dtypes=MODWT_HALF,
     port=lambda m, i: _round_trip(m, i, (3, 64), "Daubechies 4", 0))
for _shape, _bank, _level in (((1, 64), "Haar", 1),
                              ((1, 1024), "Daubechies 4", 10), ((3, 3000), "Daubechies 4", 11),
                              ((1, 4100), "Symlet 8", 12), ((5, 2049), "Daubechies 4", 5),
                              ((3, 100), "Coiflet 2", 6), ((2, 3, 4097), "Haar", 3)):
    case(name=f"card modwt {_shape_id(_shape)} {_bank} L{_level}", file="card_1", kernel="K1",
         card_dtypes=MODWT_HALF,
         port=lambda m, i, s=_shape, b=_bank, lv=_level: _round_trip(m, i, s, b, lv))


def _unaligned(i, rows, n):
    """(rows, n) rows that start 4 bytes past the 16-byte alignment of the
    tensor they are cut from (a contiguous view, as a slice of a larger
    signal gives)."""
    return i.x(rows * n + 1)[1:].reshape(rows, n)


def _fwt_levels(m, i, x, bank):
    n = x.shape[-1]
    out = {}
    for lv in range(int(np.log2(n)) + 1):
        y = i.jit(lambda v: m.fwt(v, bank, lv))(x)
        out[f"fwt {lv}"], out[f"ifwt {lv}"] = y, i.jit(lambda v: m.ifwt(v, bank, lv))(y)
    return out


for _n in (1, 2, 4):
    case(name=f"card fwt N{_n} every level", file="card_1", kernel="K3" if _n > 1 else None,
         card_dtypes=HALF, half_tol=CARD_TOL_HALF_LEVELS,
         port=lambda m, i, n=_n: _fwt_levels(m, i, i.x(3, n), "Daubechies 4"))
case(name="card fwt unaligned source", file="card_1", kernel="K3", card_dtypes=HALF,
     half_tol=CARD_TOL_HALF_LEVELS,
     port=lambda m, i: _fwt_levels(m, i, _unaligned(i, 3, 64), "Daubechies 4"))
case(name="card fwt unaligned long rows", file="card_1", kernel="K3",
     port=lambda m, i: i.jit(lambda v: m.fwt(v, "Symlet 8"))(_unaligned(i, 2, 16384)))


def _ifwt_levels(m, i, x, bank, levels):
    return {f"ifwt {lv}": i.jit(lambda v: m.ifwt(v, bank, lv))(x) for lv in levels}


# K7 (ifwt on the card): levels 0 (no launch) and 1 on rows of 1, 2 and 4
# samples (several whole rows an item, every cone its whole head); an odd
# batch; Haar orthogonal's gain at full depth; Battle 23 stopping at its
# transform wavelength (levels 2 and 6 of 64 samples do 2 and 4); items of
# whole rows that the batch does not fill (3 rows of 256 at full depth, 1000
# rows of 16); a source off 16-byte alignment
for _n in (1, 2, 4):
    case(name=f"card ifwt N{_n} levels 0 and 1", file="card_2", kernel="K7" if _n > 1 else None,
         card_dtypes=HALF, half_tol=CARD_TOL_HALF_LEVELS,
         port=lambda m, i, n=_n: _ifwt_levels(m, i, i.x(3, n), "Daubechies 4",
                                              (0, 1) if n > 1 else (0,)))
for _name, _shape, _bank, _levels in (("odd batch", (5, 64), "Daubechies 4", (3,)),
                                      ("Haar orthogonal", (3, 256), "Haar orthogonal", (8,)),
                                      ("Battle 23 partial levels", (3, 64), "Battle 23", (2, 6)),
                                      ("3x256 full depth", (3, 256), "Daubechies 4", (8,)),
                                      ("1000x16", (1000, 16), "Daubechies 4", (4,))):
    case(name=f"card ifwt {_name}", file="card_2", kernel="K7", card_dtypes=HALF,
         half_tol=CARD_TOL_HALF_LEVELS,
         port=lambda m, i, s=_shape, b=_bank, lv=_levels: _ifwt_levels(m, i, i.x(*s), b, lv))
case(name="card ifwt unaligned source", file="card_2", kernel="K7",
     port=lambda m, i: _ifwt_levels(m, i, _unaligned(i, 3, 64), "Symlet 8", (6,)))


def _wpt_round(m, i, x, bank, level, layout="subband"):
    y = i.jit(lambda v: m.wpt(v, bank, level, layout=layout))(x)
    return {"wpt": y, "iwpt": i.jit(lambda v: m.iwpt(v, bank, level, layout=layout))(y)}


# K8 and K9 (wpt and iwpt on the card): whole rows shorter than the cone (16
# samples at L4: 105 taps mod 16), full depth (chunks (512, 6) and (8, 3)),
# 62 taps (chunks of 3 levels), Haar orthogonal's gain, a source off 16-byte
# alignment, the interleaved layout (JAX's tile path: its dial on), odd
# batches; one level stays on the butterflies (no launch)
for _name, _shape, _bank, _level in (("5x16 L4 (105 taps mod 16)", (5, 16), "Daubechies 4", 4),
                                     ("3x512 full depth", (3, 512), "Daubechies 4", None),
                                     ("62 taps 3x256 full depth", (3, 256), "Discrete Meyer",
                                      None),
                                     ("Haar orthogonal 3x256 L6", (3, 256), "Haar orthogonal", 6)):
    case(name=f"card wpt {_name}", file="card_1", kernel="K8",
         port=lambda m, i, s=_shape, b=_bank, lv=_level: _wpt_round(m, i, i.x(*s), b, lv))
case(name="card wpt unaligned source", file="card_1", kernel="K8",
     port=lambda m, i: _wpt_round(m, i, _unaligned(i, 3, 256), "Daubechies 4", 6))
case(name="card wpt interleaved 2x256 L3", file="card_1", kernel="K8",
     port=lambda m, i: _with_dial(m, i, "on", lambda: _wpt_round(
         m, i, i.x(2, 256), "Daubechies 2", 3, "interleaved")))
case(name="card wpt one level (the butterfly)", file="card_1",
     port=lambda m, i: _wpt_round(m, i, i.x(3, 64), "Daubechies 4", 1))
for _name, _shape, _bank, _level in (("1001x16 L4 (odd batch of whole rows)", (1001, 16),
                                      "Daubechies 4", 4),
                                     ("3x4096 Haar L6", (3, 4096), "Haar", 6)):
    case(name=f"card iwpt {_name}", file="card_1", kernel="K9",
         port=lambda m, i, s=_shape, b=_bank, lv=_level:
         i.jit(lambda v: m.iwpt(v, b, lv))(i.x(*s)))


def _image(i, rows, cols, transposed):
    return i.x(cols, rows).T if transposed else i.x(rows, cols)


def _fwt2d_edge(m, i, rows, cols, transposed, bank):
    x = _image(i, rows, cols, transposed)
    y = i.jit(lambda v: m.fwt2d(v, bank))(x)
    return {"fwt2d": y, "ifwt2d": i.jit(lambda v: m.ifwt2d(v, bank))(y),
            "ifwt2d of input": i.jit(lambda v: m.ifwt2d(v, bank, 2, 1))(x)}


for _rows, _cols, _t in ((16, 64, False), (64, 16, False), (2, 512, False), (32, 32, True),
                        (16, 128, True)):
    for _bank in ("Daubechies 4", "Haar orthogonal"):
        case(name=f"card fwt2d {_rows}x{_cols} transposed={_t} {_bank}", file="card_2",
             kernel="K4", card_dtypes=HALF, half_tol=CARD_TOL_HALF_LEVELS,
             port=lambda m, i, r=_rows, c=_cols, t=_t, b=_bank: _fwt2d_edge(m, i, r, c, t, b))


def _ssq_edge(m, i, freqs, out_of_range):
    r = i.jit(lambda v: m.ssq_cwt(v, m.generate_log_scales(0.01, 0.5, 24), "morlet", 100.0,
                                  frequencies=freqs, gamma=1e-3, out_of_range=out_of_range))(
        _tone(m, i, (2,)))
    return {"Tx": r.Tx, "frequencies": r.frequencies}


# the bins span 10-14 Hz: the 30 Hz tone and most of the plane fall outside
for _oor in ("drop", "clip"):
    case(name=f"card ssq_cwt bins outside [0, K) {_oor}", file="card_1", kernel="K6",
         card_dtypes=HALF, tol=TOL_DECIDE,
         port=lambda m, i, o=_oor: _ssq_edge(m, i, np.linspace(10.0, 14.0, 9), o))


def _tensor_parameters(m, i):
    """Scales and frequencies given as arrays of the signal's kind: on the
    card, CUDA tensors, as JAX code passes jax arrays (on the CPU the
    port's tensors and numpy arrays are one case)."""
    x, s = i.x(2, 64), i.put(m.generate_log_scales(0.05, 2.0, 6))
    f, fs = i.put(np.linspace(0.5, 4.0, 8)), i.put(np.linspace(1.0, 4.0, 4))
    return {"cwt": i.jit(lambda v: m.cwt(v, s, "morlet", 10.0))(x),
            "direct": m.cwt_direct(x, s, "morlet", 10.0),
            "chunked": i.jit(lambda v: m.cwt_chunked(v, s, "morlet", 10.0, scale_chunk=4))(x),
            "xwt": i.jit(lambda u, v: m.xwt(u, v, s, "morlet", 10.0))(x, i.x(2, 64, seed=1)),
            "ssq": i.jit(lambda v: m.ssq_cwt(v, s, "morlet", 10.0, frequencies=f, gamma=1e-4))(x),
            "superlet": i.jit(lambda v: m.superlet(v, fs, 10.0, 3.0, 1, 3))(x)}


case(name="card cwt family tensor parameters", file="card_2", tol=TOL_DECIDE,
     port=_tensor_parameters)
