"""The cases of tests/test_torch_parallel.py (not a test module).

Each case names its inputs (made from a seed with numpy, so that a spawned
rank and the test process build the same arrays), the port's sharded call,
the JAX package's sharded call on a mesh of the same size, the port's
single-device counterpart and the identities that hold. The port side runs
in every rank of a gloo world (tests/torch_parallel_child.py); the JAX side
and the single-device side run in the test process. Inputs mirror
tests/test_parallel.py (``default_rng(42)`` per test) and
``__graft_entry__.dryrun_multichip`` (one ``default_rng(0)`` stream).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

MESH_2D = {2: (1, 2), 4: (2, 2), 8: (4, 2)}


@dataclass
class Case:
    name: str
    worlds: tuple
    inputs: Callable  # D -> dict of numpy arrays
    port: Callable  # (P, jt, meshes, inp) -> dict name -> result
    jax: Callable | None = None  # (jp, jw, meshes, inp) -> dict name -> result
    single: Callable | None = None  # (jt, inp) -> dict name -> result (port, one device)
    identity: tuple = ()  # (output key, input key, atol): output == input
    tol: float = 1e-10  # absolute, as in the JAX tests
    tol_single: float | None = None  # against the port's single device; 0 = bit-exact
    raises: bool = False
    relative: bool = False  # tol scales with max|ref| (the FFTs), as in the JAX tests
    layout: Callable | None = None  # (outputs) -> dict of facts about the DTensor layout
    facts: dict = field(default_factory=dict)  # what ``layout`` must give


def _r42():
    return np.random.default_rng(42)


def _facade(jt, name, wavelet):
    return jt.TransformBuilder.create(name, wavelet, device="cpu")


def _t(x):
    import torch

    return torch.as_tensor(x)


CASES: list[Case] = []


def case(**kw):
    CASES.append(Case(**kw))


# --------------------------------------------------------------------------
# tests/test_parallel.py, on its 8-rank mesh ("shard") and its (4, 2) mesh
# --------------------------------------------------------------------------

case(name="batch_sharded_wpt", worlds=(8,),
     inputs=lambda d: {"xs": _r42().standard_normal((16, 256))},
     port=lambda P, jt, m, i: {"y": P.batch_sharded(lambda b: jt.wpt(b, "db4", 4), m["1d"])(i["xs"])},
     jax=lambda jp, jw, m, i: {"y": jp.batch_sharded(lambda b: jw.wpt(b, "db4", 4), m["1d"])(i["xs"])},
     single=lambda jt, i: {"y": jt.wpt(_t(i["xs"]), "db4", 4)}, tol=1e-12)


def _sig512(d):
    return {"sig": _r42().standard_normal(512)}


case(name="cwt_scale_sharded_matches_single", worlds=(8,), inputs=_sig512,
     port=lambda P, jt, m, i: {"c": P.cwt_scale_sharded(
         i["sig"], jt.generate_log_scales(0.5, 32.0, 16), "morlet", m["1d"], 5.0).coefficients},
     jax=lambda jp, jw, m, i: {"c": jp.cwt_scale_sharded(
         i["sig"], jw.generate_log_scales(0.5, 32.0, 16), "morlet", m["1d"], 5.0).coefficients},
     single=lambda jt, i: {"c": jt.cwt(_t(i["sig"]), jt.generate_log_scales(0.5, 32.0, 16),
                                       "morlet", 5.0).coefficients},
     layout=lambda o: {"local_shape": tuple(o["c"].to_local().shape)},
     facts={"local_shape": (2, 512)})

case(name="cwt_scale_sharded_batched", worlds=(8,),
     inputs=lambda d: {"sigs": _r42().standard_normal((3, 256))},
     port=lambda P, jt, m, i: {"c": P.cwt_scale_sharded(
         i["sigs"], jt.generate_linear_scales(1.0, 8.0, 8), "mexican hat", m["1d"]).coefficients},
     jax=lambda jp, jw, m, i: {"c": jp.cwt_scale_sharded(
         i["sigs"], jw.generate_linear_scales(1.0, 8.0, 8), "mexican hat", m["1d"]).coefficients},
     single=lambda jt, i: {"c": jt.cwt(_t(i["sigs"]), jt.generate_linear_scales(1.0, 8.0, 8),
                                       "mexican hat").coefficients})

case(name="cwt_scale_sharded_uneven_raises", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.cwt_scale_sharded(np.zeros(64), [1.0, 2.0, 3.0], "morlet", m["1d"]),
     jax=lambda jp, jw, m, i: jp.cwt_scale_sharded(np.zeros(64), [1.0, 2.0, 3.0], "morlet", m["1d"]))


def _ssq_inputs(d):
    fs, n = 100.0, 512
    t = np.arange(n) / fs
    sig = np.cos(2 * np.pi * 12.0 * t) + 0.5 * np.cos(2 * np.pi * 30.0 * t)
    return {"sig": sig, "sigs": np.stack([sig, sig[::-1]])}


def _ssq_scales(mod):
    return mod.generate_log_scales(0.02, 0.5, 32)


case(name="ssq_scale_sharded_matches_single", worlds=(8,), inputs=_ssq_inputs,
     port=lambda P, jt, m, i: {
         "tx": P.ssq_scale_sharded(i["sig"], _ssq_scales(jt), "morlet", m["1d"], 100.0).Tx,
         "f": P.ssq_scale_sharded(i["sig"], _ssq_scales(jt), "morlet", m["1d"], 100.0).frequencies,
         "tx_drop": P.ssq_scale_sharded(i["sigs"], _ssq_scales(jt), "morlet", m["1d"], 100.0,
                                        frequencies=24, out_of_range="drop").Tx},
     jax=lambda jp, jw, m, i: {
         "tx": jp.ssq_scale_sharded(i["sig"], _ssq_scales(jw), "morlet", m["1d"], 100.0).Tx,
         "f": jp.ssq_scale_sharded(i["sig"], _ssq_scales(jw), "morlet", m["1d"], 100.0).frequencies,
         "tx_drop": jp.ssq_scale_sharded(i["sigs"], _ssq_scales(jw), "morlet", m["1d"], 100.0,
                                         frequencies=24, out_of_range="drop").Tx},
     single=lambda jt, i: {
         "tx": jt.ssq_cwt(_t(i["sig"]), _ssq_scales(jt), "morlet", 100.0).Tx,
         "f": jt.ssq_cwt(_t(i["sig"]), _ssq_scales(jt), "morlet", 100.0).frequencies,
         "tx_drop": jt.ssq_cwt(_t(i["sigs"]), _ssq_scales(jt), "morlet", 100.0, frequencies=24,
                               out_of_range="drop").Tx})

case(name="ssq_scale_sharded_guards_uneven", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.ssq_scale_sharded(np.zeros(64), [1.0, 2.0, 3.0], "morlet", m["1d"]),
     jax=lambda jp, jw, m, i: jp.ssq_scale_sharded(np.zeros(64), [1.0, 2.0, 3.0], "morlet", m["1d"]))
case(name="ssq_scale_sharded_guards_not_analytic", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.ssq_scale_sharded(np.zeros(64), np.linspace(1, 8, 8),
                                                  "mexican hat", m["1d"]),
     jax=lambda jp, jw, m, i: jp.ssq_scale_sharded(np.zeros(64), np.linspace(1, 8, 8),
                                                   "mexican hat", m["1d"]))

case(name="fwt2d_sharded_matches_single", worlds=(8,),
     inputs=lambda d: {"mat": _r42().standard_normal((64, 128))},
     port=lambda P, jt, m, i: {"y": P.fwt2d_sharded(i["mat"], "db2", m["1d"])},
     jax=lambda jp, jw, m, i: {"y": jp.fwt2d_sharded(i["mat"], "db2", m["1d"])},
     single=lambda jt, i: {"y": _facade(jt, "Fast Wavelet Transform", "db2").forward(i["mat"])},
     layout=lambda o: {"local_shape": tuple(o["y"].to_local().shape),
                       "placements": str(o["y"].placements)},
     facts={"local_shape": (8, 128), "placements": "(Shard(dim=0),)"})


def _fwt2d_roundtrip(P, m, i):
    y = P.fwt2d_sharded(i["mat"], "sym4", m["1d"])
    return {"y": y, "back": P.ifwt2d_sharded(y, "sym4", m["1d"])}


case(name="fwt2d_sharded_roundtrip", worlds=(8,),
     inputs=lambda d: {"mat": _r42().standard_normal((64, 64))},
     port=lambda P, jt, m, i: _fwt2d_roundtrip(P, m, i),
     jax=lambda jp, jw, m, i: _fwt2d_roundtrip(jp, m, i),
     single=lambda jt, i: {"y": jt.fwt2d(_t(i["mat"]), "sym4")},
     identity=(("back", "mat", 1e-8),))

case(name="fwt2d_sharded_levels", worlds=(8,),
     inputs=lambda d: {"mat": _r42().standard_normal((32, 64))},
     port=lambda P, jt, m, i: {"y": P.fwt2d_sharded(i["mat"], "Haar", m["1d"], level_rows=2,
                                                    level_cols=3)},
     jax=lambda jp, jw, m, i: {"y": jp.fwt2d_sharded(i["mat"], "Haar", m["1d"], level_rows=2,
                                                     level_cols=3)},
     single=lambda jt, i: {"y": _facade(jt, "Fast Wavelet Transform", "Haar").forward(i["mat"], 2, 3)},
     tol=1e-12)

case(name="wpt2d_sharded_matches_single", worlds=(8,),
     inputs=lambda d: {"mat": _r42().standard_normal((64, 64))},
     port=lambda P, jt, m, i: {"y": P.wpt2d_sharded(i["mat"], "db2", m["1d"])},
     jax=lambda jp, jw, m, i: {"y": jp.wpt2d_sharded(i["mat"], "db2", m["1d"])},
     single=lambda jt, i: {"y": _facade(jt, "Wavelet Packet Transform", "db2").forward(i["mat"])})

case(name="2d_sharded_uneven_raises", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.fwt2d_sharded(np.zeros((30, 64)), "Haar", m["1d"]),
     jax=lambda jp, jw, m, i: jp.fwt2d_sharded(np.zeros((30, 64)), "Haar", m["1d"]))
case(name="2d_sharded_not_pow2_raises", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.fwt2d_sharded(np.zeros((48, 64)), "Haar", m["1d"]),
     jax=lambda jp, jw, m, i: jp.fwt2d_sharded(np.zeros((48, 64)), "Haar", m["1d"]))

case(name="modwt_halo_sharded_matches_single", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal(1024)},
     port=lambda P, jt, m, i: {"c": P.modwt_halo_sharded(i["x"], "db4", 3, m["1d"])},
     jax=lambda jp, jw, m, i: {"c": jp.modwt_halo_sharded(i["x"], "db4", 3, m["1d"])},
     single=lambda jt, i: {"c": jt.modwt(_t(i["x"]), "db4", 3)})


def _modwt_halo_roundtrip(P, m, x, wavelet, level):
    c = P.modwt_halo_sharded(x, wavelet, level, m["1d"])
    return {"c": c, "back": P.imodwt_halo_sharded(c, wavelet, m["1d"])}


case(name="modwt_halo_sharded_roundtrip", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal(512)},
     port=lambda P, jt, m, i: _modwt_halo_roundtrip(P, m, i["x"], "Haar", 2),
     jax=lambda jp, jw, m, i: _modwt_halo_roundtrip(jp, m, i["x"], "Haar", 2),
     single=lambda jt, i: {"c": jt.modwt(_t(i["x"]), "Haar", 2)},
     identity=(("back", "x", 1e-8),))

case(name="modwt_halo_level_too_deep_raises", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.modwt_halo_sharded(np.zeros(64), "db20", 5, m["1d"]),
     jax=lambda jp, jw, m, i: jp.modwt_halo_sharded(np.zeros(64), "db20", 5, m["1d"]))

_HALO = [("Haar", None, 10), ("db4", 4, 4), ("sym8", 3, 3)]
case(name="fwt_halo_sharded_matches_single", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal(1024)},
     port=lambda P, jt, m, i: {w: P.gather_pyramid(P.fwt_halo_sharded(i["x"], w, m["1d"], lv), w, le, 8)
                               for w, lv, le in _HALO},
     jax=lambda jp, jw, m, i: {w: jp.gather_pyramid(jp.fwt_halo_sharded(i["x"], w, m["1d"], lv), w, le, 8)
                               for w, lv, le in _HALO},
     single=lambda jt, i: {w: jt.fwt(_t(i["x"]), w, lv) for w, lv, _ in _HALO},
     tol=1e-12, tol_single=0.0)

case(name="fwt_halo_sharded_validates_length", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.fwt_halo_sharded(np.zeros(1000), "Haar", m["1d"]),
     jax=lambda jp, jw, m, i: jp.fwt_halo_sharded(np.zeros(1000), "Haar", m["1d"]))
case(name="fwt_halo_sharded_validates_1d", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.fwt_halo_sharded(np.zeros((4, 256)), "Haar", m["1d"]),
     jax=lambda jp, jw, m, i: jp.fwt_halo_sharded(np.zeros((4, 256)), "Haar", m["1d"]))

case(name="cwt_2d_mesh_batch_scale", worlds=(8,),
     inputs=lambda d: {"sigs": _r42().standard_normal((8, 256))},
     port=lambda P, jt, m, i: {"c": P.cwt_batch_scale_sharded(
         i["sigs"], jt.generate_log_scales(1.0, 16.0, 6), "morlet", m["bs"], 2.0).coefficients},
     jax=lambda jp, jw, m, i: {"c": jp.cwt_batch_scale_sharded(
         i["sigs"], jw.generate_log_scales(1.0, 16.0, 6), "morlet", m["bs"], 2.0).coefficients},
     single=lambda jt, i: {"c": jt.cwt(_t(i["sigs"]), jt.generate_log_scales(1.0, 16.0, 6),
                                       "morlet", 2.0).coefficients},
     layout=lambda o: {"local_shape": tuple(o["c"].to_local().shape),
                       "placements": str(o["c"].placements)},
     facts={"local_shape": (2, 3, 256), "placements": "(Shard(dim=0), Shard(dim=1))"})

case(name="cwt_2d_mesh_validates_batch", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.cwt_batch_scale_sharded(np.zeros((7, 64)), [1.0, 2.0], "morlet", m["bs"]),
     jax=lambda jp, jw, m, i: jp.cwt_batch_scale_sharded(np.zeros((7, 64)), [1.0, 2.0], "morlet", m["bs"]))
case(name="cwt_2d_mesh_validates_1d_mesh", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.cwt_batch_scale_sharded(np.zeros((8, 64)), [1.0, 2.0], "morlet", m["1d"]),
     jax=lambda jp, jw, m, i: jp.cwt_batch_scale_sharded(np.zeros((8, 64)), [1.0, 2.0], "morlet", m["1d"]))

case(name="fwt_halo_sharded_wide_filter_tail", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal(512)},
     port=lambda P, jt, m, i: {"y": P.gather_pyramid(P.fwt_halo_sharded(i["x"], "db20", m["1d"], 4),
                                                     "db20", 4, 8)},
     jax=lambda jp, jw, m, i: {"y": jp.gather_pyramid(jp.fwt_halo_sharded(i["x"], "db20", m["1d"], 4),
                                                      "db20", 4, 8)},
     single=lambda jt, i: {"y": jt.fwt(_t(i["x"]), "db20", 4)}, tol=1e-12, tol_single=0.0)


def _pfft_roundtrip(P, m, x):
    spec = P.pfft(x, m["1d"])
    return {"spec": spec, "back": P.pifft(spec, m["1d"])}


for _n in (64, 1536, 4096):
    case(name=f"pfft_matches_numpy_{_n}", worlds=(8,),
         inputs=lambda d, n=_n: {"x": _r42().standard_normal(n)},
         port=lambda P, jt, m, i: _pfft_roundtrip(P, m, i["x"]),
         jax=lambda jp, jw, m, i: _pfft_roundtrip(jp, m, i["x"]),
         single=lambda jt, i: {"spec": np.fft.fft(i["x"]).reshape(8, -1)},
         identity=(("back", "x", 1e-12),), tol=1e-9, relative=True)

case(name="pfft_complex_input", worlds=(8,),
     inputs=lambda d: {"z": (lambda r: r.standard_normal(512) + 1j * r.standard_normal(512))(_r42())},
     port=lambda P, jt, m, i: {"spec": P.pfft(i["z"], m["1d"])},
     jax=lambda jp, jw, m, i: {"spec": jp.pfft(i["z"], m["1d"])},
     single=lambda jt, i: {"spec": np.fft.fft(i["z"]).reshape(8, -1)})

case(name="pfft_geometry_validation_divide", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.pfft(np.zeros(100), m["1d"]),
     jax=lambda jp, jw, m, i: jp.pfft(np.zeros(100), m["1d"]))
case(name="pfft_geometry_validation_local", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.pfft(np.zeros(24), m["1d"]),
     jax=lambda jp, jw, m, i: jp.pfft(np.zeros(24), m["1d"]))


def _modwt_fft_single(jt, x, wavelet, level):
    return jt.modwt(_t(x), wavelet, level, method=jt.ConvolutionMethod.FFT)


case(name="modwt_fft_sharded_matches_single", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal(1024)},
     port=lambda P, jt, m, i: {"c": P.modwt_fft_sharded(i["x"], "db4", 4, m["1d"])},
     jax=lambda jp, jw, m, i: {"c": jp.modwt_fft_sharded(i["x"], "db4", 4, m["1d"])},
     single=lambda jt, i: {"c": _modwt_fft_single(jt, i["x"], "db4", 4)})

case(name="modwt_fft_sharded_deep_level_beyond_halo_cap", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal(1024)},
     port=lambda P, jt, m, i: {"c": P.modwt_fft_sharded(i["x"], "db4", 7, m["1d"])},
     jax=lambda jp, jw, m, i: {"c": jp.modwt_fft_sharded(i["x"], "db4", 7, m["1d"])},
     single=lambda jt, i: {"c": _modwt_fft_single(jt, i["x"], "db4", 7)}, tol=1e-9)
case(name="modwt_halo_beyond_cap_raises", worlds=(8,), raises=True,
     inputs=lambda d: {"x": _r42().standard_normal(1024)},
     port=lambda P, jt, m, i: P.modwt_halo_sharded(i["x"], "db4", 7, m["1d"]),
     jax=lambda jp, jw, m, i: jp.modwt_halo_sharded(i["x"], "db4", 7, m["1d"]))


def _modwt_fft_roundtrip(P, m, x, wavelet, level):
    c = P.modwt_fft_sharded(x, wavelet, level, m["1d"])
    return {"c": c, "back": P.imodwt_fft_sharded(c, wavelet, m["1d"])}


case(name="modwt_fft_sharded_roundtrip", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal(1536)},
     port=lambda P, jt, m, i: _modwt_fft_roundtrip(P, m, i["x"], "sym8", 3),
     jax=lambda jp, jw, m, i: _modwt_fft_roundtrip(jp, m, i["x"], "sym8", 3),
     single=lambda jt, i: {"c": _modwt_fft_single(jt, i["x"], "sym8", 3)},
     identity=(("back", "x", 1e-9),), tol=1e-9)

case(name="modwt_fft_sharded_stays_sharded", worlds=(8,),
     inputs=lambda d: {"x": np.linspace(-1, 1, 1024)},
     port=lambda P, jt, m, i: {"c": P.modwt_fft_sharded(i["x"], "haar", 5, m["1d"])},
     jax=lambda jp, jw, m, i: {"c": jp.modwt_fft_sharded(i["x"], "haar", 5, m["1d"])},
     single=lambda jt, i: {"c": _modwt_fft_single(jt, i["x"], "haar", 5)},
     layout=lambda o: {"local_shape": tuple(o["c"].to_local().shape),
                       "placements": str(o["c"].placements)},
     facts={"local_shape": (6, 128), "placements": "(Shard(dim=1),)"})

case(name="cwt_time_sharded_matches_single", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal(1024)},
     port=lambda P, jt, m, i: {"c": P.cwt_time_sharded(
         i["x"], jt.generate_log_scales(2.0, 64.0, 6), "morlet", m["1d"], 100.0).coefficients},
     jax=lambda jp, jw, m, i: {"c": jp.cwt_time_sharded(
         i["x"], jw.generate_log_scales(2.0, 64.0, 6), "morlet", m["1d"], 100.0).coefficients},
     single=lambda jt, i: {"c": jt.cwt(_t(i["x"]), jt.generate_log_scales(2.0, 64.0, 6),
                                       "morlet", 100.0).coefficients},
     layout=lambda o: {"local_shape": tuple(o["c"].to_local().shape)},
     facts={"local_shape": (6, 128)})

case(name="cwt_time_sharded_validates", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.cwt_time_sharded(np.zeros(1000), [1.0], "morlet", m["1d"]),
     jax=lambda jp, jw, m, i: jp.cwt_time_sharded(np.zeros(1000), [1.0], "morlet", m["1d"]))

case(name="fwt3d_sharded_matches_single", worlds=(8,),
     inputs=lambda d: {"vol": _r42().standard_normal((16, 32, 64))},
     port=lambda P, jt, m, i: {"y": P.fwt3d_sharded(i["vol"], "db2", m["1d"])},
     jax=lambda jp, jw, m, i: {"y": jp.fwt3d_sharded(i["vol"], "db2", m["1d"])},
     single=lambda jt, i: {"y": _facade(jt, "Fast Wavelet Transform", "db2").forward(i["vol"])})


def _fwt3d_roundtrip(P, m, vol):
    y = P.fwt3d_sharded(vol, "sym4", m["1d"])
    return {"y": y, "back": P.ifwt3d_sharded(y, "sym4", m["1d"])}


case(name="fwt3d_sharded_roundtrip", worlds=(8,),
     inputs=lambda d: {"vol": _r42().standard_normal((16, 16, 16))},
     port=lambda P, jt, m, i: _fwt3d_roundtrip(P, m, i["vol"]),
     jax=lambda jp, jw, m, i: _fwt3d_roundtrip(jp, m, i["vol"]),
     single=lambda jt, i: {"y": _facade(jt, "Fast Wavelet Transform", "sym4").forward(i["vol"])},
     identity=(("back", "vol", 1e-8),))

case(name="fwt3d_sharded_levels", worlds=(8,),
     inputs=lambda d: {"vol": _r42().standard_normal((16, 32, 16))},
     port=lambda P, jt, m, i: {"y": P.fwt3d_sharded(i["vol"], "Haar", m["1d"], level_p=1, level_q=2,
                                                    level_r=3)},
     jax=lambda jp, jw, m, i: {"y": jp.fwt3d_sharded(i["vol"], "Haar", m["1d"], level_p=1, level_q=2,
                                                     level_r=3)},
     single=lambda jt, i: {"y": _facade(jt, "Fast Wavelet Transform", "Haar").forward(i["vol"], 1, 2, 3)},
     tol=1e-12)


def _wpt3d_roundtrip(P, m, vol):
    y = P.wpt3d_sharded(vol, "db2", m["1d"], 2, 2, 2)
    return {"y": y, "back": P.iwpt3d_sharded(y, "db2", m["1d"], 2, 2, 2)}


case(name="wpt3d_sharded_matches_single", worlds=(8,),
     inputs=lambda d: {"vol": _r42().standard_normal((16, 16, 32))},
     port=lambda P, jt, m, i: _wpt3d_roundtrip(P, m, i["vol"]),
     jax=lambda jp, jw, m, i: _wpt3d_roundtrip(jp, m, i["vol"]),
     single=lambda jt, i: {"y": _facade(jt, "Wavelet Packet Transform", "db2").forward(i["vol"], 2, 2, 2)},
     identity=(("back", "vol", 1e-8),))

case(name="fwt3d_sharded_rejects_bad_tiling", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.fwt3d_sharded(np.zeros((12, 16, 16)), "Haar", m["1d"]),
     jax=lambda jp, jw, m, i: jp.fwt3d_sharded(np.zeros((12, 16, 16)), "Haar", m["1d"]))

_TILE = [("Haar", None, None, 6, 7), ("db2", 3, 4, 3, 4), ("sym4", 2, 2, 2, 2)]
for _w, _lr, _lc, _er, _ec in _TILE:
    case(name=f"fwt2d_tile_sharded_bitexact_{_w}", worlds=(8,),
         inputs=lambda d: {"mat": _r42().standard_normal((64, 128))},
         port=lambda P, jt, m, i, w=_w, lr=_lr, lc=_lc, er=_er, ec=_ec: {"y": P.gather_pyramid_2d(
             P.fwt2d_tile_sharded(i["mat"], w, m["rc"], lr, lc), w, er, ec, 4, 2)},
         jax=lambda jp, jw, m, i, w=_w, lr=_lr, lc=_lc, er=_er, ec=_ec: {"y": jp.gather_pyramid_2d(
             jp.fwt2d_tile_sharded(i["mat"], w, m["rc"], lr, lc), w, er, ec, 4, 2)},
         single=lambda jt, i, w=_w, er=_er, ec=_ec: {
             "y": _facade(jt, "Fast Wavelet Transform", w).forward(i["mat"], er, ec)},
         tol=1e-12, tol_single=0.0)

case(name="fwt2d_tile_sharded_deep_levels_tail", worlds=(8,),
     inputs=lambda d: {"mat": _r42().standard_normal((32, 32))},
     port=lambda P, jt, m, i: {"y": P.gather_pyramid_2d(P.fwt2d_tile_sharded(i["mat"], "db2", m["rc"], 5, 5),
                                                        "db2", 5, 5, 4, 2)},
     jax=lambda jp, jw, m, i: {"y": jp.gather_pyramid_2d(jp.fwt2d_tile_sharded(i["mat"], "db2", m["rc"], 5, 5),
                                                         "db2", 5, 5, 4, 2)},
     single=lambda jt, i: {"y": _facade(jt, "Fast Wavelet Transform", "db2").forward(i["mat"], 5, 5)},
     tol=1e-12, tol_single=0.0)

case(name="fwt2d_tile_sharded_rejects_not_pow2", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.fwt2d_tile_sharded(np.zeros((48, 64)), "Haar", m["rc"]),
     jax=lambda jp, jw, m, i: jp.fwt2d_tile_sharded(np.zeros((48, 64)), "Haar", m["rc"]))
case(name="fwt2d_tile_sharded_rejects_1d", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.fwt2d_tile_sharded(np.zeros(64), "Haar", m["rc"]),
     jax=lambda jp, jw, m, i: jp.fwt2d_tile_sharded(np.zeros(64), "Haar", m["rc"]))

case(name="pfft_batched_matches_numpy", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal((3, 512))},
     port=lambda P, jt, m, i: _pfft_roundtrip(P, m, i["x"]),
     jax=lambda jp, jw, m, i: _pfft_roundtrip(jp, m, i["x"]),
     single=lambda jt, i: {"spec": np.fft.fft(i["x"], axis=-1).reshape(3, 8, 64)},
     identity=(("back", "x", 1e-9),), tol=1e-9)


def _pfft2_roundtrip(P, m, x):
    spec = P.pfft2(x, m["1d"])
    return {"spec": spec, "back": P.pifft2(spec, m["1d"])}


case(name="pfft2_matches_numpy", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal((64, 128))},
     port=lambda P, jt, m, i: _pfft2_roundtrip(P, m, i["x"]),
     jax=lambda jp, jw, m, i: _pfft2_roundtrip(jp, m, i["x"]),
     single=lambda jt, i: {"spec": np.fft.fft2(i["x"])},
     identity=(("back", "x", 1e-9),), tol=1e-9)

case(name="pfft2_batched_nonpow2", worlds=(8,),
     inputs=lambda d: {"x": _r42().standard_normal((2, 32, 24))},
     port=lambda P, jt, m, i: {"spec": P.pfft2(i["x"], m["1d"])},
     jax=lambda jp, jw, m, i: {"spec": jp.pfft2(i["x"], m["1d"])},
     single=lambda jt, i: {"spec": np.fft.fft2(i["x"], axes=(-2, -1))}, tol=1e-8)

case(name="modwt2d_sharded_matches_single", worlds=(8,),
     inputs=lambda d: {"mat": _r42().standard_normal((32, 64))},
     port=lambda P, jt, m, i: {"g": P.modwt2d_sharded(i["mat"], "db2", 2, m["1d"])},
     jax=lambda jp, jw, m, i: {"g": jp.modwt2d_sharded(i["mat"], "db2", 2, m["1d"])},
     single=lambda jt, i: {"g": __import__("jwave_tpu_torch.transforms.modwt", fromlist=["x"])
                           .modwt_2d(_t(i["mat"]), "db2", 2)},
     layout=lambda o: {"shape": tuple(o["g"].shape)}, facts={"shape": (3, 3, 32, 64)})


def _modwt2d_roundtrip(P, m, mat, wavelet, level):
    g = P.modwt2d_sharded(mat, wavelet, level, m["1d"])
    return {"g": g, "back": P.imodwt2d_sharded(g, wavelet, m["1d"])}


case(name="modwt2d_sharded_roundtrip", worlds=(8,),
     inputs=lambda d: {"mat": _r42().standard_normal((32, 32))},
     port=lambda P, jt, m, i: _modwt2d_roundtrip(P, m, i["mat"], "sym4", 2),
     jax=lambda jp, jw, m, i: _modwt2d_roundtrip(jp, m, i["mat"], "sym4", 2),
     identity=(("back", "mat", 1e-8),))

case(name="pfft2_rejects_bad_geometry", worlds=(8,), raises=True, inputs=lambda d: {},
     port=lambda P, jt, m, i: P.pfft2(np.zeros((30, 64)), m["1d"]),
     jax=lambda jp, jw, m, i: jp.pfft2(np.zeros((30, 64)), m["1d"]))


# --------------------------------------------------------------------------
# __graft_entry__.dryrun_multichip, steps 1-8, at every world size
# --------------------------------------------------------------------------

def dryrun_inputs(n: int) -> dict:
    """The arrays dryrun_multichip(n) draws, in its order."""
    rng = np.random.default_rng(0)
    inp = {"xs": rng.standard_normal((2 * n, 64)), "sig": rng.standard_normal(128),
           "tone": np.cos(2 * np.pi * 12.0 * np.arange(128) / 100.0),
           "mat": rng.standard_normal((8 * n, 8 * n)),
           "vol": rng.standard_normal((2 * n, 2 * n, 8)), "x": rng.standard_normal(32 * n)}
    n_sig = 128 * n if (128 * n & (128 * n - 1)) == 0 else 1024
    inp["xh"] = rng.standard_normal(n_sig)
    inp["sigs2"] = rng.standard_normal((n, 64))
    inp["tile_mat"] = rng.standard_normal((64, 64))
    chunk = 64 * n
    inp["xd"] = rng.standard_normal(chunk * n)
    inp["sc_in"] = rng.standard_normal((n, 128))
    inp["xb2"] = rng.standard_normal((2, chunk * n))
    inp["m2"] = rng.standard_normal((4 * n, 4 * n))
    return inp


ALL = (2, 4, 8)


def _d(m):
    return m["n"]


def _n(i):
    """The world size a dryrun input set was drawn for."""
    return i["sc_in"].shape[0]


def _dry(name, **kw):
    case(name=f"dryrun_{name}", worlds=ALL, inputs=dryrun_inputs, **kw)


_dry("1_batch_wpt",
     port=lambda P, jt, m, i: {"y": P.batch_sharded(lambda b: jt.wpt(b, "db2", 3), m["1d"])(i["xs"])},
     jax=lambda jp, jw, m, i: {"y": jp.batch_sharded(lambda b: jw.wpt(b, "db2", 3), m["1d"])(i["xs"])},
     single=lambda jt, i: {"y": jt.wpt(_t(i["xs"]), "db2", 3)})
_dry("2_cwt_scale",
     port=lambda P, jt, m, i: {"c": P.cwt_scale_sharded(
         i["sig"], jt.generate_log_scales(0.5, 8.0, 2 * _d(m)), "morlet", m["1d"]).coefficients},
     jax=lambda jp, jw, m, i: {"c": jp.cwt_scale_sharded(
         i["sig"], jw.generate_log_scales(0.5, 8.0, 2 * _d(m)), "morlet", m["1d"]).coefficients},
     single=lambda jt, i: {"c": jt.cwt(_t(i["sig"]), jt.generate_log_scales(0.5, 8.0, 2 * _n(i)),
                                       "morlet").coefficients})
_dry("2b_ssq_scale",
     port=lambda P, jt, m, i: {"tx": P.ssq_scale_sharded(
         i["tone"], jt.generate_log_scales(0.02, 0.5, 2 * _d(m)), "morlet", m["1d"], 100.0).Tx},
     jax=lambda jp, jw, m, i: {"tx": jp.ssq_scale_sharded(
         i["tone"], jw.generate_log_scales(0.02, 0.5, 2 * _d(m)), "morlet", m["1d"], 100.0).Tx},
     single=lambda jt, i: {"tx": jt.ssq_cwt(_t(i["tone"]), jt.generate_log_scales(0.02, 0.5, 2 * _n(i)),
                                            "morlet", 100.0).Tx})


def _dry_2d(P, m, mat):
    y2 = P.fwt2d_sharded(mat, "Haar", m["1d"])
    return {"y": y2, "back": P.ifwt2d_sharded(y2, "Haar", m["1d"]),
            "wpt": P.wpt2d_sharded(mat, "Haar", m["1d"])}


_dry("3_fwt2d_wpt2d",
     port=lambda P, jt, m, i: _dry_2d(P, m, i["mat"]),
     jax=lambda jp, jw, m, i: _dry_2d(jp, m, i["mat"]),
     single=lambda jt, i: {"y": jt.fwt2d(_t(i["mat"]), "Haar"),
                           "wpt": _facade(jt, "Wavelet Packet Transform", "Haar").forward(i["mat"])},
     identity=(("back", "mat", 1e-10),))


def _dry_3d(P, m, vol):
    y3 = P.fwt3d_sharded(vol, "Haar", m["1d"])
    return {"y": y3, "back": P.ifwt3d_sharded(y3, "Haar", m["1d"])}


_dry("3b_fwt3d",
     port=lambda P, jt, m, i: _dry_3d(P, m, i["vol"]),
     jax=lambda jp, jw, m, i: _dry_3d(jp, m, i["vol"]),
     single=lambda jt, i: {"y": _facade(jt, "Fast Wavelet Transform", "Haar").forward(i["vol"])},
     identity=(("back", "vol", 1e-10),))
_dry("4_modwt_halo",
     port=lambda P, jt, m, i: _modwt_halo_roundtrip(P, m, i["x"], "Haar", 2),
     jax=lambda jp, jw, m, i: _modwt_halo_roundtrip(jp, m, i["x"], "Haar", 2),
     single=lambda jt, i: {"c": jt.modwt(_t(i["x"]), "Haar", 2)},
     identity=(("back", "x", 1e-10),))
_dry("5_fwt_halo",
     port=lambda P, jt, m, i: {"y": P.gather_pyramid(P.fwt_halo_sharded(i["xh"], "Haar", m["1d"], 3),
                                                     "Haar", 3, _d(m))},
     jax=lambda jp, jw, m, i: {"y": jp.gather_pyramid(jp.fwt_halo_sharded(i["xh"], "Haar", m["1d"], 3),
                                                      "Haar", 3, _d(m))},
     single=lambda jt, i: {"y": jt.fwt(_t(i["xh"]), "Haar", 3)}, tol_single=0.0)
_dry("6_cwt_batch_scale",
     port=lambda P, jt, m, i: {"c": P.cwt_batch_scale_sharded(
         i["sigs2"], jt.generate_linear_scales(1.0, 4.0, 4), "morlet", m["bs"]).coefficients},
     jax=lambda jp, jw, m, i: {"c": jp.cwt_batch_scale_sharded(
         i["sigs2"], jw.generate_linear_scales(1.0, 4.0, 4), "morlet", m["bs"]).coefficients},
     single=lambda jt, i: {"c": jt.cwt(_t(i["sigs2"]), jt.generate_linear_scales(1.0, 4.0, 4),
                                       "morlet").coefficients})
_dry("6_fwt2d_tile",
     port=lambda P, jt, m, i: {"y": P.gather_pyramid_2d(P.fwt2d_tile_sharded(i["tile_mat"], "Haar", m["bs"], 2, 2),
                                                        "Haar", 2, 2, _d(m) // 2, 2)},
     jax=lambda jp, jw, m, i: {"y": jp.gather_pyramid_2d(jp.fwt2d_tile_sharded(i["tile_mat"], "Haar", m["bs"], 2, 2),
                                                         "Haar", 2, 2, _d(m) // 2, 2)},
     single=lambda jt, i: {"y": jt.fwt2d(_t(i["tile_mat"]), "Haar", 2, 2)}, tol_single=0.0)
_dry("7_modwt_fft",
     port=lambda P, jt, m, i: _modwt_fft_roundtrip(P, m, i["xd"], "db4", 6),
     jax=lambda jp, jw, m, i: _modwt_fft_roundtrip(jp, m, i["xd"], "db4", 6),
     single=lambda jt, i: {"c": _modwt_fft_single(jt, i["xd"], "db4", 6)},
     identity=(("back", "xd", 1e-10),))
_dry("7_cwt_time",
     port=lambda P, jt, m, i: {"c": P.cwt_time_sharded(
         i["xd"], jt.generate_log_scales(1.0, 8.0, 4), "morlet", m["1d"]).coefficients},
     jax=lambda jp, jw, m, i: {"c": jp.cwt_time_sharded(
         i["xd"], jw.generate_log_scales(1.0, 8.0, 4), "morlet", m["1d"]).coefficients},
     single=lambda jt, i: {"c": jt.cwt(_t(i["xd"]), jt.generate_log_scales(1.0, 8.0, 4),
                                       "morlet").coefficients})
_dry("7b_batch_scattering",
     port=lambda P, jt, m, i: {"f": P.batch_sharded(
         lambda b: jt.scattering1d(b, J=4, Q=2).features(), m["1d"])(i["sc_in"])},
     single=lambda jt, i: {"f": jt.scattering1d(_t(i["sc_in"]), J=4, Q=2).features()})
_dry("7b_batch_dtcwt",
     port=lambda P, jt, m, i: {"back": P.batch_sharded(lambda b: jt.idtcwt(jt.dtcwt(b, 3)), m["1d"])(i["sc_in"])},
     identity=(("back", "sc_in", 1e-10),))


def _dry_8(P, m, i):
    s2 = P.pfft2(i["m2"], m["1d"])
    g2 = P.modwt2d_sharded(i["m2"], "Haar", 2, m["1d"])
    return {"spec": P.pfft(i["xb2"], m["1d"]), "spec2": s2, "back2": P.pifft2(s2, m["1d"]),
            "g2": g2, "back_g2": P.imodwt2d_sharded(g2, "Haar", m["1d"])}


_dry("8_pfft_pfft2_modwt2d",
     port=lambda P, jt, m, i: _dry_8(P, m, i),
     jax=lambda jp, jw, m, i: _dry_8(jp, m, i),
     single=lambda jt, i: {"spec": np.fft.fft(i["xb2"], axis=-1).reshape(2, _n(i), -1),
                           "spec2": np.fft.fft2(i["m2"])},
     identity=(("back2", "m2", 1e-10), ("back_g2", "m2", 1e-10)), relative=True)


# --------------------------------------------------------------------------
# the collective helpers against lax.all_to_all and ppermute
# --------------------------------------------------------------------------

_A2A = [(False, 0, 1), (False, 0, 2), (True, 2, 1), (True, 2, 2), (True, 1, 1)]


def _a2a_input(d):
    return {"x": np.arange(d * d * 4 * 2 * d, dtype=np.float64).reshape(d * d, 4, 2 * d)}


def _port_a2a(P, m, x, tiled, split, concat):
    from jwave_tpu_torch.parallel._collectives import all_to_all
    from jwave_tpu_torch.parallel._layout import global_input, local_block, sharded_output

    mesh = m["1d"]
    y = all_to_all(local_block(global_input(x, mesh), mesh, {"shard": 0}), mesh, "shard", split,
                   concat, tiled)
    return sharded_output(y, mesh, {"shard": 0}, (m["n"] * y.shape[0],) + tuple(y.shape[1:]))


def _jax_a2a(m, x, tiled, split, concat):
    from jax import lax
    from jax.sharding import PartitionSpec as Ps

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    f = shard_map(lambda b: lax.all_to_all(b, "shard", split, concat, tiled=tiled), mesh=m["1d"],
                  in_specs=Ps("shard"), out_specs=Ps("shard"))
    return f(x)


def _port_ring(P, m, x, offset):
    from jwave_tpu_torch.parallel._collectives import ring_shift
    from jwave_tpu_torch.parallel._layout import global_input, local_block, sharded_output

    mesh = m["1d"]
    y = ring_shift(local_block(global_input(x, mesh), mesh, {"shard": 0}), mesh, "shard", offset)
    return sharded_output(y, mesh, {"shard": 0}, x.shape)


def _jax_ring(m, x, offset):
    from jax import lax
    from jax.sharding import PartitionSpec as Ps

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    d = m["n"]
    perm = [(i, (i + offset) % d) for i in range(d)]
    return shard_map(lambda b: lax.ppermute(b, "shard", perm), mesh=m["1d"], in_specs=Ps("shard"),
                     out_specs=Ps("shard"))(x)


case(name="collective_all_to_all", worlds=(4,), inputs=_a2a_input,
     port=lambda P, jt, m, i: {f"{t}_{s}_{c}": _port_a2a(P, m, i["x"], t, s, c) for t, s, c in _A2A},
     jax=lambda jp, jw, m, i: {f"{t}_{s}_{c}": _jax_a2a(m, i["x"], t, s, c) for t, s, c in _A2A},
     tol=0.0)
case(name="collective_ring_shift", worlds=(2, 4),
     inputs=lambda d: {"x": np.arange(d * 3, dtype=np.float64) + 1j * np.arange(d * 3)},
     port=lambda P, jt, m, i: {f"{o}": _port_ring(P, m, i["x"], o) for o in (1, -1)},
     jax=lambda jp, jw, m, i: {f"{o}": _jax_ring(m, i["x"], o) for o in (1, -1)},
     tol=0.0)

# tests/multihost_child.py's two checks, in the 2-rank world
case(name="multihost_batch_wpt", worlds=(2,),
     inputs=lambda d: {"batch": np.random.default_rng(42).standard_normal((8, 256))},
     port=lambda P, jt, m, i: {"y": P.batch_sharded(lambda b: jt.wpt(b, "db2", 3), m["1d"])(i["batch"])},
     single=lambda jt, i: {"y": jt.wpt(_t(i["batch"]), "db2", 3)})
def _multihost_signal(d):
    rng = np.random.default_rng(42)  # the batch is drawn first, as tests/multihost_child.py does
    rng.standard_normal((8, 256))
    return {"sig": rng.standard_normal(2048)}


case(name="multihost_halo_modwt", worlds=(2,), inputs=_multihost_signal,
     port=lambda P, jt, m, i: {"c": P.modwt_halo_sharded(i["sig"], "db2", 3, m["1d"])},
     single=lambda jt, i: {"c": jt.modwt(_t(i["sig"]), "db2", 3)})


def cases_for(world: int) -> list[Case]:
    return [c for c in CASES if world in c.worlds]


# the collective audit of dryrun step 9 (MULTICHIP_r05.json, 8 devices)
AUDIT_COUNTS = {
    "fwt2d_all_to_all": {"all_to_all_single": 2},
    "modwt_halo": {"batch_isend_irecv": 2},
    "fwt_halo": {"batch_isend_irecv": 3},
    "modwt_fft_four_step": {"all_to_all_single": 4},
    "cwt_scale": {},
}


def audit_calls(P, jt, m, i):
    n = m["n"]
    return {
        "fwt2d_all_to_all": lambda: P.fwt2d_sharded(i["mat"], "Haar", m["1d"]),
        "modwt_halo": lambda: P.modwt_halo_sharded(i["x"], "Haar", 2, m["1d"]),
        "fwt_halo": lambda: P.fwt_halo_sharded(i["xh"], "db4", m["1d"], 3),
        "modwt_fft_four_step": lambda: P.modwt_fft_sharded(i["xd"], "db4", 6, m["1d"]),
        "cwt_scale": lambda: P.cwt_scale_sharded(
            i["sig"], jt.generate_log_scales(0.5, 8.0, 2 * n), "morlet", m["1d"]),
    }
