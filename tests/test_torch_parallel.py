"""jwave_tpu_torch.parallel (the sharded layer on torch.distributed) against
jwave_tpu.parallel on the CPU in float64.

Three gloo worlds, of 2, 4 and 8 ranks, are spawned once for the module
(tests/torch_parallel_child.py, one process a rank, each joining through
``initialize_distributed("127.0.0.1:<port>", world, rank)`` as separate
hosts would). Every rank runs every case of tests/torch_parallel_cases.py
for its world size; rank 0 writes each result's ``full_tensor()``. Each
case is then one test here, which holds the port's result against

  (a) the JAX package's sharded function on a mesh of as many of conftest's
      virtual CPU devices, at the JAX test's own tolerance (1e-10 unless it
      says otherwise; 1e-9 of max|ref| for the FFTs);
  (b) the port's single-device function: to the same tolerance, and
      bit-exactly where JAX holds its pair bit-exact (the halo FWT and the
      tile-sharded 2D FWT against ``fwt``/``fwt2d``);
  (c) the identities (round trips) at the JAX test's tolerance;

and a case that must raise holds every rank to the same JWaveFailure
message as JAX's. The cases mirror tests/test_parallel.py (8 ranks, the
(4, 2) mesh) and steps 1-8 of ``__graft_entry__.dryrun_multichip`` at every
world size; the collective audit of its step 9 is held to
MULTICHIP_r05.json's counts. Each world runs under a time limit and is
killed when it expires, so a hung collective fails the module, never hangs
it.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import jwave_tpu as jw  # noqa: E402
from jwave_tpu import parallel as jp  # noqa: E402
import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch import parallel as P  # noqa: E402

import torch_parallel_cases as cases  # noqa: E402

HERE = Path(__file__).parent
CHILD = HERE / "torch_parallel_child.py"
WORLDS = (2, 4, 8)
LIMIT_S = 240  # all three worlds together, on a loaded machine; they take ~15 s alone


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    def __init__(self, size, out, procs):
        self.size, self.out, self.procs = size, out, procs
        self.logs, self.expired = {}, False

    def ok(self):
        """Every rank ended with 0 and wrote its report."""
        assert not self.expired, f"the {self.size}-rank world ran past {LIMIT_S} s and was killed"
        for r, p in enumerate(self.procs):
            tail = "\n".join(self.logs.get(r, "").splitlines()[-25:])
            assert p.returncode == 0, f"rank {r} of {self.size} failed:\n{tail}"

    def report(self, rank):
        return json.loads((self.out / f"w{self.size}_r{rank}.json").read_text())

    def arrays(self):
        with np.load(self.out / f"w{self.size}.npz") as z:
            return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("worlds")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    started = {}
    for size in WORLDS:
        port = _free_port()
        started[size] = World(size, out, [
            subprocess.Popen([sys.executable, str(CHILD), str(r), str(size), str(port), str(out)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(size)])
    deadline = time.monotonic() + LIMIT_S
    try:
        for w in started.values():
            for r, p in enumerate(w.procs):
                try:
                    w.logs[r], _ = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    w.expired = True
                    for q in w.procs:
                        q.kill()
                    for q in w.procs:
                        q.communicate()
                    break
    finally:
        for w in started.values():
            for q in w.procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
    return started


_JAX_MESHES = {}


def jax_meshes(d):
    """The JAX meshes of a d-rank world, over the first d virtual devices."""
    if d not in _JAX_MESHES:
        devs = np.asarray(jax.devices()[:d])
        shape2d = cases.MESH_2D[d]
        _JAX_MESHES[d] = {"n": d, "1d": Mesh(devs, ("shard",)),
                          "bs": Mesh(devs.reshape(shape2d), ("batch", "scale")),
                          "rc": Mesh(devs.reshape(shape2d), ("mrow", "mcol"))}
    return _JAX_MESHES[d]


def _np(x):
    for attr in ("coefficients", "Tx"):
        x = getattr(x, attr, x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol, what, relative=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    bound = tol * max(1.0, float(np.abs(want).max())) if relative else tol
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= bound, f"{what}: max|err| {err:.3e} > {bound:.1e}"


PAIRS = [pytest.param(c, d, id=f"{c.name}-{d}ranks") for c in cases.CASES for d in c.worlds]


@pytest.mark.parametrize("c, d", PAIRS)
def test_case(worlds, c, d):
    world = worlds[d]
    world.ok()
    inp = c.inputs(d)
    if c.raises:
        msgs = {world.report(r)["errors"][c.name] for r in range(d)}
        assert len(msgs) == 1, f"the ranks raised different errors: {msgs}"
        msg = msgs.pop()
        assert msg is not None, "the port raised no JWaveFailure"
        with pytest.raises(jw.JWaveFailure) as e:
            c.jax(jp, jw, jax_meshes(d), inp)
        assert msg == str(e.value)
        return
    arrays = world.arrays()
    got = {k.split("/", 1)[1]: v for k, v in arrays.items() if k.split("/", 1)[0] == c.name}
    assert got, "the world wrote no result for this case"
    if c.jax is not None:
        for key, want in c.jax(jp, jw, jax_meshes(d), inp).items():
            _close(got[key], want, c.tol, f"{key} against JAX's sharded function", c.relative)
    if c.single is not None:
        tol = c.tol if c.tol_single is None else c.tol_single
        for key, want in c.single(jt, inp).items():
            _close(got[key], want, tol, f"{key} against the port's single device", c.relative)
    for key, ikey, atol in c.identity:
        _close(got[key], inp[ikey], atol, f"{key} == {ikey}")
    if c.layout is not None:
        facts = world.report(0)["layout"][c.name]
        for k, v in c.facts.items():
            assert facts[k] == (list(v) if isinstance(v, tuple) else v), (k, facts[k], v)
    devices = {v for k, v in world.report(0)["local_devices"].items()
               if k.startswith(c.name + "/")}
    assert devices <= {"cpu"}, devices


@pytest.mark.parametrize("d", WORLDS)
def test_world_joins_through_initialize_distributed(worlds, d):
    """Each rank, a separate process, got (rank, world) back and a 1D mesh
    of every rank named as asked; every output lies on the mesh's device."""
    world = worlds[d]
    world.ok()
    for r in range(d):
        rep = world.report(r)
        assert rep["joined"] == [r, d]
        assert rep["mesh_size"] == d and rep["mesh_names"] == ["shard"]
        assert set(rep["local_devices"].values()) == {"cpu"}


def test_two_process_cluster_runs_sharded_transforms(worlds):
    """tests/test_multihost.py's pair: two processes meet through
    initialize_distributed and run a batch-sharded WPT and a halo MODWT
    across the process boundary."""
    world = worlds[2]
    world.ok()
    assert [world.report(r)["joined"] for r in range(2)] == [[0, 2], [1, 2]]
    arrays = world.arrays()
    batch = np.random.default_rng(42).standard_normal((8, 256))
    _close(arrays["multihost_batch_wpt/y"], jw.wpt(batch, "db2", 3), 1e-10, "batch WPT")
    sig = cases._multihost_signal(2)["sig"]
    _close(arrays["multihost_halo_modwt/c"], jw.modwt(sig, "db2", 3), 1e-10, "halo MODWT")


def test_collective_audit_matches_multichip_record(worlds):
    """dryrun step 9 at 8 ranks: the torch.distributed calls of each audited
    path equal the collectives MULTICHIP_r05.json records from JAX's HLO."""
    world = worlds[8]
    world.ok()
    record = json.loads((HERE.parent / "MULTICHIP_r05.json").read_text())
    hlo = json.loads(record["tail"].strip().splitlines()[-1])["collective_audit"]
    names = {"all-to-all": "all_to_all_single", "collective-permute": "batch_isend_irecv",
             "all-gather": "all_gather_single", "all-reduce": "all_reduce"}
    for r in range(8):
        audit = world.report(r)["audit"]
        assert audit == cases.AUDIT_COUNTS
        for label, calls in audit.items():
            assert calls == {names[op]: k for op, k in hlo[label]["collectives"].items()}, label


# --------------------------------------------------------------------------
# in this process: no cluster, and a one-rank world
# --------------------------------------------------------------------------

def test_initialize_distributed_single_process(monkeypatch):
    """A lone process with no cluster joins nothing and gets (0, 1)."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert P.initialize_distributed() == (0, 1)


def test_make_mesh_defaults_to_the_card():
    """With no device_type the mesh is the card's; without one that raises
    torch's own error before any process group forms."""
    if torch.cuda.is_available():
        assert P.make_mesh().device_type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            P.make_mesh()


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank CPU world in this process (make_mesh forms it), left
    after the module."""
    import torch.distributed as dist

    yield P.make_mesh((1,), ("t",), device_type="cpu")
    dist.destroy_process_group()


def test_pfft_single_device_mesh(mesh1):
    """D=1 is a plain FFT and the MODWT's FFT route, as in JAX."""
    x = np.random.default_rng(42).standard_normal(256)
    spec = P.pfft(x, mesh1)
    assert spec.placements[0].is_shard(1)
    _close(spec.full_tensor(), np.fft.fft(x).reshape(1, -1), 1e-10, "pfft D=1")
    _close(P.pifft(spec, mesh1).full_tensor().real, x, 1e-12, "pifft D=1")
    got = P.modwt_fft_sharded(x, "db4", 5, mesh1).full_tensor()
    _close(got, jw.modwt(x, "db4", 5, method=jw.ConvolutionMethod.FFT), 1e-10, "modwt_fft D=1")
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("t",))
    _close(spec.full_tensor(), jp.pfft(x, jmesh), 1e-10, "pfft D=1 against JAX")


def test_cascade_responses_device_eval_matches_host_fft():
    """The modular-doubling evaluation of the cascade responses equals the
    host FFT-built spectra for every bin, non-power-of-two N included."""
    from jwave_tpu.transforms.modwt import _cascade_spectra_full
    from jwave_tpu_torch.parallel.sharded import _cascade_responses_local

    for wav, n, level in [("db4", 96, 5), ("haar", 64, 6), ("sym8", 1536, 4)]:
        got = _cascade_responses_local(wav, level, n, torch.arange(n), torch.complex128)
        _close(got, _cascade_spectra_full(wav, level, n), 1e-10, f"{wav} N={n} L={level}")


def test_custom_bank_with_a_builtin_name_gets_its_own_responses(mesh1):
    """The cached cascade responses are keyed by the bank's coefficients: a
    custom bank named like a builtin neither reuses nor poisons them."""
    db4 = jt.get_filter("db4")
    sym4 = jt.get_filter("sym4")
    fake = jt.bank_from_arrays(db4.name, sym4.dec_lo, sym4.dec_hi, sym4.rec_lo, sym4.rec_hi)
    x = np.random.default_rng(5).standard_normal(128)
    fft = jt.ConvolutionMethod.FFT
    for bank in (db4, fake, db4):
        got = P.modwt_fft_sharded(x, bank, 3, mesh1).full_tensor()
        _close(got, jt.modwt(torch.as_tensor(x), bank, 3, method=fft), 1e-12, bank.name)


def test_dtensor_input_with_other_placements_is_redistributed(mesh1):
    """A DTensor laid out otherwise than a function needs is redistributed:
    a replicated copy of pfft2's output feeds pifft2."""
    from torch.distributed.tensor import Replicate

    x = np.random.default_rng(6).standard_normal((8, 16))
    rep = P.pfft2(x, mesh1).redistribute(mesh1, [Replicate()])
    _close(P.pifft2(rep, mesh1).full_tensor().real, x, 1e-12, "pifft2(pfft2(x)) from Replicate")
