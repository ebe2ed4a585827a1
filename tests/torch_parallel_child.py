"""One rank of a gloo world for tests/test_torch_parallel.py (not a test
module).

    python tests/torch_parallel_child.py <rank> <world> <port> <out_dir>

Joins the world through ``initialize_distributed("127.0.0.1:<port>",
world, rank)`` (as two hosts would), runs every case of
tests/torch_parallel_cases.py for this world size on the port's sharded
layer, and writes what it saw: rank 0 each result's ``full_tensor()`` to
``<out_dir>/w<world>.npz``; every rank the errors it raised, the layout
facts and, at 8 ranks, the torch.distributed calls of the collective audit
to ``<out_dir>/w<world>_r<rank>.json``.
"""
import collections
import json
import os
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import jwave_tpu_torch as jt  # noqa: E402
from jwave_tpu_torch import parallel as P  # noqa: E402
from jwave_tpu_torch.exceptions import JWaveFailure  # noqa: E402
import torch_parallel_cases as cases  # noqa: E402

SPIED = ("all_to_all_single", "batch_isend_irecv", "all_gather_single", "all_gather_into_tensor",
         "all_reduce")


def as_numpy(r):
    if hasattr(r, "full_tensor"):
        r = r.full_tensor()
    if isinstance(r, torch.Tensor):
        return r.detach().cpu().numpy()
    return np.asarray(r)


def audit(fn) -> dict:
    """The torch.distributed calls ``fn`` makes, by name."""
    seen = collections.Counter()
    saved = {name: getattr(dist, name) for name in SPIED if hasattr(dist, name)}

    def spy(name):
        def call(*a, **k):
            seen[name] += 1
            return saved[name](*a, **k)
        return call

    for name in saved:
        setattr(dist, name, spy(name))
    try:
        fn()
    finally:
        for name, f in saved.items():
            setattr(dist, name, f)
    return dict(seen)


def main():
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    joined = P.initialize_distributed(f"127.0.0.1:{port}", world, rank)
    meshes = {"n": world, "1d": P.make_mesh((world,), ("shard",), device_type="cpu")}
    shape2d = cases.MESH_2D[world]
    meshes["bs"] = P.make_mesh(shape2d, ("batch", "scale"), device_type="cpu")
    meshes["rc"] = P.make_mesh(shape2d, ("mrow", "mcol"), device_type="cpu")
    report = {"joined": list(joined), "mesh_size": meshes["1d"].size(),
              "mesh_names": list(meshes["1d"].mesh_dim_names), "errors": {}, "layout": {},
              "local_devices": {}}
    arrays = {}
    for c in cases.cases_for(world):
        inp = c.inputs(world)
        if c.raises:
            try:
                c.port(P, jt, meshes, inp)
                report["errors"][c.name] = None
            except JWaveFailure as e:
                report["errors"][c.name] = str(e)
            continue
        res = c.port(P, jt, meshes, inp)
        if c.layout is not None:
            report["layout"][c.name] = {k: list(v) if isinstance(v, tuple) else v
                                        for k, v in c.layout(res).items()}
        for key, r in res.items():
            if hasattr(r, "to_local"):
                report["local_devices"][f"{c.name}/{key}"] = r.to_local().device.type
            arr = as_numpy(r)  # a collective for a DTensor: every rank gathers
            if rank == 0:
                arrays[f"{c.name}/{key}"] = arr
    if world == 8:
        inp = cases.dryrun_inputs(world)
        report["audit"] = {label: audit(fn)
                           for label, fn in cases.audit_calls(P, jt, meshes, inp).items()}
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(out, f"w{world}.npz"), **arrays)
    with open(os.path.join(out, f"w{world}_r{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main()
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
