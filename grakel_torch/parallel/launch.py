"""Run a function in P ranks on one host.

    python -m grakel_torch.parallel.launch --ranks 4 [--device cuda|cpu] \\
        --target my_module:run --cases a,b --out results.pkl \\
        [--init-method file:///tmp/rdzv] [--timeout 300]

The counterpart of ``tools/launch_distributed.py``.  The parent process
spawns P ranks, each a fresh ``python -m grakel_torch.parallel.launch
--rank r`` (its own clean ``__main__``: no rank imports the caller's
modules), waits for them, and exits with the first failing rank's code.
Each rank joins the group (:func:`grakel_torch.parallel.
distributed_init`: NCCL on ``cuda:{rank}`` by default, gloo with
``--device cpu``; rendezvous at ``--init-method``, by default a free
``tcp://127.0.0.1`` port), builds the mesh of every rank, imports
``--target`` (``module:function``; the module is found on the
caller's ``PYTHONPATH``, the repo's root added) and calls
``function(case, mesh)`` for each of ``--cases`` in turn, inside
``use_device`` of the rank's device.  Rank 0 pickles ``{"results":
{case: result}, "seconds": ..., "collectives": ..., "ranks": P,
"backend": ...}`` to ``--out``: each case's wall seconds and the ring
hops and all-gathers it issued.  With ``--timeout`` the parent kills
every rank past that many seconds.

Importing this module starts nothing.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import socket
import subprocess
import sys
import time

__all__ = ["collective_calls", "main"]


def collective_calls():
    """{"ring_hops": ..., "all_gathers": ...}: the collectives the
    parallel layer has issued in this process."""
    from grakel_torch.parallel import gram, mesh
    return {"ring_hops": gram._ring.hops,
            "all_gathers": mesh.gather_blocks.calls}


def _worker(args):
    import torch
    torch.set_num_threads(1)
    from grakel_torch import use_device
    from grakel_torch.parallel import distributed_init, make_mesh
    from grakel_torch.parallel.mesh import shutdown
    import torch.distributed as dist
    dev = "cpu" if args.device == "cpu" else "cuda:%d" % args.rank
    module, _, name = args.target.partition(":")
    run = getattr(importlib.import_module(module), name)
    with use_device(dev):
        distributed_init(args.init_method, args.ranks, args.rank,
                         device=dev, local_rank=args.rank)
        mesh = make_mesh()
        out, secs, coll = {}, {}, {}
        for case in args.cases.split(","):
            before = collective_calls()
            t = time.perf_counter()
            out[case] = run(case, mesh)
            secs[case] = time.perf_counter() - t
            coll[case] = {k: v - before[k]
                          for k, v in collective_calls().items()}
        if args.rank == 0:
            with open(args.out, "wb") as f:
                pickle.dump({"results": out, "seconds": secs,
                             "collectives": coll, "ranks": args.ranks,
                             "backend": mesh.backend}, f)
        dist.barrier()
        shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--target", required=True,
                    help="module:function, called as function(case, mesh)")
    ap.add_argument("--cases", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("--rank", type=int, default=None,
                    help="internal: set when running as a rank")
    args = ap.parse_args(argv)
    if args.rank is not None:
        _worker(args)
        return 0
    init = args.init_method or "tcp://127.0.0.1:%d" % _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "grakel_torch.parallel.launch",
         "--ranks", str(args.ranks), "--device", args.device,
         "--target", args.target, "--cases", args.cases, "--out", args.out,
         "--init-method", init, "--rank", str(r)], env=env)
        for r in range(args.ranks)]
    deadline = None if args.timeout is None else time.time() + args.timeout
    rc = 0
    try:
        for p in procs:
            left = None if deadline is None else max(deadline - time.time(),
                                                     0.1)
            code = p.wait(timeout=left)
            rc = rc or code
            if code:     # a failed rank leaves the others waiting
                break
    except subprocess.TimeoutExpired:
        rc = 124
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
