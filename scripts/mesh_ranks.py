"""Two ranks on one GPU under gloo: whether gloo's CUDA collectives carry
the port's mesh training step (NCCL refuses two ranks on one device).

The smoke GPT-2 (4 q / 2 kv heads of 16, d_ff 128, vocab 512), the
launcher's mixed groups with --fused-update --refresh-every 5, batch 8 x
128, 6 steps: first without a mesh in this process, then ``--mesh 1,2``
(the products split over ``model``: two heads, half the MLP and half the
vocabulary a rank) and ``--mesh 2`` (the batch split, every product
whole) on two gloo ranks, both on cuda:0.  Each mesh run's losses are
held to the run without a mesh at rtol 1e-3 (the CPU tests' cross-mesh
tolerance).

    python3 scripts/mesh_ranks.py        # on a machine with a GPU
    python3 scripts/mesh_ranks.py --ranks-only --mesh 1,2 --json OUT.json

Prints each run's losses and the reading, or the error the mesh run
raised (a crash's Python stack through ``faulthandler``); the last line
is ``RESULT ok`` or ``RESULT error``.  ``--ranks-only`` runs no reference
and writes the ranks' ``{mesh: losses}`` (or ``{"error": ...}``) to
``--json`` for a caller that holds them itself (``chip_smoke.py``'s
``[mesh]``); ``--mesh`` picks one mesh.
"""
import argparse
import json
import os
import socket
import sys
import tempfile
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARGV = ["--arch", "gpt2-117m", "--smoke", "--steps", "6", "--fused-update",
        "--refresh-every", "5", "--log-every", "1", "--device", "cuda"]
MESHES = ("1,2", "2")


def run(argv):
    from repro_torch.launch import train as launcher
    state, hist = launcher.main(argv)
    return state, [h["loss"] for h in hist]


def worker(rank: int, port: int, out: str, meshes=MESHES):
    import faulthandler
    import torch.distributed as dist
    faulthandler.enable()                   # a crash prints its stack
    os.environ["LOCAL_RANK"] = "0"          # both ranks on the one card
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    res = {}
    for spec in meshes:
        try:
            _, losses = run(ARGV + ["--mesh", spec])
            res[spec] = losses
        except Exception:  # noqa: BLE001 -- the reading is the error
            res["error"] = res.get("error", "") + f"--mesh {spec}:\n" \
                + traceback.format_exc()
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass


def spawn_ranks(out: str, meshes=MESHES) -> dict:
    """Each mesh of ``meshes`` trained on two gloo ranks on cuda:0; the
    ranks' ``{mesh: losses}``, with ``"error"`` where a run failed, also
    written to ``out``."""
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        mp.spawn(worker, args=(port, out, tuple(meshes)), nprocs=2)
    except Exception:  # noqa: BLE001
        print(traceback.format_exc())
    if not os.path.exists(out):
        Path(out).write_text(json.dumps({"error": "no result written"}))
    return json.loads(Path(out).read_text())


def main(argv=None) -> int:
    import numpy as np
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", action="append", default=None)
    ap.add_argument("--ranks-only", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    meshes = tuple(args.mesh or MESHES)
    if not torch.cuda.is_available():
        print("no GPU")
        return 1
    out = args.json or os.path.join(tempfile.mkdtemp(), "mesh_ranks.json")
    if args.ranks_only:
        res = spawn_ranks(out, meshes)
        print("RESULT " + ("error" if "error" in res else "ok"))
        return 0
    _, ref = run(ARGV)
    print(f"without a mesh: {ref}")
    res = spawn_ranks(out, meshes)
    ok = "error" not in res
    for spec in meshes:
        if spec in res:
            err = float(np.max(np.abs(np.subtract(res[spec], ref))
                               / np.abs(ref)))
            print(f"--mesh {spec} on two gloo ranks on cuda:0: {res[spec]}; "
                  f"largest relative difference {err:.3e}")
            ok = ok and err <= 1e-3
    if "error" in res:
        print(res["error"])
    print("RESULT " + ("ok" if ok else "error"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
