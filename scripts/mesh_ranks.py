"""Two ranks on one GPU under gloo: whether gloo's CUDA collectives carry
the port's mesh training step (NCCL refuses two ranks on one device).

GPT-2 117M at full width cut to 4 layers, the launcher's mixed groups with
--fused-update --refresh-every 5, batch 8 x 1024, 6 steps: first without a
mesh in this process, then ``--mesh 2`` and ``--mesh 1,2`` on two gloo
ranks, both on cuda:0.  Each mesh run's losses are held to the run without
a mesh at rtol 1e-3 (the CPU tests' cross-mesh tolerance).

    python3 scripts/mesh_ranks.py        # on a machine with a GPU

Prints each run's losses and the reading, or the error the mesh run
raised (a crash's Python stack through ``faulthandler``); the last line
is ``RESULT ok`` or ``RESULT error``.
"""
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

ARGV = ["--arch", "gpt2-117m", "--steps", "6", "--batch", "8", "--seq",
        "1024", "--fused-update", "--refresh-every", "5", "--log-every", "1",
        "--device", "cuda"]
LAYERS = 4
MESHES = ("2", "1,2")


def run(argv):
    import chip_smoke
    from repro_torch.launch import train as launcher
    with chip_smoke.depth_cut(LAYERS):
        state, hist = launcher.main(argv)
    return state, [h["loss"] for h in hist]


def worker(rank: int, port: int, out: str):
    import faulthandler
    import torch.distributed as dist
    faulthandler.enable()                   # a crash prints its stack
    os.environ["LOCAL_RANK"] = "0"          # both ranks on the one card
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    res = {}
    try:
        for spec in MESHES:
            _, losses = run(ARGV + ["--mesh", spec])
            res[spec] = losses
    except Exception:  # noqa: BLE001 -- the reading is the error
        res["error"] = traceback.format_exc()
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass


def main() -> int:
    import numpy as np
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("no GPU")
        return 1
    _, ref = run(ARGV)
    print(f"without a mesh: {ref}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(), "mesh_ranks.json")
    try:
        mp.spawn(worker, args=(port, out), nprocs=2)
    except Exception:  # noqa: BLE001
        print(traceback.format_exc())
    res = json.loads(Path(out).read_text()) if os.path.exists(out) else {
        "error": "no result written"}
    ok = "error" not in res
    for spec in MESHES:
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
