"""What a one-rank mesh costs a fold step: the launcher's GPT-2 117M run
(mixed groups, --fused-update --refresh-every 5, batch 8 x 1024, 12
steps) without a mesh and with ``--mesh 1,1 --fsdp``, alternating twice
in one process, each step timed to a synchronize.

Run from the root of a checkout (its ``chip_smoke.py`` and ``src/``), on
a machine with a GPU; to hold two checkouts against each other, unpack
the other into a directory ``.gitignore`` lists and run both in one
call, in the order a, b, b, a:

    git archive <commit> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for d in parent change change parent; do
        (cd build/$d && PYTHONPATH=src python3 ../../scripts/mesh_ab.py $d)
    done

Prints, for each run, the median of its fold steps (steps 2-5, 7-10 and
12; the cadence refreshes at 1, 6 and 11), every fold step and the
refresh steps 6 and 11, after the card's name and power limit.
"""
import statistics
import sys
import time

sys.path.insert(0, ".")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as CS  # noqa: E402
import repro_torch.train.train_loop as TL  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402


def step_times(argv: list) -> list:
    """Seconds of each step of ``launcher.main(argv)``."""
    times = []
    build = TL.build_train_step

    def timed_build(*args, **kwargs):
        step = build(*args, **kwargs)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        return timed

    TL.build_train_step = timed_build
    try:
        launcher.main(argv)
    finally:
        TL.build_train_step = build
    return times


def main(tag: str) -> None:
    print(tag, CS.card_line(), flush=True)
    for rnd in range(2):
        for mesh in (False, True):
            t = step_times(CS.TRAIN_MIXED_ARGV
                           + (CS.MESH_ARGV if mesh else []))
            fold = [x for i, x in enumerate(t, 1) if i % 5 != 1]
            print(f"{tag} round {rnd} {'mesh' if mesh else 'no mesh'}: "
                  f"fold median {statistics.median(fold):.4f} s "
                  f"({[round(x, 4) for x in fold]}), refresh "
                  f"{[round(t[i - 1], 4) for i in (6, 11)]}", flush=True)
            if dist.is_initialized():
                dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "this checkout")
