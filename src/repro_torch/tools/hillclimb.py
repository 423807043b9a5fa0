"""Hill-climbing harness over the port's dry run: build an (arch, cell)
under config overrides, count one step of it, derive the roofline terms
and record the try (the port's counterpart of the JAX package's
``tools/hillclimb.py``: the same arguments and record fields).

    PYTHONPATH=src python -m repro_torch.tools.hillclimb qwen2-7b train_4k \
        --set attn_impl=chunked remat=dots --mb 4 --tag chunked+dots
    PYTHONPATH=src python -m repro_torch.tools.hillclimb gpt2-117m train_4k \
        --preset test --set remat=full --tag smoke

The cell is ``launch/dryrun.py``'s: fake tensors over a fake process group
(``launch/mesh.py::make_fake_mesh``) at the production shape (data=16,
model=16) = 256 ranks, counted by ``launch/step_cost.py`` as rank 0 runs
it.  ``--set`` replaces model-config fields, ``--opt`` fields of the dry
run's optimizer config and ``--mb`` the microbatch count, each through
``dryrun.build_cell``'s keyword overrides.  ``--preset test`` is the dry
run's test preset instead: the smoke config on ``dryrun.TEST_MESH``'s 8
fake ranks, which runs in seconds.

Records land in ``experiments/perf_torch/<arch>__<cell>__<tag>.json``:
the per-rank FLOPs, bytes accessed, collective link bytes per kind, the
step's peak of live bytes, the ten sites with the most bytes accessed (an
aten op and its output's dtype and shape) and three roofline terms, each
a count over one NVIDIA H100 SXM5 80GB's datasheet rate (dense, no
sparsity, at its 700 W limit):

  * ``t_compute = flops / PEAK_FLOPS``, 989 TFLOP/s bf16 on the tensor
    cores;
  * ``t_memory = bytes / HBM_BW``, 3.35 TB/s HBM3;
  * ``t_collective = collective_bytes / LINK_BW``, NVLink 4 at 450 GB/s a
    direction (900 GB/s both ways).

A mesh wider than one 8-card NVLink node crosses the network between
nodes, which is slower than NVLink, so ``t_collective`` is then a lower
bound.  The counts are the dry run's: its peaks and bytes are the plain
route's (the kernels' plain versions run on fake CPU tensors, whose
temporaries exceed the CUDA kernels'; PERF.md section 3), and no time is
measured here.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh

# NVIDIA H100 SXM5 80GB datasheet: dense bf16 tensor-core rate
PEAK_FLOPS = 989e12
# the same datasheet: HBM3 bandwidth
HBM_BW = 3.35e12
# the same datasheet: NVLink 4, 900 GB/s both directions, 450 GB/s each
LINK_BW = 450e9

OUT_DIR = Path("experiments/perf_torch")


def measure(arch: str, cell: str, overrides: Optional[dict] = None,
            mb: Optional[int] = None, opt_overrides: Optional[dict] = None,
            tag: str = "exp", preset: Optional[str] = None,
            out_dir: Path = OUT_DIR, mesh=None) -> dict:
    """Count one step of the cell under the overrides, write its record to
    ``out_dir`` and return it.  ``mesh`` (a fake one, ``make_fake_mesh``)
    replaces the preset's: the test preset's smoke batch of 4 leaves one
    sequence a data rank on ``TEST_MESH``, too few to split into
    microbatches."""
    DR.quiet_redistribute()
    smoke = preset == "test"
    if mesh is None:
        mesh = (make_fake_mesh(*DR.TEST_MESH) if smoke
                else make_production_mesh(fake=True))
    c = DR.build_cell(arch, cell, mesh, smoke=smoke, overrides=overrides,
                      microbatches=mb, opt_overrides=opt_overrides)
    m = DR.measure(c)
    rec = {
        "arch": arch, "cell": cell, "tag": tag, "preset": preset,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "microbatches": mb, "opt_overrides": opt_overrides,
        "flops": float(m["flops"]), "bytes": float(m["bytes_accessed"]),
        "collective_bytes": m["collective_bytes"],
        "coll": m["collectives"],
        "t_compute": m["flops"] / PEAK_FLOPS,
        "t_memory": m["bytes_accessed"] / HBM_BW,
        "t_collective": m["collective_bytes"] / LINK_BW,
        "peak_gib": m["peak_bytes"] / 2**30,
        "top_sites": [[s, b] for s, b in m["top_sites"]],
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{arch}__{cell}__{tag}.json").write_text(
        json.dumps(rec, indent=1))
    return rec


def parse_kv(items: list) -> dict:
    """``["k=v", ...]`` to a dict, each value an int, a float or the
    string, the first that parses."""
    out = {}
    for item in items:
        k, v = item.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("cell")
    ap.add_argument("--set", nargs="*", default=[],
                    help="ModelConfig overrides k=v")
    ap.add_argument("--opt", nargs="*", default=[],
                    help="optimizer overrides k=v")
    ap.add_argument("--mb", type=int, default=None)
    ap.add_argument("--tag", default="exp")
    ap.add_argument("--preset", default=None, choices=[None, "test"],
                    help="test: the smoke config on the dry run's 8-rank "
                         "test mesh")
    args = ap.parse_args(argv)

    rec = measure(args.arch, args.cell, parse_kv(args.set), args.mb,
                  parse_kv(args.opt) or None, args.tag, args.preset)
    print(f"{args.tag}: t_comp={rec['t_compute']:.2f}s "
          f"t_mem={rec['t_memory']:.2f}s t_coll={rec['t_collective']:.2f}s "
          f"peak={rec['peak_gib']:.1f}GiB")
    for s, b in rec["top_sites"][:6]:
        print(f"  {b:10.3g}  {s}")
    return rec


if __name__ == "__main__":
    main()
