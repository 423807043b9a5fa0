"""The port's distributed pieces: the sharding rules and their DTensor
binding (``sharding.py``), deterministic collectives (``comm.py``),
elastic re-meshing (``elastic.py``), gradient compression
(``compression.py``), the GPipe pipeline (``pipeline.py``) and the
straggler monitor (``straggler.py``).  Importing them touches no process
group."""
from repro_torch.distributed import sharding
from repro_torch.distributed.compression import (CompressionConfig,
                                                 compress_gradients)
from repro_torch.distributed.elastic import (MeshPlan, build_mesh,
                                             plan_remesh)
from repro_torch.distributed.straggler import (StragglerConfig,
                                               StragglerMonitor)
from repro_torch.distributed.pipeline import (pipeline_apply, split_stages,
                                              stage_fn_from_layers)
