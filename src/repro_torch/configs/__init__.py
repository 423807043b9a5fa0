"""Architecture configs (the ten of the dry run's matrix and the paper's
GPT-2), their smoke configs, and the batches of a shape cell."""
from repro_torch.configs.archs import (ARCHS, ASSIGNED, get_config,
                                       get_smoke_config)
from repro_torch.configs.base import input_specs, make_batch
