"""The model API's part that every family of the port shares."""
from __future__ import annotations

from typing import Optional

import torch


class TrainOnly:
    """The serving entry points of the JAX model API, which raise until
    ROADMAP.md Queue A's serving item ports them."""

    def _serving(self, what: str):
        raise NotImplementedError(
            f"{type(self).__name__}.{what} (serving: caches, prefill and "
            f"decode) is not ported to PyTorch yet; see ROADMAP.md Queue A, "
            f"serving")

    def init_cache(self, batch: int, cache_len: int):
        self._serving("init_cache")

    def prefill(self, params: dict, tokens: torch.Tensor, cache,
                embeds: Optional[torch.Tensor] = None):
        self._serving("prefill")

    def decode_step(self, params: dict, cache, tokens: torch.Tensor):
        self._serving("decode_step")
