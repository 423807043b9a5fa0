"""Model, optimizer and telemetry configs (frozen dataclasses), copied from
the JAX package's ``config.py`` for the fields the port reads."""
from __future__ import annotations

import dataclasses
from typing import Optional


# models/attention.py::sdpa_auto: "chunked" forces the flash-attention
# path where the sequence lengths divide into its 1024-row chunks, "naive"
# the materialised score matrix, "auto" chunked only above 4096 tokens.
ATTN_IMPLS = ("auto", "chunked", "naive")
# models/transformer.py, ssm_lm.py: "full" recomputes each layer's body in
# the backward, "dots" saves only its matmul outputs (transformer; the SSM
# block treats it as "full", as the JAX package does), "none" saves all.
REMATS = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts block sizes (the JAX package's ``MoESpec``):
    ``impl`` "sort" dispatches tokens into fixed-capacity per-expert
    buffers, "dense" runs every expert on every token (the oracle)."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    impl: str = "sort"            # "sort" | "dense" (tiny configs, oracle)
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba2 / SSD block sizes (the JAX package's ``SSMSpec``)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # P
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                    # dense | moe | vlm | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    act: str = "swiglu"                     # swiglu | gelu | relu2
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"             # rope | learned | none
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    # hybrid (zamba2): a shared attention+MLP block applied every N ssm layers
    hybrid_attn_every: int = 0
    n_shared_blocks: int = 2
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    # modality frontends are stubs: the batch carries their embeddings
    frontend: str = "none"                  # none | audio | vision
    frontend_tokens: int = 0                # vision patch tokens prepended
    dtype: str = "bfloat16"        # compute dtype
    param_dtype: str = "float32"   # master params (float32 | bfloat16)
    attn_impl: str = "auto"        # auto | chunked | naive (perf knob)
    remat: str = "full"            # none | full | dots
    max_seq_len: int = 32_768
    # the mesh rule set of distributed/sharding.py: tp (the logical-axis
    # tables, FSDP over data) | fsdp (ZeRO-3 over every mesh axis)
    parallel_strategy: str = "tp"

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={self.attn_impl!r}; expected one "
                             f"of {ATTN_IMPLS}")
        if self.remat not in REMATS:
            raise ValueError(f"remat={self.remat!r}; expected one of "
                             f"{REMATS}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One parameter group inside :attr:`OptimizerConfig.groups`.

    ``select`` picks the leaves this group owns (first matching group in
    declaration order wins):

      * ``"embeddings"`` -- >= 2-D leaves whose LEADING dim is at least
        ``OptimizerConfig.embedding_min_rows`` (vocab / embedding tables);
      * ``"factored"`` -- >= 2-D leaves whose smaller trailing dim is at
        least ``OptimizerConfig.min_dim_factor``;
      * ``"matrices"`` -- every >= 2-D leaf;
      * ``"vectors"``  -- < 2-D leaves (biases, norm scales, scalars);
      * ``"rest"``     -- catch-all (every groups tuple must end in one).

    ``name`` is the optimizer family for the group; ``None`` inherits the
    parent config's ``name``.  ``lr_scale`` multiplies the group's learning
    rate (shared warmup/decay shape, scaled peak).
    """

    select: str = "rest"
    name: Optional[str] = None
    lr_scale: float = 1.0


def default_mixed_groups() -> tuple:
    """The launcher's mixed partition, three state families: the count-min
    sketch on embedding tables, the parent family (Adapprox) on factorable
    matrices, and bias-corrected dense Adam on the rest.  ``"embeddings"``
    comes first so wide tables reach the sketch before ``"factored"`` can
    claim them."""
    return (("embeddings", GroupSpec(select="embeddings", name="sketch")),
            ("factored", GroupSpec(select="factored")),
            ("dense", GroupSpec(select="rest", name="adamw")))


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Declarative optimizer spec, the input to ``core.build_optimizer``.
    Field names and defaults follow the JAX package's ``OptimizerConfig``;
    the port builds the ``adapprox``, ``adamw``, ``adafactor``, ``came``
    and ``sketch`` families and their parameter groups (``groups``, a tuple of ``(label, GroupSpec)``
    pairs ending in a ``"rest"`` catch-all)."""

    name: str = "adapprox"
    lr: float = 3e-4
    schedule: str = "cosine"        # cosine | constant
    warmup_steps: int = 1000
    total_steps: int = 100_000
    min_lr: float = 5e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_d: float = 1.0
    weight_decay: float = 0.1
    decay_mask: str = "all"         # all | no_1d
    rank_mode: str = "static"       # static | paper | exact
    k: int = 64                     # static rank / k_init (adaptive)
    k_max: int = 256
    xi_thresh: float = 0.01
    delta_s: int = 10
    oversample: int = 5
    n_iter: int = 5
    guidance: str = "off"
    implicit: bool = True
    use_kernels: bool = False
    refresh_every: int = 1
    warm_start: bool = False
    n_iter_warm: int = 1
    warm_drift_xi: float = 0.5
    bucketed: bool = False
    fused_update: bool = False
    telemetry: bool = False
    dynamic_refresh: bool = False
    # resilience guards (repro_torch.resilience; default off: the built
    # chain and its state are unchanged): guards wraps the whole chain in
    # the non-finite skip-step guard and arms the per-leaf xi watchdog --
    # a leaf whose approximation error exceeds guard_xi_trip gets a forced
    # full S-RSI refresh on the next step, and after max_demotions
    # consecutive trips it falls back to the exact dense second moment
    # (max_demotions=0 disables demotion and its dense shadow buffers)
    guards: bool = False
    guard_xi_trip: float = 0.75
    max_demotions: int = 0
    min_dim_factor: int = 128
    factor_dtype: str = "float32"
    quantize_factors: bool = False
    seed: int = 0
    # count-min sketch family (core/sketch.py): depth x width buckets per
    # leaf, hashed over the row axis; embedding_min_rows is also the
    # "embeddings" GroupSpec threshold
    sketch_width: int = 2048
    sketch_depth: int = 4
    embedding_min_rows: int = 1024
    # adafactor specifics
    b2_schedule: bool = True        # b2_t = 1 - t^-0.8
    relative_step: bool = False
    # came specifics
    b3: float = 0.9999              # instability-statistic decay
    groups: tuple = ()


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Host-side telemetry and closed-loop refresh control
    (``repro_torch.telemetry``; that package's docstring has the JSONL
    event schema), a copy of the JAX package's ``TelemetryConfig``.

    ``enabled`` turns on collection (``OptimizerConfig.telemetry``) and
    the per-step host read; ``dir`` adds the async JSONL sink (``None`` =
    collect and control without writing events); ``auto_refresh`` adds the
    feedback controller, which adapts ``refresh_every`` per parameter
    group from the observed xi and needs the cadence on the state
    (``OptimizerConfig.dynamic_refresh``).  Controller policy: at every
    ``interval``-step boundary, the interval-mean xi per group is compared
    against a hysteresis band -- ``>= xi_high`` divides the cadence by
    ``tighten_div`` (refresh more often), ``<= xi_low`` for
    ``relax_patience`` consecutive intervals adds ``relax_add`` (refresh
    less often), in between nothing moves.  Cadences are clamped to
    [t_min, t_max].
    """

    enabled: bool = False
    dir: Optional[str] = None            # JSONL sink directory (None = off)
    emit_every: int = 1                  # emit events every N steps
    rotate_bytes: int = 32 * 1024 * 1024
    auto_refresh: bool = False           # closed-loop cadence controller
    interval: int = 25                   # steps between cadence decisions
    t_min: int = 1
    t_max: int = 50
    xi_high: float = 0.25                # tighten when interval-mean xi >=
    xi_low: float = 0.10                 # relax when <= (with patience)
    relax_patience: int = 2
    tighten_div: int = 2
    relax_add: int = 1

    def __post_init__(self):
        if self.emit_every < 1:
            raise ValueError(f"emit_every must be >= 1, "
                             f"got {self.emit_every}")
        if self.rotate_bytes < 1:
            raise ValueError(f"rotate_bytes must be >= 1, "
                             f"got {self.rotate_bytes}")
