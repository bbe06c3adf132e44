"""Runtime scheduler (paper §V-C2): schedule knobs and the direction policy.

Counterpart of ``repro.core.scheduler`` for one device.  ``plan`` resolves
the backend, the chunk geometry and the out-of-core partition axis (the
streamed engine, :mod:`repro_torch.core.stream`); a plan over several
processing elements raises ``NotImplementedError`` until that plane is
ported (``ROADMAP.md`` §1 item 5).
:class:`AdmissionPolicy` holds the serving plane's batching knobs.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class DirectionPolicy:
    """Runtime direction optimization knobs (Beamer-style alpha/beta).

    ``mode='pull'`` / ``'push'`` pin every superstep to one direction;
    ``'auto'`` switches per superstep on frontier occupancy with
    hysteresis: while pushing, stay push while ``m_f * alpha`` is below
    the measured pull cost; while pulling, re-enter push when
    ``n_f * beta < V``.  Defaults follow the JAX package's traversal
    model (alpha 1, beta 4).
    """

    mode: str = "auto"           # 'pull' | 'push' | 'auto'
    alpha: float = 1.0           # push→pull when m_f > E/alpha
    beta: float = 4.0            # pull→push when n_f < V/beta

    def __post_init__(self):
        if self.mode not in ("pull", "push", "auto"):
            raise ValueError(f"unsupported direction mode: {self.mode}")
        if self.alpha <= 0 or self.beta <= 0:
            raise ValueError("alpha and beta must be > 0")

    def describe(self) -> str:
        """One-line summary for reports and IR dumps."""
        return f"{self.mode}(alpha={self.alpha:g}, beta={self.beta:g})"


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Serving-plane admission knobs (paper §V-C2's runtime scheduler,
    lifted from per-superstep direction choice to per-query batching).

    The serving plane (:mod:`repro_torch.serve.graph_serve`) keeps one
    fixed ``slots``-lane batch per compiled program and continuously
    admits queued queries into converged lanes between slices of
    ``slice_supersteps`` supersteps.

    * ``slots`` — lanes per batched program (the ``(k, V)`` batch's k).
      Frozen and idle lanes launch nothing, but a batched superstep's
      masked sweep reads every stepping lane's tables.
    * ``slice_supersteps`` — supersteps per slice between admission
      points.  Smaller slices free converged lanes sooner (lower queue
      latency) at the cost of more host round-trips.
    * ``max_queue`` — queue bound; ``submit`` raises when full (0 =
      unbounded).  Back-pressure, not silent drops.
    * ``coalesce`` — identical in-flight queries (same program identity,
      same root) share one lane and one answer.
    """

    slots: int = 8               # lanes per batched program
    slice_supersteps: int = 4    # supersteps between admission points
    max_queue: int = 0           # submit() bound; 0 = unbounded
    coalesce: bool = True        # duplicate queries share a lane

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.slice_supersteps < 1:
            raise ValueError("slice_supersteps must be >= 1")
        if self.max_queue < 0:
            raise ValueError("max_queue must be >= 0 (0 = unbounded)")

    def describe(self) -> str:
        """One-line summary for reports and benchmark payloads."""
        q = self.max_queue or "unbounded"
        return (f"slots={self.slots} slice={self.slice_supersteps} "
                f"queue={q} coalesce={self.coalesce}")


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Paper Algorithm 1, line 5: ``Set Pipeline = 8, PE = 1``.

    ``pull_sweep``: ``'bitmap'`` selects the block-skipping pull plane
    wherever it is legal, ``'dense'`` pins the flat full sweep, and
    ``'auto'`` resolves dense on both paths, as the superstep-fusion pass
    says (on the CUDA path by the H100 walls recorded in
    ``passes.CUDA_AUTO_SWEEP_NOTE``).  All are bit-exact.
    ``block_rows`` is the kernel path's skip granularity: the rows per
    ``block_live`` flag of the early-out edge-block kernel.
    """

    pipelines: int = 8           # edge-stream chunks per superstep
    pes: int = 1                 # processing elements (only 1 is ported)
    backend: str = "auto"        # 'auto' | 'dense' | 'sparse'
    block_rows: int = 128        # early-out kernel rows per liveness flag
    direction: DirectionPolicy = DirectionPolicy()  # push/pull/auto policy
    push_ell_width: int = 8      # forward-ELL row width (compacted push)
    pull_sweep: str = "auto"     # 'auto' | 'bitmap' | 'dense'
    pull_block_slots: int = 64   # edge slots per pull block (multiple of 8)
    # out-of-core: split the edge set into ``partitions`` contiguous
    # source-vertex intervals streamed host→device each superstep, or
    # derive the count from ``partition_budget_bytes`` for one plane's
    # streamed arrays (estimate_stream_bytes); with both, the larger
    # resolved count wins.  One partition and no budget: resident.
    partitions: int = 1
    partition_budget_bytes: int | None = None
    # hard superstep budget; None resolves to V+1 (the diameter bound)
    max_supersteps: int | None = None
    # opt-in NaN probe between supersteps (float programs): a NaN freezes
    # the frontier and the run reports terminated='diverged'
    probe_divergence: bool = False

    def __post_init__(self):
        if self.backend not in ("auto", "dense", "sparse"):
            raise ValueError(self.backend)
        if self.pipelines < 1 or self.pes < 1:
            raise ValueError("pipelines and pes must be >= 1")
        if self.push_ell_width < 1:
            raise ValueError("push_ell_width must be >= 1")
        if self.block_rows < 1:
            raise ValueError("block_rows must be >= 1")
        if self.pull_sweep not in ("auto", "bitmap", "dense"):
            raise ValueError(f"unsupported pull_sweep: {self.pull_sweep}")
        if self.pull_block_slots < 8 or self.pull_block_slots % 8:
            raise ValueError("pull_block_slots must be a positive "
                             "multiple of 8")
        if not isinstance(self.direction, DirectionPolicy):
            raise TypeError("direction must be a DirectionPolicy")
        if self.partitions < 1:
            raise ValueError("partitions must be >= 1")
        if self.partition_budget_bytes is not None \
                and self.partition_budget_bytes < 1:
            raise ValueError("partition_budget_bytes must be >= 1 (or None)")
        if self.max_supersteps is not None and self.max_supersteps < 1:
            raise ValueError("max_supersteps must be >= 1 (or None)")

    def superstep_budget(self, program_max_iters: int | None,
                         num_vertices: int) -> int:
        """Effective superstep bound: the smaller of the program's own
        ``max_iters`` and ``max_supersteps`` (default ``V + 1``)."""
        cap = (self.max_supersteps if self.max_supersteps is not None
               else num_vertices + 1)
        if program_max_iters is not None:
            cap = min(cap, program_max_iters)
        return max(1, cap)


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """Resolved schedule: backend and chunk geometry for this graph."""

    config: ScheduleConfig
    backend: str                 # resolved ('dense' | 'sparse')
    num_chunks: int              # edge-stream chunks (>= 1)
    chunk_size: int              # edges per chunk (padded, >= 1)
    direction: DirectionPolicy = DirectionPolicy()  # carried from config
    # the resolved interval-partition count (1: resident) and the byte
    # budget that resolved it (None when the count was given)
    num_partitions: int = 1
    partition_budget_bytes: int | None = None
    pes: int = 1

    def describe(self) -> str:
        """One-line summary for IR/pass dumps (backend-selection pass)."""
        parts = ""
        if self.num_partitions > 1:
            budget = self.partition_budget_bytes
            parts = (f" partitions={self.num_partitions}"
                     + (f"(budget={budget}B)" if budget else ""))
        return (f"backend={self.backend} pipelines={self.num_chunks} "
                f"chunk_size={self.chunk_size} pes={self.pes} "
                f"direction={self.direction.describe()} "
                f"pull_sweep={self.config.pull_sweep}{parts}")


def push_capacity_tiers(num_rows: int) -> tuple[int, int]:
    """Compaction capacity tiers for the forward-ELL push engine.

    Two power-of-two tiers, ``~R/64`` and ``~R/16`` rows: the runtime
    picks the smallest tier covering the live row count ``r_f`` each
    superstep, and beyond the large tier the push superstep falls back to
    the dense sweep.  The same tiers as the JAX package, so the
    compacted/fallback split of ``run_stats`` agrees.
    """
    def p2floor(x: int) -> int:
        return 1 << max(x.bit_length() - 1, 0)

    small = max(256, p2floor(max(num_rows, 1) // 64))
    large = max(2 * small, p2floor(max(num_rows, 1) // 16))
    return small, large


# Capacity fractions of the block-skipping pull plane's two narrow tiers,
# as in the JAX package: a frontier whose out-edge count m_f is at most
# caps[t] takes tier t (touched pre-pass with caps[t] row slots, up to
# 4·caps[t] swept blocks on the gathered path); a wider one takes the
# dense full sweep.
PULL_BLOCK_TIERS = (1 / 64, 1 / 16)


def pull_block_capacities(num_blocks: int) -> tuple:
    """Per-tier capacities of the block-skipping pull plane:
    ``caps[t] = max(1, ceil(num_blocks * PULL_BLOCK_TIERS[t]))``."""
    return tuple(max(1, math.ceil(num_blocks * f))
                 for f in PULL_BLOCK_TIERS)


# Streamed bytes per edge of one partition plane (width-8 ELL): 8 bytes of
# slot and weight times ~1.3 padding on power-law graphs, plus the row's
# key (4 bytes a width of slots).  A planning estimate, the JAX
# package's: the store reports exact bytes at run time.
STREAM_BYTES_PER_EDGE = 11


def estimate_stream_bytes(num_edges: int, width: int = 8) -> int:
    """Planning estimate of one streamed plane's edge-array bytes, which
    :func:`plan` divides by ``partition_budget_bytes``."""
    return int(num_edges * STREAM_BYTES_PER_EDGE)


def choose_backend(cfg: ScheduleConfig, *, num_vertices: int,
                   num_edges: int, avg_degree: float) -> str:
    """Module selection heuristic: dense ELL blocks at moderate degree,
    the sorted-CSR segment path for very sparse graphs."""
    if cfg.backend != "auto":
        return cfg.backend
    return "dense" if avg_degree >= 4.0 else "sparse"


def plan(cfg: ScheduleConfig, *, num_vertices: int, num_edges: int,
         fixed_partitions: int | None = None) -> SchedulePlan:
    """Resolve ``cfg`` for a graph on one device.

    The partition count is ``fixed_partitions`` when given (a partition
    container's own cuts), else the larger of ``cfg.partitions`` and the
    count the byte budget needs, clamped to ``[1, V]``.
    """
    if fixed_partitions is not None:
        num_partitions = max(1, int(fixed_partitions))
    else:
        num_partitions = max(1, cfg.partitions)
        if cfg.partition_budget_bytes is not None:
            est = estimate_stream_bytes(num_edges, cfg.push_ell_width)
            num_partitions = max(num_partitions,
                                 -(-est // cfg.partition_budget_bytes))
    num_partitions = min(num_partitions, max(num_vertices, 1))
    if num_partitions > 1 and cfg.pes > 1:
        raise ValueError(
            "partitioned execution is single-PE: the streamed partitions "
            f"already tile the edge set (got partitions={num_partitions}, "
            f"pes={cfg.pes})")
    if cfg.pes > 1:
        raise NotImplementedError(
            f"pes={cfg.pes}: the multi-PE exchange is not ported yet "
            "(ROADMAP.md §1 item 5)")
    avg_degree = num_edges / max(num_vertices, 1)
    backend = choose_backend(cfg, num_vertices=num_vertices,
                             num_edges=num_edges, avg_degree=avg_degree)
    num_chunks = max(1, min(cfg.pipelines, math.ceil(num_edges / 1024)))
    chunk_size = max(1, math.ceil(num_edges / num_chunks))
    return SchedulePlan(config=cfg, backend=backend, num_chunks=num_chunks,
                        chunk_size=chunk_size, direction=cfg.direction,
                        num_partitions=num_partitions,
                        partition_budget_bytes=cfg.partition_budget_bytes)
