"""Scale-sweep graph data: chunked R-MAT synthesis and ``.npz`` partition
containers.

Counterpart of ``repro.data.graphs``, with the same container layout, so
each package reads the other's files:

* :func:`rmat_edge_chunks` yields an R-MAT edge set as bounded chunks,
  chunk ``i`` a pure function of ``(seed, i)``, so a second pass
  regenerates the same stream;
* :func:`build_partition_container` is the two-pass build: pass 1 counts
  out-degrees chunk by chunk and picks edge-balanced vertex cuts
  (:func:`repro_torch.core.graph.edge_interval_cuts`), pass 2 regenerates
  the stream and deals each edge into its partition's pre-counted buffer.
  Each partition is stored as a rebased CSR (offsets over its vertex
  interval, global destination ids) under its own ``.npz`` members, with
  its CRC32 (format v2);
* :class:`PartitionContainer` opens a container lazily: ``np.load`` reads
  one member per access, so a streamed run touches one partition's arrays
  at a time.  Every fetch checks the partition's CRC32 (v2; v1 containers
  have none and skip it), with the ``container.read`` fault point between
  the read and the check.

:func:`container_from_graph` writes a resident graph as a container, so
tests hold container runs against the resident engine on graphs that fit
both.  ``python -m repro_torch.data.graphs OUT.npz V E PARTITIONS [SEED]``
builds one from the command line.
"""
from __future__ import annotations

import os
import zlib
from typing import Iterator

import numpy as np

from ..core import faults
from ..core import graph as G
from ..errors import ChecksumError, GraphValidationError

# v2 adds per-partition CRC32 checksums (member ``checksums``), checked on
# every fetch; v1 containers (no checksums) still load.
CONTAINER_VERSION = 2
_DEFAULT_CHUNK_EDGES = 2_000_000


def rmat_edge_chunks(num_vertices: int, num_edges: int, *, seed: int = 0,
                     chunk_edges: int = _DEFAULT_CHUNK_EDGES
                     ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield an R-MAT edge set as ``(src, dst)`` chunks of at most
    ``chunk_edges`` edges: chunk ``i`` is :func:`~repro_torch.core.graph.
    rmat_edges` at seed ``seed * 1_000_003 + i``, ``num_edges`` in all."""
    if chunk_edges < 1:
        raise ValueError("chunk_edges must be >= 1")
    done = 0
    i = 0
    while done < num_edges:
        n = min(chunk_edges, num_edges - done)
        yield G.rmat_edges(num_vertices, n, seed=seed * 1_000_003 + i)
        done += n
        i += 1


def _partition_rows(cuts: np.ndarray, out_degrees: np.ndarray,
                    in_deg_per_part: list[np.ndarray],
                    width: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact per-partition width-``width`` ELL row counts ``(push, pull)``:
    ``sum(ceil(out_deg / width))`` over a partition's interval, and
    ``sum(ceil(in_deg_p / width))`` over its per-destination counts."""
    parts = len(cuts) - 1
    deg = np.asarray(out_degrees, np.int64)
    push = np.asarray([
        int((-(-deg[cuts[p]:cuts[p + 1]] // width)).sum())
        for p in range(parts)], np.int64)
    pull = np.asarray([
        int((-(-np.asarray(d, np.int64) // width)).sum())
        for d in in_deg_per_part], np.int64)
    return push, pull


def _partition_crc(off: np.ndarray, dst: np.ndarray,
                   wgt: np.ndarray | None) -> int:
    """CRC32 over one partition's stored members in member order (offsets,
    destinations, weights when present): the bytes the build wrote."""
    crc = zlib.crc32(np.ascontiguousarray(off).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(dst).tobytes(), crc)
    if wgt is not None:
        crc = zlib.crc32(np.ascontiguousarray(wgt).tobytes(), crc)
    return crc & 0xFFFFFFFF


def _finalize_container(path: str, num_vertices: int, *,
                        cuts: np.ndarray, out_degrees: np.ndarray,
                        part_src: list[np.ndarray],
                        part_dst: list[np.ndarray],
                        part_wgt: list[np.ndarray] | None,
                        seed: int, width: int = 8) -> str:
    """Sort each partition by source, rebase its offsets, write the .npz."""
    parts = len(cuts) - 1
    members: dict[str, np.ndarray] = {}
    edges_per_part = np.zeros(parts, np.int64)
    checksums = np.zeros(parts, np.int64)
    in_deg_per_part = []
    for p in range(parts):
        lo, hi = int(cuts[p]), int(cuts[p + 1])
        src, dst = part_src[p], part_dst[p]
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        off = np.zeros(hi - lo + 1, np.int64)
        np.cumsum(np.bincount(src - lo, minlength=hi - lo), out=off[1:])
        members[f"p{p}_offsets"] = off
        members[f"p{p}_dst"] = dst.astype(np.int32)
        wgt = None
        if part_wgt is not None:
            wgt = part_wgt[p][order]
            members[f"p{p}_wgt"] = wgt
        checksums[p] = _partition_crc(off, members[f"p{p}_dst"], wgt)
        edges_per_part[p] = len(dst)
        in_deg_per_part.append(np.bincount(dst, minlength=num_vertices))
    push_rows, pull_rows = _partition_rows(cuts, out_degrees,
                                           in_deg_per_part, width)
    members.update(
        meta=np.asarray([CONTAINER_VERSION, num_vertices,
                         int(edges_per_part.sum()), parts, seed, width,
                         1 if part_wgt is not None else 0], np.int64),
        cuts=np.asarray(cuts, np.int64),
        out_degrees=np.asarray(out_degrees, np.int64),
        edges_per_partition=edges_per_part,
        push_rows=push_rows,
        pull_rows=pull_rows,
        checksums=checksums,
    )
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(path, **members)
    return path


def build_partition_container(path: str, num_vertices: int, num_edges: int,
                              *, partitions: int, seed: int = 0,
                              chunk_edges: int = _DEFAULT_CHUNK_EDGES
                              ) -> str:
    """Two-pass chunked build of an unweighted R-MAT partition container:
    no E-length array is ever held, only one chunk and the per-partition
    buffers, sized from pass 1's degrees."""
    if partitions < 1:
        raise ValueError("partitions must be >= 1")
    deg = np.zeros(num_vertices, np.int64)
    for src, _ in rmat_edge_chunks(num_vertices, num_edges, seed=seed,
                                   chunk_edges=chunk_edges):
        deg += np.bincount(src, minlength=num_vertices)
    cuts = G.edge_interval_cuts(deg, partitions)
    cum = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(deg, out=cum[1:])
    counts = cum[cuts[1:]] - cum[cuts[:-1]]
    part_src = [np.empty(int(n), np.int32) for n in counts]
    part_dst = [np.empty(int(n), np.int32) for n in counts]
    cursor = np.zeros(partitions, np.int64)
    for src, dst in rmat_edge_chunks(num_vertices, num_edges, seed=seed,
                                     chunk_edges=chunk_edges):
        pid = np.searchsorted(cuts[1:], src, side="right")
        for p in np.unique(pid):
            m = pid == p
            n = int(m.sum())
            c = int(cursor[p])
            part_src[p][c:c + n] = src[m]
            part_dst[p][c:c + n] = dst[m]
            cursor[p] += n
    if not (cursor == counts).all():
        raise RuntimeError("pass 2 diverged from pass 1 degrees")
    return _finalize_container(path, num_vertices, cuts=cuts,
                               out_degrees=deg, part_src=part_src,
                               part_dst=part_dst, part_wgt=None, seed=seed)


def container_from_graph(path: str, g: G.Graph, partitions: int) -> str:
    """Write a resident :class:`~repro_torch.core.graph.Graph` as a
    container with the same edge set (and weights)."""
    deg = G._np(g.out_degrees).astype(np.int64)
    cuts = G.edge_interval_cuts(deg, partitions)
    part_src, part_dst, part_wgt = [], [], []
    for p in range(len(cuts) - 1):
        src, dst, wgt = G.partition_coo(g, int(cuts[p]), int(cuts[p + 1]))
        part_src.append(src)
        part_dst.append(dst)
        part_wgt.append(wgt)
    return _finalize_container(path, g.num_vertices, cuts=cuts,
                               out_degrees=deg, part_src=part_src,
                               part_dst=part_dst, part_wgt=part_wgt, seed=-1)


class PartitionContainer:
    """Lazy view over a partition-container ``.npz``.

    Quacks like a graph for planning (``num_vertices``, ``num_edges``,
    ``out_degrees``) and serves one partition's COO at a time
    (:meth:`partition_coo`) for the store's layout builds; opening one
    reads metadata only.
    """

    def __init__(self, path: str):
        self.path = path
        self._z = np.load(path)
        meta = self._z["meta"]
        if int(meta[0]) not in (1, CONTAINER_VERSION):
            raise ValueError(f"container version {int(meta[0])} not in "
                             f"(1, {CONTAINER_VERSION}) ({path})")
        self.version = int(meta[0])
        self.num_vertices = int(meta[1])
        self.num_edges = int(meta[2])
        self.partitions = int(meta[3])
        self.seed = int(meta[4])
        self.width = int(meta[5])
        self.weighted = bool(meta[6])
        self.cuts = self._z["cuts"]
        self.edges_per_partition = self._z["edges_per_partition"]
        self.push_rows = self._z["push_rows"]
        self.pull_rows = self._z["pull_rows"]
        self.checksums = self._z["checksums"] if self.version >= 2 else None
        # the cheap metadata invariants, checked at load
        if self.cuts.shape != (self.partitions + 1,):
            raise GraphValidationError(
                f"container cuts shape {self.cuts.shape} != "
                f"({self.partitions + 1},) ({path})")
        if int(self.edges_per_partition.sum()) != self.num_edges:
            raise GraphValidationError(
                f"container partition edge counts sum to "
                f"{int(self.edges_per_partition.sum())}, meta says "
                f"{self.num_edges} ({path})")

    @property
    def out_degrees(self) -> np.ndarray:
        return self._z["out_degrees"]

    def partition_coo(self, p: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Partition ``p``'s edges as global-id COO ``(src, dst, wgt)``.

        Every fetch re-reads the members and, on v2, checks their CRC32
        against the build's, raising :class:`~repro_torch.errors.
        ChecksumError` on a mismatch; the ``container.read`` fault point
        sits between the read and the check.
        """
        lo, hi = int(self.cuts[p]), int(self.cuts[p + 1])
        off = self._z[f"p{p}_offsets"]
        dst = self._z[f"p{p}_dst"]
        wgt = self._z[f"p{p}_wgt"] if self.weighted else None
        got = faults.trip("container.read",
                          payload={"offsets": off, "dst": dst, "wgt": wgt})
        off, dst, wgt = got["offsets"], got["dst"], got["wgt"]
        if self.checksums is not None:
            crc = _partition_crc(off, dst, wgt)
            want = int(self.checksums[p]) & 0xFFFFFFFF
            if crc != want:
                raise ChecksumError(
                    f"partition {p} checksum mismatch: computed "
                    f"{crc:#010x}, container records {want:#010x} "
                    f"({self.path})", partition=p)
        src = np.repeat(np.arange(lo, hi, dtype=np.int32), np.diff(off))
        if wgt is None:
            wgt = np.ones(len(dst), np.float32)
        return src, dst, wgt

    def verify(self) -> None:
        """Checksum every partition now (the stream checks lazily)."""
        for p in range(self.partitions):
            self.partition_coo(p)

    def validate_partitions(self, *, reduce: str | None = None) -> None:
        """:func:`~repro_torch.core.graph.validate_graph`'s checks, one
        partition at a time (``translate(..., validate=True)`` on a
        container): each rebased CSR lifted to a full-V offsets table and
        checked, a failure raising
        :class:`~repro_torch.errors.GraphValidationError` that names the
        partition."""
        V = self.num_vertices
        for p in range(self.partitions):
            lo, hi = int(self.cuts[p]), int(self.cuts[p + 1])
            off = np.asarray(self._z[f"p{p}_offsets"], np.int64)
            dst = np.asarray(self._z[f"p{p}_dst"])
            wgt = np.asarray(self._z[f"p{p}_wgt"]) if self.weighted \
                else np.ones(len(dst), np.float32)
            if off.shape != (hi - lo + 1,):
                raise GraphValidationError(
                    f"partition {p} offsets shape {off.shape} != "
                    f"({hi - lo + 1},) for interval [{lo}, {hi}) "
                    f"({self.path})")
            full_off = np.zeros(V + 1, np.int64)
            full_off[lo:hi + 1] = off
            full_off[hi + 1:] = off[-1]
            try:
                G.validate_graph(
                    G.Graph(vertex_values=np.zeros(V, np.float32),
                            edge_offsets=full_off, edges_dst=dst,
                            edge_weights=wgt, num_vertices=V,
                            num_edges=int(len(dst))),
                    reduce=reduce)
            except GraphValidationError as e:
                raise GraphValidationError(
                    f"partition {p} of {self.path}: {e}") from e

    def to_graph(self) -> G.Graph:
        """The whole container as a resident graph (graphs that fit)."""
        srcs, dsts, wgts = zip(*(self.partition_coo(p)
                                 for p in range(self.partitions)))
        return G.from_edge_list(
            np.concatenate(srcs), np.concatenate(dsts),
            num_vertices=self.num_vertices,
            weights=np.concatenate(wgts), sort=False)

    def close(self) -> None:
        self._z.close()


def load_partition_container(path: str) -> PartitionContainer:
    """Open a partition container lazily (metadata read, members later)."""
    return PartitionContainer(path)


def main(argv: list[str] | None = None) -> None:
    """CLI: ``python -m repro_torch.data.graphs OUT.npz V E PARTITIONS
    [SEED]``."""
    import sys
    args = sys.argv[1:] if argv is None else argv
    if len(args) not in (4, 5):
        print("usage: python -m repro_torch.data.graphs OUT.npz "
              "NUM_VERTICES NUM_EDGES PARTITIONS [SEED]", file=sys.stderr)
        raise SystemExit(2)
    out, v, e, p = args[0], int(args[1]), int(args[2]), int(args[3])
    seed = int(args[4]) if len(args) == 5 else 0
    path = build_partition_container(out, v, e, partitions=p, seed=seed)
    c = load_partition_container(path)
    print(f"wrote {path}: |V|={c.num_vertices} |E|={c.num_edges} "
          f"partitions={c.partitions} "
          f"edges/part={c.edges_per_partition.tolist()}")


if __name__ == "__main__":
    main()
