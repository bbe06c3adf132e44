"""Port parity: 2L's Hopper design on the CPU: the warp-a-grid-block fold,
the pre-pass that writes live messages only and the flags built on the
card.

The kernels (``csrc/edge_block.cu``'s ``edge_block_skip_fold_kernel``,
``csrc/lanes.cuh``'s ``lanes_pack_kernel`` under ``mask_inactive``,
``lanes_vertex_words_kernel`` and ``lanes_block_words_kernel``) run only
on the card, where ``chip_smoke.py`` holds them against their plain
versions.  Here:

* the fold's decomposition (a warp a grid block of ``block_rows`` sub-rows,
  32 / K row streams of consecutive rows, each run of equal owners folded
  in a stream, whole runs stored plainly, pieces that cross a stream, warp
  or grid-block edge combined in a shuffled order as the atomics would,
  dead blocks and dead lanes writing nothing) is modelled in numpy and held
  bit for bit against the plain version of the fold on the flags (the
  model follows the kernel's stream split, which a test reads from the
  kernel's source);
* the pre-pass's plain tables under ``mask_inactive`` against the
  unmasked ones (bits equal the frontiers, messages equal at every vertex
  active in a lane of the launch, nothing written elsewhere);
* the flags pass's plain version (``lane_block_words_plain``) against
  ``pull_bitmap.grid_block_live`` bit for bit, against the JAX package's
  grid liveness under ``jax.vmap`` (what ``_kernel_skip`` reads), and its
  counters against the single-lane kernel path's;

over K = 1, 4, 8 and 32 lanes a launch, ragged last grid blocks, owner runs
that cross grid-block edges, and all-dead and one-lane words.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import graph as RG
from repro.kernels import ops as rops

import torch
from repro_torch.core import graph as G
from repro_torch.kernels import edge_block as teb
from repro_torch.kernels import pull_bitmap as tpb
from repro_torch.kernels import push_ell as tpe
from repro_torch.kernels import ref as tref
from test_torch_lane_fold import _bits, _combine_runs, _improves, _keys
from torch_threads import one_thread  # noqa: F401

V = 140
HUB = 3                     # receives 1,500 in-edges: a run of 188 sub-rows
KS = (1, 4, 8, 32)          # lanes a launch, the kernels' built widths
GRIDS = (128, 37, 5)        # grid block rows: ragged last blocks throughout


@pytest.fixture(scope="module")
def graph():
    """JAX and port graphs with a hub whose in-row splits into sub-rows
    that cross grid-block edges at every grid of ``GRIDS``, their flat pull
    view and forward ELL."""
    rng = np.random.default_rng(31)
    src = np.concatenate([rng.integers(0, V, 1200),
                          rng.integers(0, V, 1500)])
    dst = np.concatenate([rng.integers(0, V, 1200), np.full(1500, HUB)])
    w = rng.uniform(0.5, 4.0, len(src)).astype(np.float32)
    rg = RG.from_edge_list(src, dst, weights=w, num_vertices=V)
    tg = G.from_edge_list(src, dst, weights=w, num_vertices=V)
    plan = G.pull_bitmap_plan(G.bucketize(G.reverse(tg), max_width=2048))
    fe = G.forward_ell(tg, width=8)
    owner = plan.owner8.numpy()
    hub = np.flatnonzero(owner == HUB)
    for gb in GRIDS:
        assert hub[0] // gb != hub[-1] // gb      # crosses a grid edge
        assert owner.shape[0] % gb               # a ragged last block
    return rg, tg, plan, fe


def _state(rng, kk, dtype, frac=0.3):
    """A (kk, V) state: int32 values with adds that wrap, or float32 with
    NaN and a third of +0 and -0, lanes >= 0 and lanes <= 0; frontiers."""
    if dtype == np.int32:
        vals = rng.integers(-50, 50, (kk, V)).astype(np.int32)
        vals[:, :2] = 2**31 - 1
    else:
        vals = rng.uniform(0, 5, (kk, V)).astype(np.float32)
        zero = rng.random((kk, V)) < 0.33
        vals[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
        vals[1::2] *= -1
        vals[rng.random((kk, V)) < 0.03] = np.nan
    act = rng.random((kk, V)) < frac
    return torch.as_tensor(vals), torch.as_tensor(act)


def _flags(rng, kk, nblk):
    """Random (kk, nblk) flags with an all-dead block, a block live in one
    lane only and an all-dead lane."""
    flags = rng.random((kk, nblk)) < 0.5
    flags[:, 0] = False                       # a word of 0
    if nblk > 1:
        flags[:, 1] = False
        flags[kk // 2, 1] = True              # a one-lane word
    flags[kk - 1] = False                     # a lane dead everywhere
    return torch.as_tensor(flags)


def _words(flags, lanes, block_rows):
    """``BlockWords`` of ``flags``' rows ``lanes`` (the kernels' packing:
    bit l of launch c for lane ``lanes[32 c + l]``)."""
    chunks = -(-len(lanes) // 32)
    nblk = flags.shape[1]
    w = np.zeros((chunks, nblk), np.int64)
    for j, i in enumerate(lanes):
        w[j // 32] |= flags[i].numpy().astype(np.int64) << (j % 32)
    w = np.where(w >= 2**31, w - 2**32, w).astype(np.int32)
    return teb.BlockWords(tuple(lanes), block_rows, torch.as_tensor(w))


# ---------------------------------------------------------------------------
# (a) the fold: a warp a grid block, row streams, runs, whole and pieces
# ---------------------------------------------------------------------------


# The kernel's stream split, as ``edge_block_skip_fold_kernel`` states it
# (``test_skip_fold_model_tracks_the_kernel`` finds these lines in its
# source, so a change there fails until the model below follows): a warp a
# grid block of n rows, S = 32 / K row streams, stream s the rows
# [r0 + min(n, s per), r0 + min(n, (s + 1) per)) with per = ceil(n / S).
_KERNEL_STREAM_LINES = (
    "constexpr int S = 32 / K;",
    "const long long n = min(block_rows, rows - r0);",
    "const long long per = (n + S - 1) / S;",
    "const long long sa = r0 + min(n, s * per);",
    "const long long sb = r0 + min(n, (s + 1) * per);",
    "const int l = t % K;",
    "const int s = t / K;")


def _streams(R, block_rows, K):
    """Each sub-row's (grid block, stream) key, by the kernel's split
    (``_KERNEL_STREAM_LINES``): stream s of block b holds the rows
    ``[r0 + min(n, s per), r0 + min(n, (s + 1) per))``."""
    S = 32 // K
    key = np.empty(R, np.int64)
    for b in range(-(-R // block_rows)):
        r0 = b * block_rows
        n = min(block_rows, R - r0)
        per = -(-n // S)
        for s in range(S):
            sa, sb = r0 + min(n, s * per), r0 + min(n, (s + 1) * per)
            key[sa:sb] = b * S + s
    return key


def _skip_fold_decomposed(plan, values, degrees, active, lanes, flags,
                          block_rows, *, gather, reduce, order_seed):
    """``edge_block_skip_fold_kernel`` in numpy (a model that must track
    the kernel: its stream split is ``_streams``', held to the kernel's
    source by ``test_skip_fold_model_tracks_the_kernel``; its runs,
    stores and atomics are the kernel's ``flush``): per launch of at most
    32 lanes (K its built width) and lane, each sub-row's partial as
    kernel 2
    gives it under the lane's flags (a dead block's rows: identity, not
    live), folded by runs of equal owners inside each row stream; a run
    that is not its stream's first owner continuing from the row before
    the stream, nor its last owner continuing past it, stored plainly; the
    others combined into the identity-filled table as the atomics do, in a
    shuffled order; a run whose combine is the identity writes no value,
    got set for a run with a live slot."""
    kk, Vn = values.shape
    dtype = np.float32 if values.dtype.is_floating_point else np.int32
    ident = np.asarray(tref._identity(reduce, values.dtype), dtype)
    owner = plan.owner8.numpy().astype(np.int64)
    R = owner.shape[0]
    red = np.full((kk, Vn), ident, dtype)
    got = np.zeros((kk, Vn), bool)
    atomics = []
    for lo in range(0, len(lanes), 32):
        chunk = lanes[lo:lo + 32]
        K = next(w for w in (1, 4, 8, 32) if w >= len(chunk))
        key = _streams(R, block_rows, K)
        new = np.r_[True, (key[1:] != key[:-1]) | (owner[1:] != owner[:-1])]
        first = np.flatnonzero(new)
        last = np.r_[first[1:], R] - 1
        o = owner[first]
        # each run's stream: its first and last row (sa, sb - 1)
        s_first = np.r_[True, key[1:] != key[:-1]]
        sid = np.cumsum(s_first) - 1
        sa = np.flatnonzero(s_first)[sid[first]]
        se = np.r_[np.flatnonzero(s_first)[1:], R][sid[first]] - 1
        # the stream's first owner going on from the row before the
        # stream, or its last owner going on past it: a piece
        head_shared = (owner[sa] == o) & (sa > 0) & (
            owner[np.maximum(sa - 1, 0)] == o)
        tail_shared = (owner[se] == o) & (se + 1 < R) & (
            owner[np.minimum(se + 1, R - 1)] == o)
        piece = (o < Vn) & (head_shared | tail_shared)
        whole = (o < Vn) & ~piece
        parts = [teb.edge_block_reduce_plain(
            plan.flat_dst, plan.flat_wgt, values[i], degrees, active[i],
            gather=gather, reduce=reduce, mask_inactive=True,
            block_live=flags[i], block_rows=block_rows) for i in chunk]
        acc = torch.stack([p[0] for p in parts]).numpy()
        any_run = np.logical_or.reduceat(
            torch.stack([p[1] for p in parts]).numpy(), first, axis=1)
        run = _combine_runs(acc, first, reduce)
        writes = (_keys(run) != _keys(np.broadcast_to(ident, run.shape))) \
            & any_run
        if dtype == np.float32:
            writes |= np.isnan(run) & any_run
        for j, row in enumerate(chunk):
            np.logical_or.at(got[row], o[o < Vn], any_run[j, o < Vn])
            writes_j = [(True, row, int(v), x) for v, x in
                        zip(o[whole & writes[j]], run[j, whole & writes[j]])]
            writes_j += [(False, row, int(v), x) for v, x in
                         zip(o[piece & writes[j]], run[j, piece & writes[j]])]
            atomics += writes_j
    # stores and atomics land in any order: a plain store must be the only
    # write its entry gets, or it would overwrite another piece
    stored = [(row, v) for plain, row, v, _ in atomics if plain]
    combined = {(row, v) for plain, row, v, _ in atomics if not plain}
    assert len(set(stored)) == len(stored)
    assert not set(stored) & combined
    for i in np.random.default_rng(order_seed).permutation(len(atomics)):
        plain, row, v, x = atomics[i]
        if plain:
            red[row, v] = x
        elif reduce == "add":
            red[row, v] = (int(red[row, v]) + int(x) + 2**31) % 2**32 - 2**31
        elif _improves(red[row, v], x, reduce, dtype == np.float32):
            red[row, v] = x
    return torch.as_tensor(red), torch.as_tensor(got)


_SKIP_CASES = [("plus_one", "min", np.int32), ("copy", "max", np.int32),
               ("mul_w", "add", np.int32), ("add_w", "min", np.float32),
               ("div_deg", "max", np.float32)]


@pytest.mark.parametrize("block_rows", GRIDS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("gather,reduce,dtype", _SKIP_CASES)
def test_skip_fold_decomposition_matches_plain(graph, gather, reduce, dtype,
                                               k, block_rows):
    """The warp-a-grid-block fold's algorithm equals the fold's plain
    version on the same flags (words built from them), bit for bit:
    values, got, and rows left out of the launch untouched; a hub's run of
    sub-rows crosses streams, warps and grid blocks; NaN, +0/-0 ties and
    int32 adds that wrap; an all-dead word, a one-lane word and a lane
    dead everywhere."""
    _, tg, plan, _ = graph
    R = plan.flat_dst.shape[0]
    nblk = -(-R // block_rows)
    deg = tg.out_degrees.to(torch.int32)
    rng = np.random.default_rng(k * 131 + block_rows + len(gather))
    kk = k + 2
    vals, act = _state(rng, kk, dtype)
    flags = _flags(rng, kk, nblk)
    lanes = [int(i) for i in rng.permutation(kk)[:k]]
    if kk - 1 not in lanes:
        lanes[-1] = kk - 1                    # the dead lane is swept
    kw = dict(gather=gather, reduce=reduce)
    want = teb.edge_block_fold_lanes(plan, vals, deg, act, lanes,
                                     block_words=_words(flags, lanes,
                                                        block_rows), **kw)
    same = teb.edge_block_fold_lanes_plain(plan, vals, deg, act, lanes,
                                           block_live=flags,
                                           block_rows=block_rows, **kw)
    red, got = _skip_fold_decomposed(plan, vals, deg, act, lanes, flags,
                                     block_rows, order_seed=k, **kw)
    np.testing.assert_array_equal(_bits(red), _bits(want[0]))
    assert torch.equal(got, want[1])
    for a, b in zip(want, same):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    ident = tref._identity(reduce, vals.dtype)
    out = [i for i in range(kk) if i not in lanes]
    assert bool((want[0][out] == ident).all()) and not want[1][out].any()
    assert not want[1][kk - 1].any()          # the dead lane wrote nothing


def test_skip_fold_streams_cover_each_block(graph):
    """The row streams of every grid block cover its rows once, in order,
    and each stream's rows are consecutive: ``_streams`` keys ascend."""
    _, _, plan, _ = graph
    R = plan.flat_dst.shape[0]
    for K in KS:
        for gb in GRIDS:
            key = _streams(R, gb, K)
            assert (np.diff(key) >= 0).all()
            b = np.arange(R) // gb
            assert (key // (32 // K) == b).all()


def test_skip_fold_model_tracks_the_kernel():
    """The stream split ``_streams`` models is the one
    ``edge_block_skip_fold_kernel`` runs: its lines stand in the kernel's
    body in ``csrc/edge_block.cu``, and the kernel builds for the lane
    widths the model covers."""
    from pathlib import Path
    src = (Path(teb.__file__).parent.parent / "csrc" /
           "edge_block.cu").read_text()
    body = src[src.index("edge_block_skip_fold_kernel("):]
    body = body[:body.index("\n}\n")]
    flat = " ".join(body.split())
    for line in _KERNEL_STREAM_LINES:
        assert " ".join(line.split()) in flat, line
    for K in KS:
        assert f"launch_lanes<T, G, R, {K}>" in src


# ---------------------------------------------------------------------------
# (b) the pre-pass: messages of the launch's active vertices only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", KS + (17, 33))
@pytest.mark.parametrize("gather,dtype", [("plus_one", np.int32),
                                          ("copy", np.float32),
                                          ("div_deg", np.float32),
                                          ("mul_w", np.int32)])
def test_live_only_prepass_matches_full(graph, gather, dtype, k):
    """``lanes_prepare_plain`` under ``mask_inactive``: each vertex's K
    frontier bits equal its lanes' ``active``, its messages equal the
    unmasked pre-pass's full table at every vertex active in some lane of
    the launch and are written nowhere else; k of 17 and 33 lanes pad to
    K = 32 and take two launches."""
    _, tg, _, _ = graph
    deg = tg.out_degrees.to(torch.int32)
    rng = np.random.default_rng(k + len(gather))
    kk = k + 3
    vals, act = _state(rng, kk, dtype, frac=0.02)
    act[kk - 1] = False
    lanes = [int(i) for i in rng.permutation(kk)[:k]]
    full = teb.lanes_prepare_plain(vals, deg, act, lanes, gather=gather,
                                   mask_inactive=False)
    live = teb.lanes_prepare_plain(vals, deg, act, lanes, gather=gather)
    assert len(full) == len(live) == -(-k // 32)
    for (lo, kc, K, bits, msg, written), (lo2, kc2, K2, bits2, msg2,
                                          written2) in zip(full, live):
        assert (lo, kc, K) == (lo2, kc2, K2)
        assert bits is None
        rows = lanes[lo:lo + kc]
        word = bits2.to(torch.int64) & 0xFFFFFFFF
        u = torch.arange(V)
        for j, i in enumerate(rows):
            at = u * K + j
            assert torch.equal(((word[at // 32] >> (at % 32)) & 1) != 0,
                               act[i])
        assert bool(written.all())
        assert torch.equal(written2, act[rows].any(0))
        m, m2 = msg.view(V, K), msg2.view(V, K)
        np.testing.assert_array_equal(_bits(m[written2]), _bits(m2[written2]))
        assert not bool((m2[~written2] != 0).any())
        for j, i in enumerate(rows):
            want = tref.gather_msg(gather, vals[i], torch.ones_like(vals[i]),
                                   deg) if gather in ("plus_one", "div_deg") \
                else vals[i]
            np.testing.assert_array_equal(_bits(m[:, j]), _bits(want))


def test_live_only_needs_mask(graph):
    """Messages are left out only under mask_inactive: an unmasked launch
    reads every vertex's messages, so its pre-pass writes them all, even
    where no lane is active; on CPU tensors the wrapper's ``Prepared``
    carries no tables and no launch is counted."""
    _, tg, _, _ = graph
    deg = tg.out_degrees.to(torch.int32)
    vals, act = _state(np.random.default_rng(2), 3, np.int32)
    act[:, :V // 2] = False
    for mask in (False, True):
        (_, _, K, bits, msg, written), = teb.lanes_prepare_plain(
            vals, deg, act, [0, 2], gather="copy", mask_inactive=mask)
        assert (bits is not None) == mask
        assert bool(written.all()) != mask
        assert torch.equal(written, act[[0, 2]].any(0) if mask
                           else torch.ones(V, dtype=torch.bool))
        np.testing.assert_array_equal(
            _bits(msg.view(V, K)[written, :2]),
            _bits(vals[[0, 2]].t()[written]))
    for mask in (False, True):
        prep = teb.lanes_prepare(vals, deg, act, [2, 0], gather="copy",
                                 mask_inactive=mask)
        assert prep.chunks == () and prep.mask_inactive == mask
    assert teb.lanes_prepare.launches == 0


# ---------------------------------------------------------------------------
# (c) the flags pass: words a grid block from the touched tables
# ---------------------------------------------------------------------------


def _touched(rng, fe, kk, sizes):
    """Each lane's touched table for a random frontier of ``sizes[i]``
    vertices (0: a lane that touches nothing)."""
    act = torch.zeros((kk, V), dtype=torch.bool)
    for i, n in enumerate(sizes):
        if n:
            act[i, torch.as_tensor(rng.choice(V, n, replace=False))] = True
    touched = tpe.push_lanes_touched(fe.row_src, fe.dst, act, range(kk),
                                     num_rows=fe.num_rows)
    return act, touched


@pytest.mark.parametrize("block_rows", GRIDS)
@pytest.mark.parametrize("k", KS + (33,))
def test_block_words_equal_grid_block_live(graph, k, block_rows):
    """The flags pass's plain version: its words decode to
    ``grid_block_live``'s flags bit for bit (the wide lanes all live), one
    int32 row a launch of 32 lanes; a lane that touches nothing gives no
    bit, a lane touching one vertex one bit a block of its owner."""
    _, _, plan, fe = graph
    R = plan.flat_dst.shape[0]
    nblk = -(-R // block_rows)
    rng = np.random.default_rng(k * 7 + block_rows)
    kk = k + 2
    sizes = [int(x) for x in rng.integers(1, 4, kk)]
    sizes[0] = 0
    _, touched = _touched(rng, fe, kk, sizes)
    lanes = [int(i) for i in rng.permutation(kk)[:k]]
    wide = lanes[1:2] if k > 1 else []
    bw, counts = teb.lane_block_words(touched, plan.owner8, lanes,
                                      block_rows, wide=wide)
    assert counts is None
    assert bw.lanes == tuple(lanes) and bw.block_rows == block_rows
    assert tuple(bw.words.shape) == (-(-k // 32), nblk)
    flags = teb.block_words_flags(bw, kk)
    want = tpb.grid_block_live(touched, plan.owner8, block_rows)
    for i in range(kk):
        if i in wide:
            assert bool(flags[i].all())
        elif i in lanes:
            assert torch.equal(flags[i], want[i]), i
        else:
            assert not flags[i].any()
    if 0 in lanes and 0 not in wide:
        assert not flags[0].any()             # touches nothing
    # words equal the packing of the flags
    assert torch.equal(bw.words, _words(flags, lanes, block_rows).words)


@pytest.mark.parametrize("block_rows", GRIDS)
def test_block_words_match_jax_grid_liveness(graph, block_rows):
    """Each lane's grid flags from the words equal the JAX package's grid
    liveness under ``jax.vmap`` (the bitmap plane's Pallas path: the
    touched table at each sub-row's owner, padded to whole grid blocks,
    any a block; the ``block_live`` its ``_kernel_skip`` reads), on the
    JAX ``touched_frontier`` tables of each lane's frontier."""
    rg, _, plan, fe = graph
    R = plan.flat_dst.shape[0]
    rng = np.random.default_rng(block_rows)
    kk = 8
    act, touched = _touched(rng, fe, kk, [0, 1, 1, 2, 3, 5, 9, 20])
    ref = jax.vmap(lambda a: rops.touched_frontier(
        jnp.asarray(fe.row_src.numpy()), jnp.asarray(fe.dst.numpy()), a,
        num_rows=fe.num_rows, capacity=fe.num_rows, num_vertices=V))(
            jnp.asarray(act.numpy()))
    owner8 = jnp.asarray(plan.owner8.numpy())
    pad = (-R) % block_rows

    def grid_live(t):
        t8 = t[owner8] != 0
        return jnp.pad(t8, (0, pad)).reshape(-1, block_rows).any(axis=1)

    want = np.asarray(jax.jit(jax.vmap(grid_live))(ref))
    lanes = [5, 0, 7, 2, 1, 6, 3, 4]
    bw, _ = teb.lane_block_words(touched, plan.owner8, lanes, block_rows)
    np.testing.assert_array_equal(teb.block_words_flags(bw, kk).numpy(),
                                  want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("grid_rows,slots", [(4, 8), (4, 16), (128, 64)])
@pytest.mark.parametrize("k", KS)
def test_block_words_counters_match_single_lane(graph, k, grid_rows, slots):
    """The counters the flags pass sums (each narrow lane's plan blocks
    and edges over its live grid blocks, the translator's
    ``grid_blocks``/``grid_edges``) equal what the single-lane kernel path
    counts for that lane (its grid flags repeated to the plan blocks, as
    ``test_kernel_path_counters_match_single_lane`` holds them); wide
    lanes count 0."""
    _, tg, _, fe = graph
    from repro_torch.core import preprocess as TP
    pplan = TP.layouts_for(tg).pull_plan(slots)
    br, b_total = pplan.block_rows, pplan.num_blocks
    assert grid_rows % br == 0
    per = grid_rows // br
    pad = -(-pplan.num_subrows // grid_rows) * per - b_total
    grid_blocks = torch.nn.functional.pad(torch.ones_like(
        pplan.block_edges, dtype=torch.int64), (0, pad)).view(-1, per).sum(1)
    grid_edges = torch.nn.functional.pad(
        pplan.block_edges.long(), (0, pad)).view(-1, per).sum(1)
    rng = np.random.default_rng(k + grid_rows + slots)
    kk = k + 1
    sizes = [int(x) for x in rng.integers(0, 6, kk)]
    _, touched = _touched(rng, fe, kk, sizes)
    lanes = [int(i) for i in rng.permutation(kk)[:k]]
    wide = lanes[:1] if k > 1 else []
    bw, counts = teb.lane_block_words(
        touched, pplan.owner8, lanes, grid_rows, wide=wide,
        grid_blocks=grid_blocks, grid_edges=grid_edges)
    assert tuple(counts.shape) == (2, k) and counts.dtype == torch.int64
    for j, i in enumerate(lanes):
        if i in wide:
            assert int(counts[0, j]) == 0 and int(counts[1, j]) == 0
            continue
        table = torch.cat([touched[i], touched.new_zeros(1)])  # slot V
        grid_live = tpb.grid_block_live(table, pplan.owner8, grid_rows)
        fine = grid_live.repeat_interleave(per)[:b_total]
        assert int(counts[0, j]) == int(fine.sum())
        assert int(counts[1, j]) == int(torch.where(
            fine, pplan.block_edges, 0).sum())


def test_block_words_wrappers_on_cpu(graph):
    """The flags pass's and the lane kernels' arguments: counters need
    both tables, words must be for the call's lanes, not beside a flag
    table; on CPU tensors no launch is counted."""
    _, tg, plan, fe = graph
    deg = tg.out_degrees.to(torch.int32)
    rng = np.random.default_rng(4)
    _, touched = _touched(rng, fe, 4, [1, 2, 3, 0])
    with pytest.raises(ValueError, match="go together"):
        teb.lane_block_words(touched, plan.owner8, [0, 1], 8,
                             grid_blocks=torch.zeros(3, dtype=torch.int64))
    bw, _ = teb.lane_block_words(touched, plan.owner8, [0, 1], 8)
    vals, act = _state(rng, 4, np.int32)
    kw = dict(gather="copy", reduce="min")
    with pytest.raises(ValueError, match="block_words"):
        teb.edge_block_fold_lanes(plan, vals, deg, act, [1, 0],
                                  block_words=bw, **kw)
    with pytest.raises(ValueError, match="not both"):
        teb.edge_block_fold_lanes_plain(
            plan, vals, deg, act, [0, 1], block_words=bw,
            block_live=torch.ones((4, bw.words.shape[1]), dtype=torch.bool),
            block_rows=8, **kw)
    with pytest.raises(TypeError):           # the wrappers take words only
        teb.edge_block_fold_lanes(
            plan, vals, deg, act, [0, 1],
            block_live=torch.ones((4, bw.words.shape[1]), dtype=torch.bool),
            block_rows=8, **kw)
    with pytest.raises(ValueError, match="block_words"):
        teb.edge_block_reduce_lanes(plan.flat_dst, plan.flat_wgt, vals, deg,
                                    act, [0, 2], block_words=bw, **kw)
    assert teb.lane_block_words.launches == 0      # no card here
    assert teb.lanes_prepare.launches == 0
