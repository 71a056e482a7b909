"""
Small-segment elimination on the JAX device — the algorithm's hot loop.

Replaces the reference's sequential merge machinery
(reference: pyshepseg/shepseg.py:918-1123) with per-pass data-parallel
segment reductions. This relies on a structural property of the reference
algorithm: within one pass at a given targetSize,

- merge *decisions* (findMergeSegment) are all taken against a frozen
  snapshot of segSize/spectSum (shepseg.py:983-986), and
- a merge target must be strictly larger than the merging segment
  (shepseg.py:1052), so the candidate set (size == targetSize) and target
  set (size > targetSize) are disjoint — no merge chains exist inside a
  pass, and applying the merges is commutative in seg/segSize/spectSum.

The sequential application order in the reference (shepseg.py:989-994)
therefore only affects the pixel ordering inside the merged segment's
location list, which in turn can only influence later tie-breaks between
exactly-equal spectral distances. We document two deviations:

1. ties between equal-distance neighbours are broken by smallest neighbour
   segment ID (the reference breaks them by pixel scan order of the
   segment's location list);
2. distances use float32 on device (the reference's numba code promotes to
   float64).

Both only matter on exact floating-point ties.

Data-parallel formulation — GRAPH space, not image space
--------------------------------------------------------
The reference rescans segment pixels and their 3x3 windows every pass. A
dense whole-image pass costs O(H*W) regardless of how few candidate
segments exist, and the targetSize x fixpoint loop nest runs hundreds of
passes. Key observation: segments only ever merge, so the *current*
segment adjacency is the image's original adjacency pushed through an
id-remap (orig id -> current id). We therefore:

1. extract the unique segment-adjacency edge list from the image ONCE
   (shift comparisons -> lexicographic sort -> run-length dedupe), sized
   by a host-bucketed edge capacity;
2. run every find+apply pass purely on (numEdges,) and (capacity,) arrays:
   remap edge endpoints, per-edge mean distances, two segment_min
   reductions, merge application as capacity-sized scatter-adds, and a
   remap composition (remap = mergeMap[remap]);
3. rewrite the segment image with a single gather at the very end,
   followed by the contiguous relabel.

Per-pass cost goes from O(H*W) to O(E) with E ~ 6 * numSegments (grid
adjacency is near-planar), independent of tile size.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .constants import SegIdType, SEGNULLVAL, MINSEGID
from .shifts import shift, offsets_for
from .segreduce import seg_sizes, seg_spectral_sums, relabel


def round_capacity(n: int) -> int:
    """Round a segment-count capacity up to a bucket to limit recompiles."""
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


def round_capacity_fine(n: int) -> int:
    """
    Quarter-step capacity buckets: {1, 1.25, 1.5, 1.75} x 2^k. The
    elimination loop's per-pass cost is ~linear in the EDGE capacity
    (every pass gathers ~12 edge-sized vectors), so power-of-two buckets
    waste up to 2x gather volume where quarter-steps waste at most 1.25x
    — at the price of up to 4x more distinct compiled programs (paid
    once per bucket, persistently cached).
    """
    cap = 1024
    while cap < n:
        cap *= 2
    if cap == 1024:
        return cap
    # frac=4 (cap/2) can never satisfy fine >= n: the doubling loop
    # exits only once cap >= n with cap/2 < n.
    for frac in (5, 6, 7):
        fine = (cap // 8) * frac
        if fine >= n:
            return fine
    return cap


def edge_sort_keys(seg, four_connected: bool):
    """
    Device: sorted canonical (min id, max id) segment-adjacency pairs from
    a segment image, one per adjacent pixel pair (duplicates included),
    plus the number of unique pairs. Padding/invalid slots sort to the
    end as (0xFFFFFFFF, 0xFFFFFFFF).
    """
    offsets = [(dy, dx) for dy, dx in offsets_for(four_connected)
               if (dy, dx) in ((0, 1), (1, 0), (1, 1), (1, -1))]
    pad = jnp.uint32(0xFFFFFFFF)
    a_parts, b_parts = [], []
    for dy, dx in offsets:
        nbr = shift(seg, dy, dx, SEGNULLVAL)
        ok = (seg != SEGNULLVAL) & (nbr != SEGNULLVAL) & (nbr != seg)
        lo = jnp.minimum(seg, nbr)
        hi = jnp.maximum(seg, nbr)
        a_parts.append(jnp.where(ok, lo, pad).ravel())
        b_parts.append(jnp.where(ok, hi, pad).ravel())
    a = jnp.concatenate(a_parts)
    b = jnp.concatenate(b_parts)
    a, b = jax.lax.sort((a, b), num_keys=2)
    first = (a != pad) & ((jnp.arange(a.shape[0]) == 0) |
                          (a != jnp.roll(a, 1)) | (b != jnp.roll(b, 1)))
    n_unique = jnp.sum(first.astype(jnp.uint32))
    return a, b, first, n_unique


_edge_sort_jit = jax.jit(edge_sort_keys, static_argnames=("four_connected",))


def boundary_row_stats(seg, four_connected: bool):
    """
    Device: (n_pairs, row_max) — the total boundary-pair count (adjacent
    pixel pairs in different non-null segments, duplicates included) and
    the maximum count attributable to a single image row. These size the
    one-shot path's b_cap and r_cap speculation buckets (see
    edge_sort_keys_compact); cheap mask reductions, no sort.
    """
    offsets = [(dy, dx) for dy, dx in offsets_for(four_connected)
               if (dy, dx) in ((0, 1), (1, 0), (1, 1), (1, -1))]
    per_row = 0
    for dy, dx in offsets:
        nbr = shift(seg, dy, dx, SEGNULLVAL)
        ok = (seg != SEGNULLVAL) & (nbr != SEGNULLVAL) & (nbr != seg)
        per_row = per_row + jnp.sum(ok.astype(jnp.uint32), axis=1)
    return jnp.sum(per_row), jnp.max(per_row)


def edge_sort_keys_compact(seg, four_connected: bool, b_cap: int,
                           r_cap: int, id_bound: int):
    """
    Device: edge_sort_keys with the boundary pairs ROW-COMPACTED before
    the dedup sort. The O(H*W)-key sort (2 (4-conn) or 4 (8-conn) key
    candidates per pixel, almost all padding) becomes:

    1. a batched PER-ROW sort of the (H, W*ndirs) candidate matrix along
       its minor axis (pad keys sort last, so each row's valid pairs
       compact to its front), with no scatter;
    2. a static slice to (H, r_cap) — ``r_cap`` (static) speculatively
       bounds the boundary pairs in any single image row;
    3. ONE global sort of the H*r_cap survivors, sliced to b_cap —
       ``b_cap`` (static) speculatively bounds the total pair count.

    The measured counts come back as (n_pairs, row_max); row_max > r_cap
    or n_pairs > b_cap means pairs were dropped and the caller MUST
    treat every output as overflowed (the one-shot dispatch folds both
    into its overflow flag and falls back to the measured path, exactly
    like the capacity and e_cap buckets).

    When ``id_bound`` <= 2^16 each canonical (lo, hi) pair packs into
    one uint32 (lo < hi strictly, so the 0xFFFFFFFF padding can never
    collide with a real pair) and both sorts run single-key; otherwise
    the endpoints sort two-key.

    Returns (a, b, first, n_unique, n_pairs, row_max) with a/b/first of
    length min(b_cap, H*r_cap) — same contract as edge_sort_keys plus
    the measured counts.
    """
    offsets = [(dy, dx) for dy, dx in offsets_for(four_connected)
               if (dy, dx) in ((0, 1), (1, 0), (1, 1), (1, -1))]
    pad = jnp.uint32(0xFFFFFFFF)
    packed = id_bound <= (1 << 16)
    a_parts, b_parts, per_row = [], [], 0
    for dy, dx in offsets:
        nbr = shift(seg, dy, dx, SEGNULLVAL)
        ok = (seg != SEGNULLVAL) & (nbr != SEGNULLVAL) & (nbr != seg)
        per_row = per_row + jnp.sum(ok.astype(jnp.uint32), axis=1)
        lo = jnp.minimum(seg, nbr)
        hi = jnp.maximum(seg, nbr)
        if packed:
            a_parts.append(jnp.where(ok, (lo << 16) | hi, pad))
        else:
            a_parts.append(jnp.where(ok, lo, pad))
            b_parts.append(jnp.where(ok, hi, pad))
    n_pairs = jnp.sum(per_row)
    row_max = jnp.max(per_row)
    h = seg.shape[0]
    out_len = min(b_cap, h * r_cap)
    if packed:
        k = jnp.concatenate(a_parts, axis=1)        # (H, W*ndirs)
        k = jax.lax.sort(k, dimension=1)[:, :r_cap].ravel()
        keys = jax.lax.sort(k)[:out_len]
        ca, cb = keys >> 16, keys & jnp.uint32(0xFFFF)
        ok_row = keys != pad
        neq = keys != jnp.roll(keys, 1)
    else:
        ka = jnp.concatenate(a_parts, axis=1)
        kb = jnp.concatenate(b_parts, axis=1)
        ka, kb = jax.lax.sort((ka, kb), dimension=1, num_keys=2)
        ca, cb = jax.lax.sort(
            (ka[:, :r_cap].ravel(), kb[:, :r_cap].ravel()), num_keys=2)
        ca, cb = ca[:out_len], cb[:out_len]
        ok_row = ca != pad
        neq = (ca != jnp.roll(ca, 1)) | (cb != jnp.roll(cb, 1))
    first = ok_row & ((jnp.arange(out_len) == 0) | neq)
    n_unique = jnp.sum(first.astype(jnp.uint32))
    return ca, cb, first, n_unique, n_pairs, row_max


def compact_edges(a, b, first, e_cap: int, id_bound: int = None):
    """
    Device: scatter the flagged unique pairs into fixed-size (e_cap,)
    endpoint arrays (undirected, canonical lo/hi order). Unused slots are
    (0, 0), which the pass masks out via the null-segment check.

    ``id_bound`` (static, optional): a bound on the endpoint IDs. When
    it fits 16 bits the two endpoints pack into ONE uint32 scatter
    instead of two — the scatter runs over the full-size sorted arrays
    (O(H*W) elements), so halving it saves real milliseconds per tile.
    """
    pos = jnp.cumsum(first.astype(jnp.int32)) - 1
    pos = jnp.where(first, pos, e_cap)  # dump non-unique past the end
    if id_bound is not None and id_bound <= (1 << 16):
        packed = (a << 16) | (b & jnp.uint32(0xFFFF))
        keys = jnp.zeros(e_cap + 1, jnp.uint32).at[pos].set(
            packed, mode="drop")[:e_cap]
        return keys >> 16, keys & jnp.uint32(0xFFFF)
    ea = jnp.zeros(e_cap + 1, jnp.uint32).at[pos].set(
        a, mode="drop").astype(jnp.uint32)[:e_cap]
    eb = jnp.zeros(e_cap + 1, jnp.uint32).at[pos].set(
        b, mode="drop")[:e_cap]
    return ea, eb


# Below this capacity the two per-pass segment_min reductions run as
# fused one-hot masked min reductions over an (2E, capacity) broadcast
# instead of XLA scatter-mins. The broadcast costs 2E*capacity
# elementwise work, so it only pays for small capacities. min is exact
# and order-independent, so the two forms are bit-identical. The
# threshold is not yet tuned on a GPU.
ONEHOT_MIN_MAX_CAP = 8192


def _merge_pass_edges(ids2, remap, table, target, max_diff_sqr):
    """
    One find+apply pass for segments of exactly ``target`` pixels, on the
    segment-adjacency graph. ``ids2`` is the pre-concatenated (2E,)
    ORIGINAL endpoint vector [ea | eb] (hoisted out of the loop by the
    caller); remap maps original id -> current id. Mirrors reference
    findMergeSegment + doMerge (shepseg.py:1003-1123) semantics on frozen
    per-pass state.

    OP economy is the whole game here: each pass runs ~40+ times per
    tile over arrays of a few thousand elements, so every unfused
    gather and scatter is a separate kernel launch. Hence:

    - the ENTIRE per-segment state lives in ONE (nBands+1, capacity)
      float32 table (row 0 = size, rows 1.. = band sums) that is carried
      through the loop — no per-pass re-stacking, no separate uint32
      size vector, and the merge application is ONE multi-channel
      segment_sum instead of two;
    - per-segment MEANS are computed once on the (capacity,)-sized table
      and gathered per-edge (same IEEE quotients as dividing after the
      gather — bit-identical decisions), so the big (2E,) arrays see
      only one stacked mean/size gather;
    - the two segment_min scatters (best distance, then best neighbour
      at that distance) run as fused one-hot masked MIN reductions over
      an (2E, capacity) broadcast when capacity <= ONEHOT_MIN_MAX_CAP —
      fused elementwise work instead of a scatter, and the masked
      form needs NO d_best[cur2] read-back gather (the hit test happens
      in the broadcast space). min is exact, so both forms are
      bit-identical; large capacities keep the scatter (the broadcast
      cost scales with capacity, the scatter does not).

    Sizes ride float32: candidacy (size == target) stays exact for ANY
    size (an integer < 2^24 is exactly representable; one >= 2^24 can
    never round to a small target), the strictly-larger test compares a
    candidate's exact small size against a neighbour whose rounding
    only moves it toward other huge values, and a merged-away segment's
    size is exactly 0 (x - x + 0). Size ACCUMULATION (target += moved)
    is exact while sizes stay below 2^24 pixels; beyond that the stored
    size may round to an even neighbour — harmless for every decision
    above, and flagged in eliminate_small_segments_graph's docstring.
    """
    capacity = table.shape[1]
    E2 = ids2.shape[0]
    E = E2 // 2
    inf = jnp.float32(jnp.inf)
    big_id = jnp.uint32(0xFFFFFFFF)
    ids = jnp.arange(capacity, dtype=jnp.uint32)

    size = table[0]
    ftarget = target.astype(jnp.float32)
    is_cand = (size == ftarget) & (ids >= MINSEGID)
    # division (not reciprocal-multiply) keeps the arithmetic identical
    # to the original mean = sum/size formulation
    mtab = jnp.concatenate(
        [size[None], table[1:] / jnp.maximum(size, 1.0)[None]])

    cur2 = remap[ids2].astype(jnp.int32)                # (2E,) gather #1
    cur_a, cur_b = cur2[:E], cur2[E:]
    live = (cur_a != cur_b) & (cur_a != SEGNULLVAL) & (cur_b != SEGNULLVAL)

    g2 = mtab[:, cur2]                                  # gather #2
    size2 = g2[0]
    size_a, size_b = size2[:E], size2[E:]
    cand_a = (size_a == ftarget) & (cur_a >= MINSEGID)
    cand_b = (size_b == ftarget) & (cur_b >= MINSEGID)
    means = g2[1:]                                      # (nBands, 2E)
    diff = means[:, :E] - means[:, E:]
    d2u = jnp.sum(diff * diff, axis=0)

    ok_ab = live & cand_a & (size_b > size_a)        # a merges into b
    ok_ba = live & cand_b & (size_a > size_b)        # b merges into a
    d2 = jnp.concatenate([jnp.where(ok_ab, d2u, inf),
                          jnp.where(ok_ba, d2u, inf)])
    nbr = jnp.concatenate([
        jnp.where(ok_ab, cur_b.astype(jnp.uint32), big_id),
        jnp.where(ok_ba, cur_a.astype(jnp.uint32), big_id)])

    if capacity <= ONEHOT_MIN_MAX_CAP:
        # fused one-hot masked mins (see the docstring): XLA fuses the
        # broadcast-compare-select into the reductions, so nothing
        # (2E, capacity)-sized ever materialises in HBM
        oh = cur2[:, None] == jnp.arange(capacity, dtype=jnp.int32)[None]
        d_best = jnp.min(jnp.where(oh, d2[:, None], inf), axis=0)
        hit = oh & (d2[:, None] == d_best[None, :])
        best_nbr = jnp.min(jnp.where(hit, nbr[:, None], big_id), axis=0)
    else:
        d_best = jax.ops.segment_min(d2, cur2, num_segments=capacity)
        nb_hit = jnp.where(d2 == d_best[cur2], nbr, big_id)
        best_nbr = jax.ops.segment_min(nb_hit, cur2,
                                       num_segments=capacity)

    # Spectral-difference limit (reference: shepseg.py:1060-1061, strict >)
    merge_to = jnp.where(
        is_cand & (best_nbr != big_id) & (d_best <= max_diff_sqr),
        best_nbr, jnp.uint32(SEGNULLVAL)).astype(jnp.uint32)

    # Apply all merges at once (commutative: targets are never candidates)
    move = merge_to != SEGNULLVAL
    merge_map = jnp.where(move, merge_to, ids)
    remap_new = merge_map[remap.astype(jnp.int32)]

    # one multi-channel capacity-sized scatter updates size + every band
    # sum (non-movers scatter zeros onto the null segment's row)
    tgt = merge_to.astype(jnp.int32)
    moved = jnp.where(move[None, :], table, 0.0)
    inc = jax.ops.segment_sum(moved.T, tgt, num_segments=capacity).T
    table_new = table - moved + inc

    n_merged = move.sum().astype(jnp.uint32)
    return remap_new, table_new, n_merged


def eliminate_small_segments_graph(ea, eb, seg_size, spect_sum,
                                   min_seg_size: int, max_spectral_diff,
                                   remap_init=None):
    """
    Device: the full targetSize sweep (reference: shepseg.py:918-1000) on
    the adjacency graph. For targetSize = 1 .. min_seg_size-1, run
    find+apply passes until the count of segments at that size stops
    changing (max 10 passes, matching the reference's MAXPASSES); target
    sizes with no candidates short-circuit (a candidate-free pass is the
    identity, so the fixpoint is unchanged).

    Returns (remap original->current id, seg_size, numEliminated,
    totalPasses) — totalPasses counts every executed find+apply pass
    across all target sizes (each pass streams the edge arrays ~10x;
    the perf-relevant loop count, reported by bench).

    The loop state is a single (nBands+1, capacity) float32 table (row 0
    = sizes — see _merge_pass_edges for the exactness argument; the
    returned seg_size is cast back to uint32, exact below 2^24 pixels
    per segment).
    """
    capacity = seg_size.shape[0]
    max_diff_sqr = (jnp.float32(max_spectral_diff) ** 2)
    # ``remap_init`` lets the caller run the loop on a PRE-CONTRACTION
    # edge list: ea/eb may be adjacencies of an earlier labelling (e.g.
    # the raw clump image) with remap_init mapping those ids to current
    # ones — contracted duplicate pairs are harmless (the pass min-
    # reduces per pair). seg_size/spect_sum are indexed by CURRENT ids.
    remap0 = (jnp.arange(capacity, dtype=jnp.uint32)
              if remap_init is None else remap_init.astype(jnp.uint32))
    # The whole per-segment state as ONE stacked table: row 0 = size
    # (f32), rows 1.. = band sums, capacity minor (lane-friendly).
    table = jnp.concatenate(
        [seg_size.astype(jnp.float32)[None], spect_sum.T])
    # both endpoint vectors concatenated ONCE, outside every pass
    ids2 = jnp.concatenate([ea, eb]).astype(jnp.int32)

    def count_at(table, ftarget):
        return jnp.count_nonzero(table[0] == ftarget).astype(jnp.int32)

    def per_target(target, carry):
        remap, table, num_elim, total_passes = carry
        target_u = target.astype(jnp.uint32)
        ftarget = target.astype(jnp.float32)

        def cond(c):
            _, _, count, prev, passes, _ = c
            return (count > 0) & (count != prev) & (passes < 10)

        def body(c):
            remap_c, table_c, count, prev, passes, elim = c
            remap_n, table_n, n = _merge_pass_edges(
                ids2, remap_c, table_c, target_u, max_diff_sqr)
            return (remap_n, table_n, count_at(table_n, ftarget),
                    count, passes + 1, elim + n)

        init = (remap, table, count_at(table, ftarget),
                jnp.int32(-1), jnp.int32(0), num_elim)
        (remap, table, _, _, passes,
         num_elim) = jax.lax.while_loop(cond, body, init)
        return remap, table, num_elim, total_passes + passes

    remap, table, num_elim, total_passes = jax.lax.fori_loop(
        1, min_seg_size, per_target,
        (remap0, table, jnp.uint32(0), jnp.int32(0)))
    return remap, table[0].astype(jnp.uint32), num_elim, total_passes


def _remap_and_relabel(seg, remap, seg_size_out):
    """
    Device: apply the orig->current id remap and the contiguous relabel
    with ONE full-image gather. relabel subtracts per *current* id, so
    the two maps compose into a single capacity-sized table:
    table[orig] = remap[orig] - sub[remap[orig]] (reference hot path:
    relabelSegments, pyshepseg/shepseg.py:739-777).
    """
    from .segreduce import relabel_subtract
    sub = relabel_subtract(seg_size_out, MINSEGID)
    table = (remap - sub[remap.astype(jnp.int32)]).astype(jnp.uint32)
    return table[seg.astype(jnp.int32)]


def eliminate_small_segments_device(seg, seg_size, spect_sum,
                                    min_seg_size: int, max_spectral_diff,
                                    four_connected: bool,
                                    e_cap: int = None):
    """
    Device: edge extraction + graph elimination + final image rewrite.
    ``e_cap`` (static) bounds the unique adjacency count; when None it
    defaults to 8x capacity (grid adjacency is near-planar, so the true
    count is ~6x segment count; callers with a measured count should
    bucket it — see eliminateSmallSegments).

    Returns (relabelled seg, numEliminated, overflowed). ``overflowed``
    is True when the unique adjacency count exceeded e_cap (results are
    then unreliable and the caller must re-run with a larger bucket —
    only possible for pathologically interleaved segmentations, since
    4-connected adjacency graphs are planar with E <= 3V).
    """
    capacity = seg_size.shape[0]
    if e_cap is None:
        e_cap = 8 * capacity
    if min_seg_size <= 1:
        return (relabel(seg, seg_size, MINSEGID), jnp.uint32(0),
                jnp.bool_(False))
    a, b, first, n_unique = edge_sort_keys(seg, four_connected)
    overflow = n_unique > jnp.uint32(e_cap)
    ea, eb = compact_edges(a, b, first, e_cap, id_bound=capacity)
    remap, seg_size_out, num_elim, _ = eliminate_small_segments_graph(
        ea, eb, seg_size, spect_sum, min_seg_size, max_spectral_diff)
    seg = _remap_and_relabel(seg, remap, seg_size_out)
    return seg, num_elim, overflow


_elim_small_jit = jax.jit(
    eliminate_small_segments_device,
    static_argnames=("min_seg_size", "four_connected", "e_cap"))


def _elim_small_from_sorted(seg, a, b, first, seg_size, spect_sum,
                            min_seg_size: int, max_spectral_diff,
                            e_cap: int):
    """
    Device: graph elimination + image rewrite from ALREADY-SORTED edge
    keys — the host API measures n_unique with the same sort, so reusing
    its output avoids paying the dominant full-image sort twice.
    """
    ea, eb = compact_edges(a, b, first, e_cap,
                           id_bound=seg_size.shape[0])
    remap, seg_size_out, num_elim, _ = eliminate_small_segments_graph(
        ea, eb, seg_size, spect_sum, min_seg_size, max_spectral_diff)
    seg = _remap_and_relabel(seg, remap, seg_size_out)
    return seg, num_elim


_elim_small_from_sorted_jit = jax.jit(
    _elim_small_from_sorted, static_argnames=("min_seg_size", "e_cap"))


def eliminateSmallSegments(seg, img, maxSegId, minSegSize, maxSpectralDiff,
                           fourConnected=True, minSegId=MINSEGID):
    """
    Host API matching the reference signature (reference: shepseg.py:918).
    Modifies ``seg`` (numpy) in place; returns the number of segments
    eliminated.
    """
    if minSegSize <= 1:
        return 0
    capacity = round_capacity(int(maxSegId) + 1)
    seg_j = jnp.asarray(seg)
    img_f = jnp.asarray(np.ascontiguousarray(img)).astype(jnp.float32)
    seg_size = seg_sizes(seg_j, capacity)
    spect_sum = seg_spectral_sums(seg_j, img_f, capacity)
    # Measure the true unique-adjacency count, then bucket the edge
    # capacity statically (one scalar sync, mirroring the clump-count
    # sync); the sorted keys are reused so the sort only runs once.
    a, b, first, n_unique = _edge_sort_jit(
        seg_j, four_connected=bool(fourConnected))
    e_cap = round_capacity_fine(int(n_unique) + 1)
    seg_out, num_elim = _elim_small_from_sorted_jit(
        seg_j, a, b, first, seg_size, spect_sum,
        min_seg_size=int(minSegSize),
        max_spectral_diff=float(maxSpectralDiff), e_cap=e_cap)
    seg[...] = np.asarray(seg_out).astype(SegIdType)
    return int(num_elim)
