"""
Multi-chip connected-component labelling over a spatially-sharded image:
the halo-exchange analogue of the reference's overlapping-tile
decomposition (reference: pyshepseg/tiling.py:1128-1306 reconciles tile
halos on the host; here the "halo" is one row of labels exchanged between
neighbouring cards over NVLink every sweep).

The image is sharded by rows across the mesh. Each device runs the same
min-label propagation body as ops/clump.py on its stripe (neighbour-min +
Hillis-Steele run scans), with the neighbours' border rows supplied by
``jax.lax.ppermute`` — so labels cross a stripe boundary each sweep and
the global fixpoint is detected with a ``psum`` of the per-device change
flags. Pointer jumping is intentionally absent: label values are global
flat indices that may live on other devices, so chain-collapsing would
need all-gathers; run scans keep convergence at O(stripes + shape turns)
sweeps instead.

The final scan-order relabel (component root = minimum flat index, the
reference flood fill's seed order) becomes a distributed prefix sum: each
device counts its local roots, an all_gather + cumsum assigns stripe
offsets, and ranks are looked up through a one-round ID exchange.

This module complements parallel/mesh.py (CONC_MESH): CONC_MESH scales by
giving whole tiles to chips; this scales a SINGLE oversized tile across
chips when it exceeds one chip's memory.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..ops.constants import SegIdType, SEGNULLVAL
from ..ops.clump import _run_min
from ..ops.shifts import shift, offsets_for

AXIS = "rows"

# Flat pixel indices (the clump labels before relabel) are int32, so a
# sharded image may hold at most this many pixels; the host APIs raise
# a clear error beyond it rather than silently wrapping negative.
MAX_SHARDED_PIXELS = 2 ** 31 - 1


def exchange_rows(arr, fill, n_dev):
    """The halo rows of ``arr`` from the stripes above and below over
    NVLink: returns (top_row, bottom_row), with ``fill`` beyond the image's
    first/last stripe. Shared by the sharded clump and the sharded full
    pipeline (shardmap_seg)."""
    my = jax.lax.axis_index(AXIS)
    up = [(i, (i - 1) % n_dev) for i in range(n_dev)]    # send to i-1
    down = [(i, (i + 1) % n_dev) for i in range(n_dev)]  # send to i+1
    # my top row travels down to my lower neighbour and vice versa
    from_above = jax.lax.ppermute(arr[-1], AXIS, down)
    from_below = jax.lax.ppermute(arr[0], AXIS, up)
    top = jnp.where(my == 0, jnp.full_like(from_above, fill), from_above)
    bot = jnp.where(my == n_dev - 1,
                    jnp.full_like(from_below, fill), from_below)
    return top, bot


def _clump_stripe_body(img, ignore_val, four_connected, sentinel,
                       n_dev, width):
    """Build the per-sweep body for one device's row stripe."""
    valid = img != ignore_val

    def conn_with_halo(arr, top_row, bot_row, fill):
        """(stripe+2, W) array with neighbour halo rows attached."""
        return jnp.concatenate([top_row[None], arr, bot_row[None]], axis=0)

    img_top, img_bot = exchange_rows(img, ignore_val, n_dev)
    val_top, val_bot = exchange_rows(valid.astype(jnp.int32), 0, n_dev)
    img_h = conn_with_halo(img, img_top, img_bot, ignore_val)
    valid_h = conn_with_halo(valid, val_top != 0, val_bot != 0, False)

    def conn(dy, dx):
        # connectivity of stripe rows (offset +1 into the halo'd arrays)
        core = valid_h[1:-1]
        nbr_valid = shift(valid_h, dy, dx, False)[1:-1]
        nbr_same = (img_h == shift(img_h, dy, dx, ignore_val))[1:-1]
        return core & nbr_valid & nbr_same

    conn_row = conn(0, -1)
    conn_col = conn(-1, 0)
    # Pass-invariant connectivity masks, hoisted out of the sweep body
    # (XLA does not reliably pull loop-invariant code out of while
    # bodies; each mask costs two full-stripe shifts + compares in the
    # memory-bound hot loop). As in ops/clump.py, the per-sweep
    # neighbour-min covers DIAGONALS only — horizontal/vertical
    # propagation inside the stripe is handled (much further per sweep)
    # by the run scans — plus the vertical link across the stripe
    # boundary, which only the first/last rows can see.
    offs = offsets_for(four_connected)
    diag_masks = [(dy, dx, conn(dy, dx))
                  for dy, dx in offs if dy != 0 and dx != 0]
    conn_top_row = conn(-1, 0)[0]    # row 0 <- halo row above
    conn_bot_row = conn(1, 0)[-1]    # last row <- halo row below

    def body(labels):
        lab_top, lab_bot = exchange_rows(labels, sentinel, n_dev)
        lab_h = jnp.concatenate([lab_top[None], labels, lab_bot[None]], 0)
        new = labels
        for dy, dx, same in diag_masks:   # includes halo-crossing diags
            cand = shift(lab_h, dy, dx, sentinel)[1:-1]
            new = jnp.minimum(new, jnp.where(same, cand, sentinel))
        # vertical across the boundary: two rows, not the whole stripe
        new = new.at[0].min(jnp.where(conn_top_row, lab_top, sentinel))
        new = new.at[-1].min(jnp.where(conn_bot_row, lab_bot, sentinel))
        new = _run_min(new, conn_row, 1, sentinel)
        new = _run_min(new, conn_col, 0, sentinel)
        new = jnp.where(valid, new, sentinel)
        return new

    return body, valid


def _clump_sharded(img, ignore_val: int, four_connected: bool,
                   n_dev: int, height: int, width: int):
    """shard_map worker: full clump on one row stripe."""
    sentinel = jnp.int32(height * width)
    my = jax.lax.axis_index(AXIS)
    stripe_h = img.shape[0]
    row0 = my.astype(jnp.int32) * stripe_h

    valid = img != ignore_val
    yy = jax.lax.broadcasted_iota(jnp.int32, img.shape, 0) + row0
    xx = jax.lax.broadcasted_iota(jnp.int32, img.shape, 1)
    labels0 = jnp.where(valid, yy * width + xx, sentinel)

    body, _ = _clump_stripe_body(img, ignore_val, four_connected,
                                 sentinel, n_dev, width)

    def cond(c):
        return c[1]

    def loop(c):
        labels, _ = c
        new = body(labels)
        changed_local = jnp.any(new != labels)
        # global fixpoint over NVLink
        changed = jax.lax.psum(changed_local.astype(jnp.int32), AXIS) > 0
        return new, changed

    labels, _ = jax.lax.while_loop(cond, loop, (labels0, jnp.bool_(True)))

    # Distributed scan-order relabel: rank roots by global flat index.
    flat = labels.ravel()
    gidx = (yy * width + xx).ravel()
    is_root = (flat == gidx) & valid.ravel()
    local_roots = jnp.sum(is_root.astype(jnp.uint32))
    counts = jax.lax.all_gather(local_roots, AXIS)         # (n_dev,)
    offset = jnp.cumsum(counts)[my] - counts[my]
    rank_local = jnp.cumsum(is_root.astype(jnp.uint32)) + offset

    # Every pixel needs the rank of its component's root, which may live
    # on another stripe: build the full global rank table via all_gather
    # of (per-stripe rank rows), then gather. The table is uint32 H*W/n
    # per device -> all_gather costs one image-sized collective, the
    # same order as one sweep's traffic.
    rank_all = jax.lax.all_gather(rank_local, AXIS).reshape(-1)
    rank_ext = jnp.concatenate([rank_all, jnp.zeros(1, jnp.uint32)])
    seg = jnp.where(valid.ravel(),
                    rank_ext[jnp.minimum(flat, height * width)],
                    jnp.uint32(SEGNULLVAL))
    # psum is provably replicated, which out_specs=P() requires
    num = jax.lax.psum(local_roots, AXIS)
    return seg.reshape(img.shape).astype(jnp.uint32), num


def clump_sharded(img, ignoreVal, fourConnected=True, mesh=None):
    """
    Host API: clump one large image with its rows sharded across all
    devices of ``mesh`` (default: a 1-D mesh over jax.devices()).
    Label semantics match ops.clump.clump (scan-order IDs from 1), but
    note the second return value is numClumps (= the highest ID), NOT
    the reference clump()'s nextClumpId (= highest ID + 1).
    The image height must divide evenly by the device count — pad with
    ``ignoreVal`` rows otherwise (callers) or use ops.clump for small
    images.

    Returns (seg uint32 (H, W), numClumps int).
    """
    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), (AXIS,))
    elif mesh.axis_names != (AXIS,):
        # flatten any caller mesh onto this module's 1-D row axis
        mesh = Mesh(mesh.devices.reshape(-1), (AXIS,))
    n_dev = mesh.devices.size
    img = np.ascontiguousarray(img).astype(np.int32)
    h, w = img.shape
    if h * w > MAX_SHARDED_PIXELS:
        raise ValueError(
            f"image of {h}x{w} = {h * w} pixels exceeds the sharded "
            f"pipeline's int32 flat-index range ({MAX_SHARDED_PIXELS}); "
            "tile the scene with the tiled driver instead")
    pad = (-h) % n_dev
    if pad:
        img = np.pad(img, ((0, pad), (0, 0)), constant_values=ignoreVal)
    hp = img.shape[0]

    fn = shard_map(
        functools.partial(_clump_sharded, ignore_val=int(ignoreVal),
                          four_connected=bool(fourConnected),
                          n_dev=n_dev, height=hp, width=w),
        mesh=mesh,
        in_specs=P(AXIS, None),
        out_specs=(P(AXIS, None), P()),
    )
    img_dev = jax.device_put(jnp.asarray(img),
                             NamedSharding(mesh, P(AXIS, None)))
    seg, num = jax.jit(fn)(img_dev)
    seg = np.asarray(seg)[:h]
    return seg.astype(SegIdType), int(num)
