"""The per-chunk change fingerprint of the port
(``tpu_resiliency_torch/checkpointing/async_ckpt/device_digest.py``, kernel
``ops/csrc/chunk_fingerprint.cu``), on the CPU:

- the plain PyTorch version equals the JAX package's numpy oracle
  (``host_fingerprints``) AND its jitted XLA function (``shard_fingerprints``
  on CPU jax arrays), bit for bit, for f32, bf16, f16, f64, int8, uint8,
  int32, int64 and bool on several chunk grids (8-byte dtypes under
  ``jax.enable_x64``); a complex dtype gives None in both;
- the kernel's batched plan (``batch_plan``: one leaf table per launch,
  chunks cut into tiles, a grid-stride walk over the tiles with a binary
  search for each tile's leaf, the 16-byte-aligned interior read as
  vectors beside a scalar head and tail, per-tile sums added into the
  rows) is replayed in numpy over one leaf and over mixed lists (1-, 2-,
  4- and 8-byte dtypes, start offsets 0-3, empty leaves, a scalar, chunks
  on both sides of the direct boundary, more leaves than one launch takes)
  and gives the oracle's rows; on the flagship's 141 train-state leaves the
  tiles cover every chunk of ``chunk_grid`` exactly once, in one launch;
- ``batch_fingerprints`` on CPU tensors equals the JAX package's jitted
  function leaf by leaf on a mixed list, and launches nothing;
- the JAX package's property tests: a mutation flips only its chunk, swapped
  lanes change the fingerprint, a uniform constant bump changes it.

The kernel itself is held against the plain version on the card in
``tests/test_torch_device_digest_card.py``.  Tests loop over their cases
(named in the assertion messages) to keep the file's item count small, as
``tests/test_torch_quorum_kernel.py`` explains.
"""

import bisect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resiliency.checkpointing.async_ckpt import device_digest as jdd
from tpu_resiliency.checkpointing.async_ckpt import writer as jwriter
from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as tdd
from tpu_resiliency_torch.checkpointing.async_ckpt import writer as twriter
from tpu_resiliency_torch.models import transformer as ttr
from tpu_resiliency_torch.utils.dtypes import to_tensor

DTYPES = ("float32", "bfloat16", "float16", "float64", "int8", "uint8",
          "int32", "int64", "bool")
SIZES = (1, 3, 1000, 3001, 5000)
GRIDS = ((1024, False), (1024, True), (4096, True), (8192, False),
         (16 << 20, True))


def _jax_array(name: str, n: int, seed: int):
    """A CPU jax array of dtype ``name`` from seeded numpy values (under
    ``enable_x64`` for 8-byte dtypes, the caller's context)."""
    rng = np.random.default_rng(seed)
    host = (rng.standard_normal(n) * 100).astype(np.float32)
    return jnp.asarray(host).astype(name)


def _torch_of(x) -> torch.Tensor:
    """The same bytes as a CPU tensor of the same dtype (bf16 through raw
    bytes, never as a numpy value)."""
    host = np.asarray(x)
    raw = host.reshape(-1).view(np.uint8).copy()
    name = str(host.dtype)
    storage = np.uint16 if name == "bfloat16" else host.dtype
    return to_tensor(raw.view(storage).reshape(host.shape), name)


def test_plain_version_equals_jax_oracle_and_xla_function():
    before = (tdd.batch_fingerprints.launches, tdd.batch_fingerprints.shards)
    for name in DTYPES:
        for n in SIZES:
            with jax.enable_x64(name in ("float64", "int64")):
                x = _jax_array(name, n, seed=n)
                assert str(x.dtype) == name
                host = np.asarray(x)
                t = _torch_of(x)
                for chunk_bytes, direct in GRIDS:
                    case = (name, n, chunk_bytes, direct)
                    oracle = jdd.host_fingerprints(
                        host.tobytes(), host.dtype, chunk_bytes, direct)
                    # the jitted function compiles per shape and grid (0.16 s
                    # each here): take three grids at one size
                    xla = oracle
                    if n == 3001 and (chunk_bytes, direct) in GRIDS[:3]:
                        (xla,) = jdd.read_fingerprints(
                            [jdd.shard_fingerprints(x, chunk_bytes, direct)])
                    plain = tdd.shard_fingerprints(t, chunk_bytes, direct)
                    (got,) = tdd.read_fingerprints([plain])
                    ours = tdd.host_fingerprints(
                        host.tobytes(), host.dtype, chunk_bytes, direct)
                    assert got.dtype == np.uint32, case
                    np.testing.assert_array_equal(got, oracle, err_msg=str(case))
                    np.testing.assert_array_equal(got, xla, err_msg=str(case))
                    np.testing.assert_array_equal(ours, oracle, err_msg=str(case))
                    assert got.shape == (len(jwriter.chunk_grid(
                        host.nbytes, chunk_bytes, direct)), 2), case
    # CPU tensors take the plain version: nothing launched
    assert (tdd.batch_fingerprints.launches, tdd.batch_fingerprints.shards) == before


def test_complex_dtype_stays_on_the_host_crc_path():
    assert tdd.shard_fingerprints(torch.ones(8, dtype=torch.complex64)) is None
    assert tdd.batch_fingerprints([torch.ones(8, dtype=torch.complex64),
                                   torch.ones(0)], 1024, True)[0] is None
    assert jdd.shard_fingerprints(jnp.ones(8, jnp.complex64)) is None
    for dt in (np.complex64, np.complex128):
        assert tdd.host_fingerprints(b"\x00" * 64, dt) is None
        assert jdd.host_fingerprints(b"\x00" * 64, dt) is None
    assert tdd.read_fingerprints([None]) == [None]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        tdd.shard_fingerprints(x.t())
    with pytest.raises(ValueError, match="lane width"):
        tdd.shard_fingerprints(x, chunk_bytes=1002, use_direct=False)
    # the batched call refuses the same, whichever leaf of the list it is
    ok = torch.ones(16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        tdd.batch_fingerprints([ok, x.t()], 1024, True)
    with pytest.raises(ValueError, match="2-byte lane width"):
        tdd.batch_fingerprints([torch.ones(4, dtype=torch.uint8), ok], 1001, True)
    with pytest.raises(ValueError, match="lane width"):
        tdd.batch_plan([64], [4], 1002, False)
    # an empty shard has no chunks
    empty = tdd.shard_fingerprints(torch.empty(0), 1024, True)
    assert tuple(empty.shape) == (0, 2)


WIDTHS = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _mix(lanes: np.ndarray, g: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = lanes ^ (g.astype(np.uint32) * np.uint32(tdd._PHI))
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(tdd._MIX1)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(tdd._MIX2)
        return h ^ (h >> np.uint32(16))


def _tile(row: np.ndarray, local: int, tile_bytes: int):
    """Tile ``local`` of a leaf's table row, as the kernel maps it: (chunk,
    chunk start, first lane, end lane)."""
    _, lb, total, chunk, boundary, n_low, _, _ = (int(v) for v in row)
    tile = tile_bytes // lb
    per_chunk = -(-chunk // tile)
    tiles_low = ((n_low - 1) * per_chunk
                 + -(-(boundary - (n_low - 1) * chunk) // tile)) if n_low else 0
    if local < tiles_low:
        c, sub = divmod(local, per_chunk)
        cs, ce = c * chunk, min(c * chunk + chunk, boundary)
    else:
        hc, sub = divmod(local - tiles_low, per_chunk)
        c, cs = n_low + hc, boundary + hc * chunk
        ce = min(cs + chunk, total)
    ts = cs + sub * tile
    return c, cs, ts, min(ts + tile, ce)


def _tile_sums(raw: np.ndarray, addr: int, lb: int, cs: int, ts: int,
               te: int):
    """One tile's (sum h, sum h * pos): the scalar head up to the first
    16-byte boundary of device address ``addr + ts * lb``, whole 16-byte
    vectors split into lanes as the kernel splits a uint4, the scalar
    tail."""
    per_vec = 16 // lb
    head = min(((16 - (addr + ts * lb) % 16) % 16) // lb, te - ts)
    vs = ts + head
    nvec = (te - vs) // per_vec
    ve = vs + nvec * per_vec
    assert head < per_vec and te - ve < per_vec
    assert nvec == 0 or (addr + vs * lb) % 16 == 0
    scalar = raw.view(WIDTHS[lb]).astype(np.uint32)
    words = raw[vs * lb:ve * lb].view("<u4")
    mask = np.uint32((1 << (8 * lb)) - 1) if lb < 4 else np.uint32(0xFFFFFFFF)
    vec = np.stack([(words >> np.uint32(8 * lb * m)) & mask
                    for m in range(4 // lb)], axis=1).reshape(-1)
    lanes = np.concatenate([scalar[ts:vs], vec, scalar[ve:te]])
    g = np.arange(ts, te, dtype=np.int64)
    h = _mix(lanes, g)
    with np.errstate(over="ignore"):
        a = np.uint32(h.sum(dtype=np.uint64) & 0xFFFFFFFF)
        b = np.uint32((h * (g - cs + 1).astype(np.uint32)).sum(dtype=np.uint64)
                      & 0xFFFFFFFF)
    return a, b


def _replay_batch(raws, itemsizes, addrs, chunk_bytes: int, direct: bool,
                  blocks: int = 7, cap: int = tdd.LEAVES_PER_LAUNCH,
                  tile_bytes: int = tdd.TILE_BYTES):
    """The batched kernel in numpy: the leaf table from ``batch_plan`` with
    the leaves at device addresses ``addrs``, one launch per ``cap`` leaves
    (none for a group without tiles), each of ``blocks`` blocks walking the
    tiles with a grid stride, the tile's leaf found by binary search over
    the first tiles, and its sums added into the chunk's row in uint32.
    Returns (rows of each leaf, launches)."""
    table, n_rows, n_tiles = tdd.batch_plan(
        [r.size for r in raws], itemsizes, chunk_bytes, direct, tile_bytes)
    table[:, 0] = addrs
    out = np.zeros((n_rows, 2), dtype=np.uint32)
    launches = 0
    for first in range(0, len(raws), cap):
        group = table[first:first + cap]
        end = int(table[first + cap, 7]) if first + cap < len(raws) else n_tiles
        tile0 = group[:, 7].tolist()
        if end == tile0[0]:
            continue
        launches += 1
        for block in range(min(blocks, end - tile0[0])):
            for t in range(tile0[0] + block, end, blocks):
                i = bisect.bisect_right(tile0, t) - 1
                row = group[i]
                c, cs, ts, te = _tile(row, t - tile0[i], tile_bytes)
                a, b = _tile_sums(raws[first + i], int(row[0]), int(row[1]),
                                  cs, ts, te)
                r = int(row[6]) + c
                with np.errstate(over="ignore"):
                    out[r, 0] += a
                    out[r, 1] += b
    starts = table[:, 6].tolist() + [n_rows]
    return [out[s:e] for s, e in zip(starts, starts[1:])], launches


def _mixed(rng, itemsizes, sizes, offsets):
    """Leaves of ``sizes`` elements of ``itemsizes`` bytes, each ``offset``
    elements past a 16-byte-aligned device address: (raw bytes, item sizes,
    device addresses)."""
    raws, items, addrs = [], [], []
    for k, (item, n, off) in enumerate(zip(itemsizes, sizes, offsets)):
        raws.append(rng.integers(0, 256, size=n * item, dtype=np.uint8))
        items.append(item)
        addrs.append((k + 1) * (1 << 32) + off * item)
    return raws, items, addrs


def test_launch_plan_replayed_in_numpy_equals_the_oracle():
    rng = np.random.default_rng(3)
    for itemsize in (1, 2, 4, 8):
        for nbytes_target in (8, 4096, 12345 * 8, 300_000):
            nbytes = nbytes_target - nbytes_target % itemsize
            for chunk_bytes, direct in ((1024, False), (4096, True), (65536, True)):
                for offset in range(4):
                    case = (itemsize, nbytes, chunk_bytes, direct, offset)
                    raws, items, addrs = _mixed(rng, [itemsize], [nbytes // itemsize],
                                                [offset])
                    want = jdd.host_fingerprints(raws[0].tobytes(), WIDTHS[itemsize],
                                                 chunk_bytes, direct)
                    (got,), launches = _replay_batch(
                        raws, items, addrs, chunk_bytes, direct, tile_bytes=2048)
                    np.testing.assert_array_equal(got, want, err_msg=str(case))
                    assert launches == 1, case
    # the flagship's embed leaf in f32 (65,536,000 B) on the default grid:
    # four chunks below the boundary, 256 tiles of 64 KiB in each whole
    # one and 232 in the last
    table, n_rows, n_tiles = tdd.batch_plan(
        [65_536_000], [4], twriter.default_chunk_bytes(), True)
    assert table[0, 1:].tolist() == [4, 16_384_000, 1 << 22, 16_384_000, 4, 0, 0]
    assert (n_rows, n_tiles) == (4, 3 * 256 + 232)


def test_batch_plan_replayed_in_numpy_equals_the_oracle():
    """Mixed lists through one replayed launch (and several, with a small
    leaf cap): every leaf's rows equal the oracle's."""
    rng = np.random.default_rng(5)
    # (item bytes, elements, start offset in elements): 1-, 2-, 4- and
    # 8-byte dtypes at offsets 0-3, an empty leaf, a scalar, leaves whose
    # direct boundary falls inside a chunk, a leaf of one tile
    spec = [(1, 9001, 1), (2, 4099, 3), (4, 1, 0), (8, 2053, 2), (4, 0, 1),
            (1, 16, 3), (2, 1, 1), (4, 3075, 3), (1, 0, 0), (8, 1, 1),
            (2, 70000, 2), (4, 33000, 1), (1, 131079, 0), (4, 5, 2)]
    items, sizes, offsets = zip(*spec)
    raws, items, addrs = _mixed(rng, items, sizes, offsets)
    for chunk_bytes, direct, tile_bytes, cap in (
            (1024, False, 256, tdd.LEAVES_PER_LAUNCH), (4096, True, 2048, 5),
            (65536, True, 16384, tdd.LEAVES_PER_LAUNCH), (12288, True, 4096, 3),
            (16 << 20, True, tdd.TILE_BYTES, 4)):
        case = (chunk_bytes, direct, tile_bytes, cap)
        got, launches = _replay_batch(raws, items, addrs, chunk_bytes, direct,
                                      cap=cap, tile_bytes=tile_bytes)
        # a group of empty leaves alone takes no launch
        groups = [sum(r.size for r in raws[i:i + cap]) > 0
                  for i in range(0, len(raws), cap)]
        assert launches == sum(groups), case
        for k, (raw, item) in enumerate(zip(raws, items)):
            want = jdd.host_fingerprints(raw.tobytes(), WIDTHS[item], chunk_bytes,
                                         direct)
            np.testing.assert_array_equal(got[k], want, err_msg=str((case, k)))


def _flagship_leaves():
    """(elements, item bytes) of the flagship's train state on the card:
    params in bf16, ``mu``, ``nu`` and ``master`` in f32, ``count``."""
    cfg = ttr.TransformerConfig()
    d, f = cfg.d_model, cfg.d_ff
    layer = [d * d] * 4 + [d * f, f * d, d, d]
    params = [cfg.vocab * d, cfg.max_seq * d, d] + layer * cfg.n_layers
    return ([(n, 2) for n in params] + [(n, 4) for n in params] * 3 + [(1, 4)])


def test_batch_plan_tiles_the_flagship_state():
    """The 141 leaves on the default grid: one launch, and each chunk of
    each leaf's ``chunk_grid`` covered by its tiles exactly once."""
    leaves = _flagship_leaves()
    nbytes = [n * item for n, item in leaves]
    assert (len(leaves), sum(nbytes)) == (141, 412_941_316)
    assert len(leaves) <= tdd.LEAVES_PER_LAUNCH
    chunk_bytes = twriter.default_chunk_bytes()
    table, n_rows, n_tiles = tdd.batch_plan(nbytes, [i for _, i in leaves],
                                            chunk_bytes, True)
    grids = [jwriter.chunk_grid(b, chunk_bytes, True) for b in nbytes]
    assert n_rows == sum(len(g) for g in grids)
    assert (n_rows, n_tiles) == (151, 6337)
    tile0 = table[:, 7].tolist() + [n_tiles]
    covered = {}
    for t in range(n_tiles):
        i = bisect.bisect_right(tile0[:-1], t) - 1
        c, cs, ts, te = _tile(table[i], t - tile0[i], tdd.TILE_BYTES)
        covered.setdefault((i, c), []).append((ts, te))
    for i, grid in enumerate(grids):
        lb = int(table[i, 1])
        for c, (off, length) in enumerate(grid):
            spans = sorted(covered.pop((i, c)))
            assert spans[0][0] == off // lb and spans[-1][1] == (off + length) // lb
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), (i, c)
            assert all(te - ts <= tdd.TILE_BYTES // lb for ts, te in spans)
    assert not covered


def test_batch_fingerprints_on_cpu_equals_the_jax_package():
    """A mixed list of CPU tensors, leaf by leaf against the JAX package's
    jitted function and its oracle: the plain version, no launch."""
    before = (tdd.batch_fingerprints.launches, tdd.batch_fingerprints.shards)
    names = ("float32", "bfloat16", "int8", "float64", "bool", "int32", "uint8",
             "float16", "int64", "float32")
    sizes = (3001, 1000, 5000, 1, 0, 1, 3, 4097, 300, 1)
    with jax.enable_x64(True):
        xs = [_jax_array(name, n, seed=k)
              for k, (name, n) in enumerate(zip(names, sizes))]
        for chunk_bytes, direct in ((4096, True), (1024, False)):
            ts = []
            for k, x in enumerate(xs):
                # start each CPU tensor k % 4 elements into its storage
                t = _torch_of(x)
                base = torch.empty(t.numel() + 4, dtype=t.dtype)
                base[k % 4:k % 4 + t.numel()] = t.reshape(-1)
                ts.append(base[k % 4:k % 4 + t.numel()].reshape(t.shape))
            got = tdd.read_fingerprints(tdd.batch_fingerprints(ts, chunk_bytes, direct))
            xla = jdd.read_fingerprints(
                [jdd.shard_fingerprints(x, chunk_bytes, direct) for x in xs])
            for k, x in enumerate(xs):
                case = (names[k], sizes[k], chunk_bytes, direct)
                host = np.asarray(x)
                np.testing.assert_array_equal(got[k], xla[k], err_msg=str(case))
                np.testing.assert_array_equal(
                    got[k], jdd.host_fingerprints(host.tobytes(), host.dtype,
                                                  chunk_bytes, direct),
                    err_msg=str(case))
    assert (tdd.batch_fingerprints.launches, tdd.batch_fingerprints.shards) == before


def test_mutation_flips_only_its_chunk():
    x = torch.arange(2048, dtype=torch.float32)
    y = x.clone()
    y[700] = -1.0  # byte offset 2800 -> chunk index 2 of 1 KiB chunks
    (ra, rb) = tdd.read_fingerprints([
        tdd.shard_fingerprints(x, chunk_bytes=1024, use_direct=False),
        tdd.shard_fingerprints(y, chunk_bytes=1024, use_direct=False)])
    changed = [i for i in range(ra.shape[0]) if not np.array_equal(ra[i], rb[i])]
    assert changed == [2]


def test_swapped_lanes_change_the_fingerprint():
    x = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    y = torch.tensor([2, 1, 3, 4], dtype=torch.int32)
    (ra, rb) = tdd.read_fingerprints(
        [tdd.shard_fingerprints(x), tdd.shard_fingerprints(y)])
    assert not np.array_equal(ra, rb)


def test_uniform_constant_bump_changes_the_fingerprint():
    """Raw Fletcher sums telescope to zero on a uniform constant delta over
    a power-of-two-length chunk; the mix must break that."""
    n = 1 << 20
    x = torch.zeros(n, dtype=torch.float32)
    (ra, rb) = tdd.read_fingerprints(
        [tdd.shard_fingerprints(x), tdd.shard_fingerprints(x + 1.0)])
    assert ra.shape == rb.shape
    for i in range(ra.shape[0]):
        assert not np.array_equal(ra[i], rb[i]), i


def test_digest_context_verdict_equals_the_jax_package():
    nbytes, chunk = 10_000, 4096
    grid = twriter.chunk_grid(nbytes, chunk, True)
    assert grid == jwriter.chunk_grid(nbytes, chunk, True)
    rows = {(0, 0): {(o, n): (7 + o, "/base/s.bin") for o, n in grid}}
    base = np.arange(2 * len(grid), dtype=np.uint32).reshape(-1, 2)
    cur = base.copy()
    cur[1, 1] += 1
    for allow in (False, True):
        for fp in (base, cur, base[:1], None):
            args = dict(base_rows=rows, base_fps={(0, 0): base},
                        allow_skip=allow, chunk_bytes=chunk, use_direct=True)
            want = jdd.DigestContext(**args).verdict((0, 0), nbytes, fp)
            got = tdd.DigestContext(**args).verdict((0, 0), nbytes, fp)
            assert got == want, (allow, None if fp is None else fp.tolist())
