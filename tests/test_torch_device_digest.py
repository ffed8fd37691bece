"""The per-chunk change fingerprint of the port
(``tpu_resiliency_torch/checkpointing/async_ckpt/device_digest.py``, kernel
``ops/csrc/chunk_fingerprint.cu``), on the CPU:

- the plain PyTorch version equals the JAX package's numpy oracle
  (``host_fingerprints``) AND its jitted XLA function (``shard_fingerprints``
  on CPU jax arrays), bit for bit, for f32, bf16, f16, f64, int8, uint8,
  int32, int64 and bool on several chunk grids (8-byte dtypes under
  ``jax.enable_x64``); a complex dtype gives None in both;
- the kernel's launch plan (three integers and a block count) is replayed in
  numpy, block-stride loop and per-block partial sums included, at start
  offsets 0-3, and gives the oracle's rows;
- the JAX package's property tests: a mutation flips only its chunk, swapped
  lanes change the fingerprint, a uniform constant bump changes it.

The kernel itself is held against the plain version on the card in
``tests/test_torch_device_digest_card.py``.  Tests loop over their cases
(named in the assertion messages) to keep the file's item count small, as
``tests/test_torch_quorum_kernel.py`` explains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resiliency.checkpointing.async_ckpt import device_digest as jdd
from tpu_resiliency.checkpointing.async_ckpt import writer as jwriter
from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as tdd
from tpu_resiliency_torch.checkpointing.async_ckpt import writer as twriter
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
    before = tdd.shard_fingerprints.launches
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
    assert tdd.shard_fingerprints.launches == before


def test_complex_dtype_stays_on_the_host_crc_path():
    assert tdd.shard_fingerprints(torch.ones(8, dtype=torch.complex64)) is None
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
    # an empty shard has no chunks
    empty = tdd.shard_fingerprints(torch.empty(0), 1024, True)
    assert tuple(empty.shape) == (0, 2)


def _replay_kernel(raw: np.ndarray, itemsize: int, chunk_bytes: int,
                   direct: bool) -> np.ndarray:
    """The kernel's arithmetic in numpy: the grid from ``fingerprint_plan``
    (n_low chunks below the boundary, the rest above), each block's
    block-stride loop over its chunk, and the per-block sums added into the
    row in uint32, as the atomics do."""
    lb, total, chunk, boundary, n_chunks, blocks = tdd.fingerprint_plan(
        raw.size, itemsize, chunk_bytes, direct)
    lanes = raw.view(np.uint32) if lb == 4 else raw.view(f"u{lb}").astype(np.uint32)
    assert lanes.size == total
    threads = tdd._THREADS
    n_low = -(-boundary // chunk)
    out = np.zeros((n_chunks, 2), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for c in range(n_chunks):
            start = c * chunk if c < n_low else boundary + (c - n_low) * chunk
            end = min(start + chunk, boundary if c < n_low else total)
            i = np.arange(end - start, dtype=np.int64)
            g = (start + i).astype(np.uint32)
            h = lanes[start:end] ^ (g * np.uint32(tdd._PHI))
            h = h ^ (h >> np.uint32(16))
            h = h * np.uint32(tdd._MIX1)
            h = h ^ (h >> np.uint32(13))
            h = h * np.uint32(tdd._MIX2)
            h = h ^ (h >> np.uint32(16))
            hp = h * (i + 1).astype(np.uint32)
            block = (i // threads) % blocks  # which block's loop reads lane i
            for b in range(blocks):
                sel = block == b
                out[c, 0] += np.uint32(h[sel].sum(dtype=np.uint64) & 0xFFFFFFFF)
                out[c, 1] += np.uint32(hp[sel].sum(dtype=np.uint64) & 0xFFFFFFFF)
    return out


def test_launch_plan_replayed_in_numpy_equals_the_oracle():
    rng = np.random.default_rng(3)
    for itemsize in (1, 2, 4, 8):
        for nbytes_target in (8, 4096, 12345 * 8, 300_000):
            nbytes = nbytes_target - nbytes_target % itemsize
            for chunk_bytes, direct in ((1024, False), (4096, True), (65536, True)):
                for offset in range(4):
                    case = (itemsize, nbytes, chunk_bytes, direct, offset)
                    # the shard starts `offset` items past an aligned base
                    base = rng.integers(0, 256, size=nbytes + 4 * itemsize,
                                        dtype=np.uint8)
                    raw = base[offset * itemsize: offset * itemsize + nbytes]
                    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[itemsize]
                    want = jdd.host_fingerprints(raw.tobytes(), dt, chunk_bytes, direct)
                    got = _replay_kernel(raw, itemsize, chunk_bytes, direct)
                    np.testing.assert_array_equal(got, want, err_msg=str(case))
    # the flagship's embed leaf in f32 (65,536,000 B) on the default grid
    lb, total, chunk, boundary, n_chunks, blocks = tdd.fingerprint_plan(
        65_536_000, 4, twriter.default_chunk_bytes(), True)
    assert (lb, n_chunks, boundary) == (4, 4, total)
    assert blocks == (16 << 20) // 4 // (tdd._THREADS * tdd.LANES_PER_THREAD)


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
