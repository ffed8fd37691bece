"""The quorum local max kernels of the port (``ops/csrc/quorum_max.cu``) on
the card: both entries against their plain versions and numpy, at n up to
2^24, start offsets 0-3, negative ages, and two streams at once.

Every test is marked ``cuda`` and skips without a card.  On the card, run
them with ``python -m pytest --noconftest -m cuda tests/test_torch_quorum*.py``
(the repository's conftest imports JAX, which the card's machine lacks).
Each test walks its cases in a loop, for the reason given in
``tests/test_torch_quorum_kernel.py``.
"""

import numpy as np
import pytest
import torch

import tpu_resiliency_torch.ops.quorum as tq
# by its module name, as pytest imports it from this directory: the card's
# machine has an installed ``tests`` package that hides this one
from test_torch_quorum_kernel import K, _ages

_KINDS = ("random", "packed", "zeros", "int_max", "negative")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


_CARD_SIZES = (1, 31, 32, 33, 1000, 1025, (1 << 20) + 3, 1 << 24)


def _on_card(values: np.ndarray, offset: int, device) -> torch.Tensor:
    """``values`` on the card as a contiguous view starting ``offset``
    elements past a 16-byte boundary."""
    base = torch.empty(values.size + 8, dtype=torch.int32, device=device)
    lead = (-(base.data_ptr() >> 2)) % 4
    x = base[lead + offset:lead + offset + values.size]
    x.copy_(torch.from_numpy(values))
    assert (x.data_ptr() >> 2) % 4 == offset
    return x


@pytest.mark.cuda
def test_card_pointer_entry_equals_plain_and_numpy(card):
    for n in _CARD_SIZES:
        for offset in range(4):
            for kind in ("random", "packed", "negative"):
                case = (kind, n, offset)
                values = _ages(kind, n, seed=n + offset)
                x = _on_card(values, offset, card)
                before = (tq.local_max.launches, tq.local_max.launches_pointer)
                got = tq.local_max(x)
                want = tq.local_max_reference(x)
                torch.cuda.synchronize()
                assert int(got[0]) == int(want[0]) == int(values.max()), case
                assert (tq.local_max.launches, tq.local_max.launches_pointer) == (
                    before[0] + 1, before[1] + 1), case


@pytest.mark.cuda
def test_card_by_value_entry_equals_plain_and_numpy(card):
    out = torch.full((1,), -7, dtype=torch.int32, device=card)
    for n in (n for n in _CARD_SIZES if n <= K):
        for kind in _KINDS:
            ages = _ages(kind, n, seed=n)
            before = tq.local_max.launches_by_value
            assert tq.local_max_host(ages, out) is out, (kind, n)
            ages[:] = 0  # the launch captured the values: the buffer is free
            torch.cuda.synchronize()
            want = int(tq.local_max_host_reference(_ages(kind, n, seed=n))[0])
            assert int(out[0]) == want == int(_ages(kind, n, seed=n).max()), (kind, n)
            assert tq.local_max.launches_by_value == before + 1, (kind, n)


@pytest.mark.cuda
def test_card_entries_refuse_what_they_cannot_take(card):
    with pytest.raises(ValueError):
        tq.local_max_host(np.arange(K + 1, dtype=np.int32),
                          torch.empty(1, dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        tq.local_max(torch.arange(8, dtype=torch.int32, device=card),
                     torch.empty(1, dtype=torch.int32))


@pytest.mark.cuda
def test_card_two_streams_launch_at_once(card):
    """The tick lane's stream and the step's stream launch these kernels
    concurrently: nothing may be shared between the calls."""
    rng = np.random.default_rng(3)
    streams = [torch.cuda.Stream(card), torch.cuda.Stream(card)]
    big = [rng.integers(-2 ** 31, 2 ** 31 - 1, size=size, dtype=np.int64)
           .astype(np.int32) for size in ((1 << 24) + 1, (1 << 20) + 3)]
    xs = [_on_card(v, i + 1, card) for i, v in enumerate(big)]
    small = [rng.integers(0, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
             for n in (1, K)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[i].append(tq.local_max(xs[i]))
                outs[i].append(tq.local_max_host(
                    small[i], torch.empty(1, dtype=torch.int32, device=card)))
    torch.cuda.synchronize()
    for i in range(2):
        want = [int(big[i].max()), int(small[i].max())] * 20
        assert [int(o[0]) for o in outs[i]] == want
