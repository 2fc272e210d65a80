"""K2's second pass, the sum of its per-block rows, on the CPU.

The kernel (`csrc/megakernel_grad.cu` `reduce_grad_rows_kernel`) sums the
rows in the order K2's first reduce kernel did: for each parameter, 256
partials, partial t the rows t, t + 256, ... added in row order to 0, then a
halving tree over t.  Its plain version `reduce_grad_rows_plain` is that
order in torch, and `chip_smoke.py` holds the kernel to it bit for bit on
the card.  Here the plain version is held, bit for bit, against a numpy
loop written from that kernel's source, on seeded rows of the two shapes
the steps give it: config 2's (4,096 blocks x 72 parameters) and the
256-sphere scene's (4,096 x 3,375), and on ragged ones."""
import numpy as np
import pytest
import torch

from sail_tpu_torch.ops.cuda import megakernel as mk


def _parent_order(rows: np.ndarray) -> np.ndarray:
    """out[p]: for t in 0..255, v = 0; v += rows[r][p] for r = t, t + 256,
    ...; then for h = 128 ... 1, buf[t] += buf[t + h] for t < h."""
    n, width = rows.shape
    buf = []
    for t in range(256):
        v = np.zeros(width, np.float32)
        for r in range(t, n, 256):
            v = v + rows[r]
        buf.append(v)
    h = 128
    while h > 0:
        for t in range(h):
            buf[t] = buf[t] + buf[t + h]
        h //= 2
    return buf[0]


@pytest.mark.parametrize("shape", [(4096, 72), (4096, 3375), (1000, 13),
                                   (37, 5), (256, 1)])
def test_plain_reduce_is_the_kernel_order_bit_for_bit(shape):
    rng = np.random.default_rng(shape[1])
    # rows of very different scales, so another order would round otherwise
    rows = (rng.standard_normal(shape) * 10.0 ** rng.uniform(
        -3, 3, (shape[0], 1))).astype(np.float32)
    want = _parent_order(rows)
    got = mk.reduce_grad_rows_plain(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.array_equal(got, rows.sum(0, dtype=np.float32)) \
        or shape[0] <= 256


def test_wrapper_runs_the_plain_reduce_for_a_cpu_tensor():
    rows = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (300, 9)).astype(np.float32))
    before = mk.reduce_grad_rows.launches
    assert torch.equal(mk.reduce_grad_rows(rows),
                       mk.reduce_grad_rows_plain(rows))
    assert mk.reduce_grad_rows.launches == before
    with pytest.raises(TypeError):
        mk.reduce_grad_rows(rows.double())
