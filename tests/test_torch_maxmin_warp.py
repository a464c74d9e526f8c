"""The port's warp-per-lane max-min kernel, rehearsed in numpy.

``csrc/bandwidth_share.cu::maxmin_warp_kernel`` runs every shape with at
most 32 flows over at most 32 links (``tiered_grid``'s (32, 4)) as one warp
per lane, and cannot run here. Two facts make it exact, and this file holds
both: for those shapes ``ref.flow_order`` is always left to right, so the
kernel sums the frozen rates in no other order; and its round, computed
with warp bit masks in place of sums (each link's unfrozen count a
population count of a ballot, the bottleneck links a ballot ANDed with
each flow's row of incidence bits, the level a butterfly min read from
thread 0, the loop ended by the first round that freezes nothing), gives
``ref.maxmin_rates`` bit for bit. The model below is that round in
float32 numpy, on the inputs of ``chip_smoke.py`` phase 3 (routes of one to
three hops through ``network.incidence``, the t0t1 sweep's bandwidths, 70%
of flows active) and its four edge cases. ``chip_smoke.py`` holds the
kernel itself to ``ref.maxmin_rates`` on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import network as net  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

WARP = 32
EPS = np.float32(1e-6)
BIG = np.float32(3.0e38)


def min_nan(a, b):
    """The kernel's two-way min: NaN wins, and a +0/-0 tie keeps b."""
    return np.where((a < b) | (a != a), a, b)


def popcount(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x.astype(np.uint64)).astype(np.float32)


def warp_model(inc: np.ndarray, bw: np.ndarray, active: np.ndarray
               ) -> np.ndarray:
    """(B, F, L) float32 0/1, (B, L) float32, (B, F) bool -> (B, F) rates,
    every lane's warp at once, each stopping after its first round that
    freezes nothing."""
    B, F, L = inc.shape
    assert F <= WARP and L <= WARP
    bit = np.uint64(1) << np.arange(WARP, dtype=np.uint64)
    col = inc * active[:, :, None].astype(np.float32)          # (B, F, L)
    colbits = ((col > 0) * bit[:F, None]).sum(1, dtype=np.uint64)  # (B, L)
    # flow f's links: bit f of each link's column bits (the 32 ballots)
    rowbits = (((colbits[:, None, :] >> np.arange(F, dtype=np.uint64)
                 [None, :, None]) & np.uint64(1)) * bit[None, None, :L]
               ).sum(2, dtype=np.uint64)                           # (B, F)
    rate = np.zeros((B, F), np.float32)
    frozen = ~active
    running = np.ones(B, bool)
    for _ in range(L):
        unf = active & ~frozen
        unf_bits = (unf * bit[:F]).sum(1, dtype=np.uint64)         # ballot
        n_unf = popcount(unf_bits[:, None] & colbits)              # (B, L)
        rf = rate * frozen.astype(np.float32)
        used = col[:, 0, :] * rf[:, :1]
        for f in range(1, F):                                      # in order
            used = used + col[:, f, :] * rf[:, f:f + 1]
        resid = bw - used
        resid = np.where(resid < 0, np.float32(0), resid)
        fair = np.where(n_unf > 0, resid / np.maximum(n_unf, np.float32(1)),
                        BIG).astype(np.float32)
        fair = np.where((bw <= 0) & (n_unf > 0), np.float32(0), fair)
        lanes = np.full((B, WARP), np.inf, np.float32)
        lanes[:, :L] = fair
        for off in (16, 8, 4, 2, 1):                               # butterfly
            lanes = min_nan(lanes, lanes[:, np.arange(WARP) ^ off])
        level = lanes[:, :1]                                       # thread 0
        thresh = level + EPS
        bottleneck = ((fair <= thresh) * bit[:L]).sum(1, dtype=np.uint64)
        newly = unf & ((rowbits & bottleneck[:, None]) != 0) & running[:, None]
        rate = np.where(newly, level, rate)
        frozen = frozen | newly
        running &= newly.any(1)
        if not running.any():
            break
    return np.where(active, rate, np.float32(0))


def maxmin_inputs(seed, B, F, L, edge=None):
    """chip_smoke.py's ``maxmin_inputs`` on the CPU from numpy draws:
    (inc, bw, active) as torch tensors."""
    rng = np.random.default_rng(seed)
    links = rng.integers(-1, L, (B, F, 3)).astype(np.int32)
    links[..., 0] = rng.integers(0, L, (B, F))
    sweep = np.array([8.0, 2.0, 0.5, 0.125, 0.2, 0.0, 1.3], np.float32)
    bw = sweep[rng.integers(0, len(sweep), (B, L))]
    active = rng.random((B, F)) < 0.7
    if edge == "idle":
        active[:] = False
    elif edge == "no_bw":
        bw[:] = 0.0
    elif edge == "neg_bw":
        bw = np.where(rng.random((B, L)) < 0.3, np.float32(-1.5), bw)
    elif edge == "repeat":
        links[..., 1] = links[..., 0]
        links[..., 2] = links[..., 0]
    return (net.incidence(torch.from_numpy(links), L),
            torch.from_numpy(bw.astype(np.float32)),
            torch.from_numpy(active))


def test_flow_order_is_left_to_right_up_to_32_flows_and_links():
    """The dispatch rule's premise: every shape the warp kernel takes sums
    its flows left to right in the plain version."""
    for F in range(1, WARP + 1):
        for L in range(1, WARP + 1):
            for B in (1, 2, 8, 2048):
                assert ref.flow_order(F, L, B) == ref.LEFT_TO_RIGHT, (F, L, B)


@pytest.mark.parametrize("cases", [
    [(64, 32, 4, None), (16, 32, 32, None), (64, 7, 3, None),
     (5, 1, 32, None), (5, 32, 1, None)],
    [(64, 32, 4, e) for e in ("idle", "no_bw", "neg_bw", "repeat")],
], ids=["seeded", "edges"])
def test_warp_round_equals_plain_maxmin_bit_for_bit(cases):
    """Ballot counts, left-to-right frozen sums, the warp min, the freeze
    and the early stop give ``ref.maxmin_rates``' bits."""
    for i, (B, F, L, edge) in enumerate(cases):
        inc, bw, active = maxmin_inputs(100 + i, B, F, L, edge)
        want = ref.maxmin_rates(inc, bw, active).numpy()
        got = warp_model(inc.numpy(), bw.numpy(), active.numpy())
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32),
                                      err_msg=f"{(B, F, L, edge)}")
