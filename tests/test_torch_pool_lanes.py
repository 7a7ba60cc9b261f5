"""A NumPy model of K4's lane kernels (``csrc/tree_pool_iz.cu``, C <= 8 and
up to 5 rounds) against the port's plain pool and its backward and against
JAX ``tree_pool(mode="avg_ignore_zeros")`` and its ``jax.vjp``, on the CPU.

The model runs the kernels' schedule on every lane at once: a lane per leaf
row (lane = row, as one thread a row in blocks of 256 makes it), round m =
1, 2, 4, ... pairs lane i with lane i ^ m (the shuffle), both lanes merge
the pair without knowing which side they are, ``(own zero ? partner : own)
+ (partner zero ? own : partner)`` halved (the sum of the left / right
rule's two terms in the other order on the right lane), or ``(own +
partner)`` halved in a warp of 32 lanes none of which holds a zero row (the
ballot), and each lane keeps two zero flags a round, its own node's and its
partner's. The forward's team
writes its group's row, lane t channels t, t + 2^steps, ...; the backward
walks each leaf's path from the top on those flags alone. Lanes past N (the
ragged last block) run the rounds on rows of their own and store nothing.
Everything is compared bit for bit, the sign of zero included: the kernels
are held to the plain versions so on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.ops.pooling import tree_pool as jax_tree_pool
from facet_graph_convolution_torch.ops import tree_pool_kernel as k4

HALF = np.float32(0.5)
BLOCK = 256          # threads a block: lanes past N fill the last one
GROUPS = 111         # N = 111 · 2^steps: the last warp and block ragged below 5 rounds


def _pool_input(rng, n, c):
    """Zero rows, zero groups (32 rows, a group at every steps up to 5),
    -0.0 rows, an all -0.0 pair and a pair whose mean is exactly zero."""
    x = rng.normal(size=(n, c)).astype(np.float32)
    x[rng.random(n) < 0.3] = 0.0
    x[32:64] = 0.0
    x[1] = -0.0
    x[2:4] = -0.0
    x[5, :] = 0.0
    x[5, -1] = -0.0
    x[70] = rng.normal(size=c).astype(np.float32)
    x[71] = -x[70]
    return x


def _lanes(x, dead):
    """x [N, C] padded to whole blocks: lanes past N hold ``dead`` rows."""
    n, c = x.shape
    pad = -n % BLOCK
    return np.concatenate([x, np.full((pad, c), dead, np.float32)]), n


def _rounds(v, steps):
    """The butterfly on every lane: the lanes' rows after ``steps`` rounds
    and flags [lanes, steps, 2] (own node zero, partner's node zero)."""
    lane = np.arange(v.shape[0])
    z = (v == 0).all(axis=1)
    flags = np.zeros((v.shape[0], steps, 2), bool)
    for r in range(steps):
        m = 1 << r
        o, zo = v[lane ^ m], z[lane ^ m]           # __shfl_xor_sync
        flags[:, r, 0], flags[:, r, 1] = z, zo
        rule = (np.where(z[:, None], o, v) + np.where(zo[:, None], v, o)) * HALF
        ballot = z.reshape(-1, 32).any(axis=1).repeat(32)   # a zero row in the warp
        v = np.where(ballot[:, None], rule, (v + o) * HALF)
        z = (v == 0).all(axis=1)
    return v, flags


def _sided_merge(v, z, o, zo, left_is_partner):
    """The pair rule with a the left row and b the right one, as the plain
    version writes it."""
    a = np.where(left_is_partner[:, None], o, v)
    b = np.where(left_is_partner[:, None], v, o)
    za, zb = np.where(left_is_partner, zo, z), np.where(left_is_partner, z, zo)
    return (np.where(za[:, None], b, a) + np.where(zb[:, None], a, b)) * HALF


def lane_forward(x, steps, dead=0.0):
    """The lane forward: [N, C] -> [N >> steps, C]; every output value
    stored exactly once, by the team's lane t for channel t (mod 2^steps)."""
    lanes, n = _lanes(x, dead)
    v, _ = _rounds(lanes, steps)
    team = 1 << steps
    out = np.zeros((n >> steps, x.shape[1]), np.float32)
    stores = np.zeros(out.shape, int)
    for row in range(n):                           # dead lanes store nothing
        for ch in range(x.shape[1]):
            if ch & (team - 1) == row & (team - 1):
                out[row >> steps, ch] = v[row, ch]
                stores[row >> steps, ch] += 1
    assert (stores == 1).all()
    return out


def lane_backward(x, dy, steps, dead=0.0):
    """The lane backward: dx [N, C], each lane its own leaf's path from the
    top on its two flags a round."""
    lanes, n = _lanes(x, dead)
    _, flags = _rounds(lanes, steps)
    lane = np.arange(n)
    d = dy[lane >> steps]                          # a team's lanes on one dy row
    for r in reversed(range(steps)):
        own, other = flags[:n, r, 0], flags[:n, r, 1]
        h = d * HALF                               # the node's h where it is not zero,
        d = (np.where(own[:, None], np.float32(0), h)   # its partner's where that is
             + np.where(other[:, None], h, np.float32(0)))
    return d


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


STEPS = [0, 1, 2, 3, 4, 5]
CHANNELS = [1, 3, 8]


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("c", CHANNELS)
def test_lane_forward_matches_plain_and_jax(c, steps):
    rng = np.random.default_rng(100 * c + steps)
    x = _pool_input(rng, GROUPS << steps, c)
    got = lane_forward(x, steps)
    plain = k4.tree_pool_ignore_zeros_plain(torch.as_tensor(x), steps).numpy()
    want = np.asarray(jax_tree_pool(jnp.asarray(x), steps, "avg_ignore_zeros"))
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("c", CHANNELS)
def test_lane_backward_matches_plain_and_jax(c, steps):
    rng = np.random.default_rng(200 * c + steps)
    x = _pool_input(rng, GROUPS << steps, c)
    dy = rng.normal(size=(GROUPS, c)).astype(np.float32)
    got = lane_backward(x, dy, steps)
    plain = k4.tree_pool_ignore_zeros_bwd_plain(torch.as_tensor(x), torch.as_tensor(dy),
                                                steps).numpy()
    _, vjp = jax.vjp(lambda a: jax_tree_pool(a, steps, "avg_ignore_zeros"), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("steps", [2, 4])
def test_lane_warps_without_zero_rows(steps):
    """Zero rows in a few warps only: the other warps merge by (own +
    partner) * 0.5, the same bits, forward and backward."""
    rng = np.random.default_rng(300 + steps)
    x = rng.normal(size=(GROUPS << steps, 3)).astype(np.float32)
    x[32:64] = 0.0
    x[5] = -0.0
    x[rng.random(x.shape[0]) < 0.002] = 0.0
    whole = x[:x.shape[0] // 32 * 32].reshape(-1, 32, 3)      # the full warps
    assert (whole != 0).any(axis=2).all(axis=1).mean() > 0.5
    dy = rng.normal(size=(GROUPS, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(lane_forward(x, steps)),
        _bits(k4.tree_pool_ignore_zeros_plain(torch.as_tensor(x), steps).numpy()))
    np.testing.assert_array_equal(
        _bits(lane_backward(x, dy, steps)),
        _bits(k4.tree_pool_ignore_zeros_bwd_plain(torch.as_tensor(x), torch.as_tensor(dy),
                                                  steps).numpy()))


@pytest.mark.parametrize("c", CHANNELS)
def test_side_free_merge_is_the_sided_rule(c):
    """Every lane's merge in every round equals the left / right rule's bits,
    the sign of zero included, on both sides of every pair."""
    rng = np.random.default_rng(c)
    v = _pool_input(rng, GROUPS << 5, c)
    lane = np.arange(v.shape[0])
    z = (v == 0).all(axis=1)
    for r in range(5):
        m = 1 << r
        o, zo = v[lane ^ m], z[lane ^ m]
        merged = (np.where(z[:, None], o, v) + np.where(zo[:, None], v, o)) * HALF
        np.testing.assert_array_equal(_bits(merged),
                                      _bits(_sided_merge(v, z, o, zo, (lane & m) != 0)))
        if r == 0:                                 # the all -0.0 pair's -0.0
            assert ((merged == 0) & np.signbit(merged)).any()
        v, z = merged, (merged == 0).all(axis=1)


@pytest.mark.parametrize("steps", [2, 4, 5])
def test_dead_lanes_reach_no_live_team(steps):
    """Lanes past N shuffle only among themselves: whatever rows they hold
    (NaN, ones), the live teams' results are the same bits."""
    rng = np.random.default_rng(steps)
    x = _pool_input(rng, GROUPS << steps, 3)
    dy = rng.normal(size=(GROUPS, 3)).astype(np.float32)
    assert (GROUPS << steps) % BLOCK
    for dead in (np.nan, 1.0):
        np.testing.assert_array_equal(_bits(lane_forward(x, steps, dead)),
                                      _bits(lane_forward(x, steps)))
        np.testing.assert_array_equal(_bits(lane_backward(x, dy, steps, dead)),
                                      _bits(lane_backward(x, dy, steps)))


def test_inputs_reach_the_zero_cases():
    """The inputs hold what the rule must get right: a zero group at every
    steps, -0.0 rows, an all -0.0 pair that pools to -0.0, and a pair that
    cancels to a zero node."""
    x = _pool_input(np.random.default_rng(0), GROUPS << 5, 3)
    assert (x[32:64] == 0).all() and np.signbit(x[1]).all()
    assert np.signbit(lane_forward(x[:4], 1)[1]).all()
    assert (lane_forward(x[70:72], 1) == 0).all()
