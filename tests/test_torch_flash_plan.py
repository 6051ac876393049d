"""The decode attention kernel's capacity splits, on the CPU.

``kernels/flash_decode.py``'s planner (:func:`plan_splits`,
:func:`split_bounds`) chooses how many blocks (P, one thread-block cluster)
share each capacity shard inside the kernel's one launch, and the blocks
merge their softmax states in split order (``ref.merge_partials_ref``).
These tests hold the plan's coverage and limits, and hold the plain merge
of P split states against the un-split shard's state (the port's
``ref.flash_decode_shards_ref`` and the reference's interpret-mode
``flash_decode_partial``).

Tolerances: f32 states within 2e-4 of |want| + sum p |v| (the sum over a
shard taken in another order, exp within an ulp) + 2e-5, as the card's
tests hold the kernel; an all-masked shard exactly (m = -1e30, l = its
slot count).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import (flash_decode_partial as
                                        jax_flash_decode_partial)
from repro_torch.kernels import ref
from repro_torch.kernels.flash_decode import (CHUNK, MAX_SPLITS, plan_splits,
                                              split_bounds)

NEG = -1e30

# (B, K, C, S): the serving shapes of chip_smoke.py's FLASH_CASES and of
# tests/test_torch_cuda.py, smoke shapes, and capacities no chunk divides
PLAN_SHAPES = [(4, 8, 256, 1), (4, 8, 256, 4), (4, 8, 8192, 1),
               (4, 8, 8192, 4), (4, 8, 8192, 16), (4, 8, 4096, 1),
               (4, 8, 4096, 4), (3, 2, 148, 1), (3, 2, 148, 4),
               (3, 4, 74, 1), (3, 4, 74, 2), (1, 1, 7, 1), (2, 2, 31, 1),
               (1, 1, 64, 1), (1, 1, 65, 1), (2, 1, 1000, 8),
               # gemma3-1b's one kv head and yi-6b's four (phase 10)
               (4, 1, 512, 1), (4, 1, 512, 4), (4, 1, 8192, 1),
               (4, 1, 8192, 4), (4, 4, 256, 1), (4, 4, 256, 4),
               (4, 4, 8192, 1), (4, 4, 8192, 4)]
SM_COUNTS = [8, 132]


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_every_slot_once_within_the_cluster_limit(shape, sm):
    B, K, C, S = shape
    P = plan_splits(B, K, C, S, sm)
    assert 1 <= P <= MAX_SPLITS and P & (P - 1) == 0
    bounds = split_bounds(C, S, P)
    assert len(bounds) == S * P
    # in order, back to back, from slot 0 to C: every slot exactly once
    assert bounds[0][0] == 0 and bounds[-1][1] == C
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    n = C // S
    for s in range(S):                    # no split crosses a shard
        assert bounds[s * P][0] == s * n and bounds[s * P + P - 1][1] \
            == (s + 1) * n
    # no split shorter than a chunk, unless the shard is
    assert min(hi - lo for lo, hi in bounds) >= min(CHUNK, n)
    # one more doubling would break a limit
    if P < MAX_SPLITS:
        assert B * K * S * 2 * P > 2 * sm or n // (2 * P) < CHUNK


@pytest.mark.parametrize("shape", [s for s in PLAN_SHAPES
                                   if s[0] * s[1] * s[3] >= 2], ids=str)
def test_plan_is_one_split_when_the_grid_fills_the_card(shape):
    B, K, C, S = shape
    sm = (B * K * S) // 2                 # two blocks per SM already
    assert plan_splits(B, K, C, S, sm) == 1


def test_plan_at_the_serving_shapes():
    """An H100's 132 SMs: llama's C 256 takes 8 splits of two chunks each
    (2 x 32 slots per shard at S 4), its long cache 8 x 1024 slots (2 x
    1024 per shard at S 4, none at S 16), mixtral's window 8 x 512 (2 x 512
    per shard at S 4); the smoke capacities no chunk divides get splits of
    18 or 19 slots."""
    assert [plan_splits(*s, 132) for s in PLAN_SHAPES[:11]] == \
        [8, 2, 8, 2, 1, 8, 2, 8, 2, 4, 2]
    assert split_bounds(148, 4, 2) == [(0, 18), (18, 37), (37, 55),
                                       (55, 74), (74, 92), (92, 111),
                                       (111, 129), (129, 148)]
    # gemma3-1b's one kv head: 8 splits at every shape (its 512-slot
    # window at S 4 in splits of one chunk); yi-6b's four: 4 at S 4
    assert [plan_splits(*s, 132) for s in PLAN_SHAPES[16:]] == \
        [8, 8, 8, 8, 8, 4, 8, 4]


def _operands(seed, B, K, G, D, C, valid):
    """f32 q, k, v and a bias of 0 / -1e30 with row b valid on its first
    valid[b] slots."""
    rng = np.random.default_rng(seed)
    q, k, v = (0.5 * rng.standard_normal(s).astype(np.float32)
               for s in ((B, K, G, D), (B, C, K, D), (B, C, K, D)))
    bias = np.where(np.arange(C)[None, :] < np.asarray(valid)[:, None],
                    0.0, NEG).astype(np.float32)
    return q, k, v, bias


def _merged_splits(q, k, v, bias, S, P):
    """Each shard's P splits through ``flash_decode_shards_ref`` (one shard
    a split), stacked and merged by ``merge_partials_ref``: (acc, m, l)
    with a leading shard axis, as the kernel's clusters flush them."""
    bounds = split_bounds(k.shape[1], S, P)
    out = []
    for s in range(S):
        parts = [ref.flash_decode_shards_ref(q, k[:, lo:hi], v[:, lo:hi],
                                             bias[:, lo:hi], shards=1)
                 for lo, hi in bounds[s * P:(s + 1) * P]]
        stacked = [torch.cat(x) for x in zip(*parts)]
        out.append(ref.merge_partials_ref(*stacked))
    return tuple(torch.stack(x) for x in zip(*out))


# (B, K, G, D, C, S, valid slots per row): a row with one valid slot; rows
# whose later splits (and later shards) are all-masked inside shards that
# have valid slots; capacities no chunk divides
MERGE_CASES = [(4, 2, 4, 64, 256, 1, [1, 40, 256, 33]),
               (4, 2, 4, 64, 256, 2, [1, 100, 256, 129]),
               (3, 2, 2, 32, 148, 1, [1, 74, 148]),
               (3, 2, 6, 32, 148, 4, [37, 5, 148]),
               (3, 4, 6, 32, 74, 2, [1, 40, 74])]


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("case", MERGE_CASES, ids=str)
def test_merged_splits_equal_the_unsplit_shard(case, P):
    B, K, G, D, C, S, valid = case
    n = C // S
    q, k, v, bias = (torch.from_numpy(a) for a in _operands(
        sum(case[:6]) + P, B, K, G, D, C, valid))
    acc, m, l = _merged_splits(q, k, v, bias, S, P)
    wa, wm, wl = ref.flash_decode_shards_ref(q, k, v, bias, shards=S)
    ta = ref.flash_decode_shards_ref(q, k, v.abs(), bias, shards=S)[0]
    assert (acc.shape, m.shape, l.shape) == (wa.shape, wm.shape, wl.shape)
    assert bool(((acc - wa).abs() <= 2e-4 * (wa.abs() + ta) + 2e-5).all())
    assert bool(((m - wm).abs() <= 2e-4 * wm.abs() + 2e-5).all())
    assert bool(((l - wl).abs() <= 2e-4 * wl + 2e-5).all())
    dead = wm == NEG
    assert bool(dead.any()) == any(vb <= (S - 1) * n for vb in valid)
    assert bool((m[dead] == NEG).all()) and bool((l[dead] == n).all())
    # the case holds an all-masked split inside a shard with valid slots
    bounds = split_bounds(C, S, P)
    live_dead_split = any(
        lo >= valid[b] and bounds[(lo // n) * P][0] < valid[b]
        for b, (lo, _) in itertools.product(range(B), bounds))
    if P > 1:
        assert live_dead_split


@pytest.mark.parametrize("case", MERGE_CASES, ids=str)
def test_merged_splits_match_the_reference_kernel_per_shard(case):
    """The planner's splits of each shard, merged, against the reference's
    interpret-mode ``flash_decode_partial`` on that shard."""
    B, K, G, D, C, S, valid = case
    n = C // S
    P = plan_splits(B, K, C, S, 132)
    arrs = _operands(sum(case[:6]), B, K, G, D, C, valid)
    acc, m, l = _merged_splits(*(torch.from_numpy(a) for a in arrs), S, P)
    q, k, v, bias = (jnp.asarray(a) for a in arrs)
    for s in range(S):
        sl = slice(s * n, (s + 1) * n)
        ja, jm, jl = (np.asarray(x) for x in jax_flash_decode_partial(
            q, k[:, sl], v[:, sl], bias[:, sl], bc=n, interpret=True))
        np.testing.assert_allclose(acc[s].numpy(), ja, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(m[s].numpy(), jm, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(l[s].numpy(), jl, rtol=2e-4, atol=2e-5)
        dead = jm == NEG
        np.testing.assert_array_equal(m[s].numpy()[dead], np.float32(NEG))
        np.testing.assert_array_equal(l[s].numpy()[dead], np.float32(n))
