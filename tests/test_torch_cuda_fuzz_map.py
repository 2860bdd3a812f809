"""The map's op interplay on the card: tests/test_fuzz_map.py's random
interleavings of insert (paged on last_key), insert_exact, grow_capacity
and reroot_double, drawn per seed as run_fuzz draws them
(tests/torch_fuzz.py), through a pool on the card, the port's own pool on
the CPU and the numpy oracle: run_fuzz's sizes for three seeds, and once at
a run's size, without the oracle, whose dict octree takes minutes there
(RUN_SIZE: depth 9 at 2 cm leaves, inserts of a 640x480 frame's 307,200
points on a plane patch of 6 x 4.4 m paging at 65,536 uniques, exact
writes of up to 60,000 keys, a pool that ensure_headroom's rule grows from
2^20 nodes, one reroot_double to depth 10) with the ops of each round
given (RUN_ROUNDS).
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, so on a machine without jax run this with

    python -m pytest tests/test_torch_cuda_fuzz_map.py --noconftest -q

Tolerances: after every round the card's pool equals the CPU's word for
word (child, value, n_nodes, the capacity, centre, half size, the
overflow flag), and its occupied leaves match the oracle's set, alpha
exact and colour within one level (the oracle blends in float64 and
truncates); at the end the refreshed pools and their leaves equal word for
word too."""

import numpy as np
import pytest
import torch

import oracle as orc
from torch_fuzz import (Spec, apply_oracle, apply_port, compare_oracle,
                        differing_words, leaf_words, pool_arrays, run_rounds)

from octree_slam_tpu_torch.map import svo

pytestmark = pytest.mark.cuda


RUN_SIZE = Spec(depth=9, capacity=1 << 20, half_size=5.12,
                unique_cap=65_536, insert_n=(307_200, 307_201),
                exact_n=(40_000, 60_000), max_capacity=1 << 24,
                max_reroots=1, max_depth=10, surface=True)
RUN_ROUNDS = ["insert", "exact", "insert", "grow", "reroot", "insert",
              "exact", "insert"]


@pytest.mark.parametrize("spec,schedule,seed,least,oracle", [
    *[(Spec(), [None] * 10, seed, {}, True) for seed in range(3)],
    # at least two growths, a paged insert and the re-root
    (RUN_SIZE, RUN_ROUNDS, 0, {"grow": 2, "paged": 1, "reroot": 1}, False),
], ids=["seed0", "seed1", "seed2", "run_size"])
def test_fuzz_on_card_matches_oracle_and_cpu(spec, schedule, seed, least,
                                             oracle):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: drives the map ops on the card")
    depth = []

    def check(step, rnd, targets, passes):
        card, cpu = targets[:2]
        ctx = f"seed={seed} step={step} op={rnd.label}"
        assert differing_words(pool_arrays(card), pool_arrays(cpu)) == 0, ctx
        assert [p[0] for p in passes] == [p[1] for p in passes], ctx
        if oracle:
            compare_oracle(card, rnd.depth, targets[2], ctx)
        depth.append(rnd.depth)

    targets = [svo.create(spec.capacity, torch.zeros(3), spec.half_size,
                          device=dev) for dev in ("cuda", "cpu")]
    appliers = [apply_port, apply_port]
    if oracle:
        targets.append(orc.OracleOctree((0.0, 0.0, 0.0), spec.half_size,
                                        spec.depth))
        appliers.append(apply_oracle)
    seen = run_rounds(np.random.default_rng(seed), targets, appliers, spec,
                      schedule, check)
    for kind, n in least.items():
        assert seen[kind] >= n, seen
    leaves = []
    for pool in targets[:2]:
        ref, keys, nodes, words = leaf_words(pool, depth[-1], 1 << 19)
        leaves.append({"value": ref.value.cpu().numpy(), "keys": keys,
                       "nodes": nodes, "words": words})
    assert differing_words(*leaves) == 0
    assert leaves[1]["keys"].size > 0
