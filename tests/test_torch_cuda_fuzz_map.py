"""The map's op interplay on the card: tests/test_fuzz_map.py's random
interleavings of insert (paged on last_key), insert_exact, grow_capacity
and reroot_double, drawn per seed as run_fuzz draws them
(tests/torch_fuzz.py), through a pool on the card, the port's own pool on
the CPU and the numpy oracle.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, so on a machine without jax run this with

    python -m pytest tests/test_torch_cuda_fuzz_map.py --noconftest -q

Tolerances: after every round the card's pool equals the CPU's word for
word (child, value, n_nodes, the capacity, centre, half size, the
overflow flag), and its occupied leaves match the oracle's set, alpha
exact and colour within one level (the oracle blends in float64 and
truncates)."""

import numpy as np
import pytest
import torch

import oracle as orc
from torch_fuzz import (Spec, apply_oracle, apply_port, compare_oracle,
                        differing_words, pool_arrays, run_rounds)

from octree_slam_tpu_torch.map import svo

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_on_card_matches_oracle_and_cpu(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: drives the map ops on the card")
    spec = Spec()

    def check(step, rnd, targets, passes):
        card, cpu, o = targets
        ctx = f"seed={seed} step={step} op={rnd.label}"
        assert differing_words(pool_arrays(card), pool_arrays(cpu)) == 0, ctx
        assert [p[0] for p in passes] == [p[1] for p in passes], ctx
        compare_oracle(card, rnd.depth, o, ctx)

    targets = [svo.create(spec.capacity, torch.zeros(3), spec.half_size,
                          device=dev) for dev in ("cuda", "cpu")]
    targets.append(orc.OracleOctree((0.0, 0.0, 0.0), spec.half_size,
                                    spec.depth))
    run_rounds(np.random.default_rng(seed), targets,
               (apply_port, apply_port, apply_oracle), spec, [None] * 10,
               check)
