"""The cluster plan of K1, K5 and K6 (``ops/cuda/lstm_kernel.py::cluster_plan``,
the mirror of ``csrc/lstm_cluster.cuh::plan``), a pure function of the row
count and the hidden width: every unit owned by exactly one block, a
power-of-two cluster of at most 16 blocks, each block's shared memory
within Hopper's 227 KB, and the clusters covering every row; and K1's
route rule (``serving_route``): the cluster route up to the largest width
the plan holds, the L2 route past it. The card test
``test_lstm_cluster_plan_matches_the_card`` holds both against the C plan."""

import pytest

from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk


@pytest.mark.parametrize("H", [8, 32, 100, 128, 256])
@pytest.mark.parametrize("rows", [1, 5, 32, 1024, 1030])
def test_cluster_plan_covers_units_and_rows(H, rows):
    plan = lk.cluster_plan(rows, H)
    owned = [u for begin, end in plan.slices for u in range(begin, end)]
    assert owned == list(range(H))
    assert len(plan.slices) == plan.C and all(end > begin for begin, end in plan.slices)
    assert max(end - begin for begin, end in plan.slices) == plan.U
    assert plan.C in (1, 2, 4, 8, 16)
    assert max(plan.smem_fwd, plan.smem_bwd) <= 232_448
    assert plan.R * plan.clusters >= rows > plan.R * (plan.clusters - 1)
    assert plan.blocks == 2 * plan.clusters * plan.C


def test_cluster_plan_of_the_training_towers():
    """The bench_train towers (H=128): 32-row towers in 8 clusters of 8
    blocks a direction (4 rows each), the 1024-row word tower in 64."""
    assert lk.cluster_plan(32, 128)[:3] == (8, 4, 16)
    assert lk.cluster_plan(32, 128).blocks == 128
    assert lk.cluster_plan(1024, 128)[:3] == (8, 16, 16)
    assert lk.cluster_plan(1024, 128).clusters == 64


@pytest.mark.parametrize("rows,H", [(4, 512), (0, 128), (4, 0)])
def test_cluster_plan_refuses_what_no_cluster_holds(rows, H):
    with pytest.raises(ValueError, match="no LSTM cluster plan"):
        lk.cluster_plan(rows, H)


def _largest_cluster_width(rows: int) -> int:
    return max(H for H in range(1, 1025) if lk.serving_route(rows, H) == "cluster")


@pytest.mark.parametrize("rows,edge", [(1, 448), (16, 448), (64, 448), (128, 432), (512, 384),
                                       (2048, 384)])
def test_serving_route_is_the_cluster_up_to_the_plans_edge(rows, edge):
    """K1 takes the cluster route for every width up to the largest one a
    plan holds (448 units at 4 rows a cluster, 432 at 8, 384 at 16: the
    h buffers grow with the rows) and the L2 route past it."""
    h_max = _largest_cluster_width(rows)
    assert h_max == edge
    assert all(lk.serving_route(rows, H) == "cluster" for H in range(1, h_max + 1))
    assert all(lk.serving_route(rows, H) == "l2" for H in range(h_max + 1, 1025))
    plan = lk.cluster_plan(rows, h_max)
    assert plan.C == 16 and max(plan.smem_fwd, plan.smem_bwd) <= lk.SMEM_LIMIT
    with pytest.raises(ValueError, match="no LSTM cluster plan"):
        lk.cluster_plan(rows, h_max + 1)


def test_serving_route_at_the_bench_towers():
    """Every serving tower of the bench and long-audio configurations (H=128)
    takes the cluster route, with K5's plan."""
    for rows in (64 * 32, 64, 16, 2):
        assert lk.serving_route(rows, 128) == "cluster"
    assert lk.cluster_plan(64, 128)[:3] == (8, 4, 16)
    assert lk.cluster_plan(16, 128).blocks == 64
    assert lk.cluster_plan(2048, 128)[:3] == (8, 16, 16)
