"""The int8 dequant-matmul's tile and split-K plan (`_plan`), which the
wrapper computes on the host and hands to the Hopper kernel, and the
wrapper's operand checks, on the CPU."""
import importlib.util
import math
import pathlib

import pytest
import torch

from paddle_tpu_torch.kernels import quant_matmul as qm

SM_COUNT = 132                    # an H100 SXM


def _leaf_kn():
    """chip_smoke.LEAF_KN: (K, N) of the GPT serving path's int8 leaves."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.LEAF_KN


LEAF_KN = _leaf_kn()
PLAN_SHAPES = ([(m, k, n) for m in (8, 128, 512)
                for k, n in LEAF_KN.values()]
               + [(1, 64, 128), (33, 256, 96), (5, 200, 130), (17, 70, 40),
                  (8, 33, 16), (16, 4096, 130), (1, 1, 1)])


def _split_rows(plan, K):
    """The K rows each split's block walks: [begin, end)."""
    rows = []
    for s in range(plan.splits):
        begin = s * plan.chunks_per_split * qm.TILE_K
        end = min(K, (s + 1) * plan.chunks_per_split * qm.TILE_K)
        rows.append((begin, end))
    return rows


@pytest.mark.parametrize("cap", [1, qm.MAX_SPLITS, 1 << 20])
@pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
def test_plan_reads_every_k_row_once_in_whole_chunks(M, K, N, cap):
    plan = qm._plan(M, K, N, SM_COUNT, max_splits=cap)
    assert plan.splits <= cap
    assert plan.chunks == math.ceil(K / qm.TILE_K)
    assert plan.splits * plan.chunks_per_split >= plan.chunks
    covered = []
    for begin, end in _split_rows(plan, K):
        assert begin % qm.TILE_K == 0 and begin < end   # no empty split
        covered.extend(range(begin, end))
    assert covered == list(range(K))
    assert plan.m_tiles * plan.bm >= M > (plan.m_tiles - 1) * plan.bm
    assert plan.n_tiles * qm.TILE_N >= N > (plan.n_tiles - 1) * qm.TILE_N


@pytest.mark.parametrize("leaf", sorted(LEAF_KN))
def test_plan_fills_a_wave_at_every_decode_leaf_up_to_the_cap(leaf):
    """At M = 8 the grid fills one wave of 132 SMs unless that takes more
    than MAX_SPLITS splits a tile (then it takes the cap); without the
    cap it always fills one."""
    K, N = LEAF_KN[leaf]
    plan = qm._plan(8, K, N, SM_COUNT)
    tiles = plan.m_tiles * plan.n_tiles
    assert plan.bm == 8 and plan.splits <= qm.MAX_SPLITS
    assert tiles * plan.splits >= SM_COUNT or plan.splits == qm.MAX_SPLITS
    free = qm._plan(8, K, N, SM_COUNT, max_splits=1 << 20)
    assert free.m_tiles * free.n_tiles * free.splits >= SM_COUNT


@pytest.mark.parametrize("leaf", sorted(LEAF_KN))
@pytest.mark.parametrize("M", [128, 512])
def test_plan_never_splits_at_prefill(leaf, M):
    K, N = LEAF_KN[leaf]
    plan = qm._plan(M, K, N, SM_COUNT)
    assert plan.bm == 64
    assert plan.splits == 1 and plan.chunks_per_split == plan.chunks
    assert plan.workspace_floats == 0


@pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
def test_plan_sizes_the_workspace(M, K, N):
    plan = qm._plan(M, K, N, SM_COUNT)
    tiles = plan.m_tiles * plan.n_tiles
    want = tiles * plan.splits * plan.bm * qm.TILE_N if plan.splits > 1 \
        else 0
    assert plan.workspace_floats == want


def test_plan_is_one_block_a_tile_on_a_full_grid():
    """The head at decode already has 256 tiles: no split."""
    plan = qm._plan(8, 1024, 32768, SM_COUNT)
    assert plan.splits == 1 and plan.n_tiles == 256


def _operands(M=8, K=128, N=256):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    s = torch.rand(N, generator=g) * 1e-2 + 1e-4
    return x, w, s


def test_operand_checks_raise_as_before():
    x, w, s = _operands()
    qm._check_cuda_operands(x, w, s)                # well-formed: passes
    qm._check_cuda_operands(x.float(), w, s)
    cases = [
        ((x, w.t().contiguous().t(), s), ValueError, "contiguous"),
        ((torch.cat([x, x], 1)[:, ::2], w, s), ValueError, "contiguous"),
        ((x.half(), w, s), TypeError, "dtype"),
        ((x, w.float(), s), TypeError, "int8"),
        ((x, w, s.double()), TypeError, "float32"),
        ((x[:, :64].contiguous(), w, s), ValueError, "shapes"),
        ((x, w, s[:10]), ValueError, "shapes"),
        ((x, w[None], s), ValueError, "shapes"),
    ]
    for args, exc, match in cases:
        with pytest.raises(exc, match=match):
            qm._check_cuda_operands(*args)
