"""The host side of K2's grid and reduction and of K7a's ring, on the CPU:
the persistent grid from a kernel's resident blocks, K2's shared-memory
layout with the reduction's lead table, and the ring's buffers in K7a's and
the profiling kernels' shared memory. Nothing here needs the card."""

import numpy as np
import pytest
import torch

from infera_tpu_torch.ops import _kernels
from infera_tpu_torch.ops import fused_query as fq
from infera_tpu_torch.ops import fused_sql as fs
from infera_tpu_torch.testing import profile_query as pq

# MLP widths the port's tests and the main path run (K1, K7a, K8, K2')
MLPS = [(32, 64, 64, 16), (32, 128, 128, 16), (30, 200, 7), (32, 16), (5, 3), (4, 32, 1),
        (8, 4), (30, 64, 48, 10), (1, 64, 10), (33, 64, 10), (128, 64, 10), (5, 130, 3)]


def _old_rows_smem(dims) -> int:
    """K7a's shared memory before the ring: K1's and a [64][d0 | 1] f32
    staging tile."""
    return fq.query_smem_bytes(dims) + 4 * 64 * (dims[0] | 1)


@pytest.fixture()
def card(monkeypatch):
    """A device of 132 SMs without a card: grid_blocks reads the SM count
    from its cache."""
    monkeypatch.setitem(_kernels._SM_COUNT, 0, 132)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("per_sm,n_tiles,want", [(2, 4096, 264), (1, 4096, 132), (8, 4096, 1056),
                                                 (3, 100, 100), (2, 1, 1), (0, 4096, 132)])
def test_grid_blocks_from_resident_blocks(card, per_sm, n_tiles, want):
    assert _kernels.grid_blocks(card, n_tiles, 5456, per_sm) == want


def test_grid_blocks_without_resident_blocks_guesses_from_shared_memory(card):
    # 228 KB of an SM over 5,456 + 1,024 bytes a block: 36, capped at 8
    assert _kernels.grid_blocks(card, 4096, 5456) == 132 * 8
    assert _kernels.grid_blocks(card, 4096, 192_320) == 132
    assert _kernels.smem_blocks_per_sm(100_000) == 2


def _plan(G, n_sums, preds=()):
    consts = [0.0]
    return fs.FusedPlan(where=None, keys=[[(fs.COL, 0)]],
                        sums=[[(fs.COL, 1 + s % 4)] for s in range(n_sums)],
                        mins=[[(fs.COL, 1)]], maxs=[[(fs.COL, 2)]], strides=[1], n_groups=G,
                        consts=consts, preds=list(preds))


def _mlp_slot(dims, seed=0):
    rng = np.random.default_rng(seed)
    params = [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32),
               rng.standard_normal(dims[i + 1]).astype(np.float32))
              for i in range(len(dims) - 1)]
    return fs.MlpSlot(params=params, final_softmax=False, out_col=0, bf16=False,
                      features=[[(fs.COL, 1 + k % 4)] for k in range(dims[0])])


def _layout(plan):
    n_words, blob = fs._sizes(plan)
    return fs.smem_layout(plan, n_words, blob)


@pytest.mark.parametrize("dims", [(4, 32, 1), (32, 128, 128, 16), (8, 4)])
@pytest.mark.parametrize("G", [1, 64, 512])
def test_lead_table_lies_over_the_mlp_tiles(dims, G):
    """With an MLP slot the lead table ([8][G] bytes) fits in the dead MLP
    tiles and predictions, so the plan's shared memory does not grow."""
    lay = _layout(_plan(G, 3, [_mlp_slot(dims)]))
    assert lay["lead"] == lay["act0"]
    assert fs.WARPS * G <= lay["vals"] - lay["act0"]


def test_lead_table_after_the_rest_when_the_plan_has_room():
    lay = _layout(_plan(512, 3))
    assert lay["act0"] == lay["vals"] == lay["pred"]      # no MLP, no prediction slot
    assert lay["total"] == lay["lead"] + fs.WARPS * 512  # after every other section


def test_no_plan_stops_fitting_for_the_lead_table():
    """A plan within 8 * G bytes of the limit keeps fitting: its kernel
    combines without the table (lead -1)."""
    fitted = None
    for n_sums in range(1, 80):
        lay = _layout(_plan(512, n_sums))
        before = lay["total"] - (fs.WARPS * 512 if lay["lead"] >= 0 else 0)
        if before > fs.SMEM_LIMIT:
            break
        assert lay["total"] <= fs.SMEM_LIMIT
        assert fs.smem_fits(_plan(512, n_sums))
        fitted = lay
    assert fitted is not None and fitted["lead"] == -1


@pytest.mark.parametrize("dims", MLPS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_mlp_that_fit_still_fits_with_the_ring(dims, itemsize):
    """K7a's ring shrinks rather than let an MLP that fit stop fitting."""
    new = fq.rows_query_smem_bytes(dims, itemsize)
    if _old_rows_smem(dims) <= fq.SMEM_LIMIT:
        assert new <= fq.SMEM_LIMIT
    stages = fq.ring_stages(dims, itemsize)
    assert 0 <= stages <= fq.MAX_RING_STAGES
    if dims[0] * itemsize % 16:
        assert stages == 0
    assert new == fq.query_smem_bytes(dims) + stages * 64 * fq.ring_stride(dims[0], itemsize)


def test_ring_stages_cover_the_bytes_in_flight_and_shrink_to_fit():
    bench = (32, 128, 128, 16)
    # bf16: 5 tiles of 4 KB ahead; f32: 3 of 8 KB
    assert (fq.ring_stages(bench, 2) - 1) * 64 * 32 * 2 >= fq.RING_IN_FLIGHT
    assert (fq.ring_stages(bench, 4) - 1) * 64 * 32 * 4 >= fq.RING_IN_FLIGHT
    # a row of 128 bf16 values is 16 KB a tile: one ahead is 16 KB, two 32
    assert fq.ring_stages((128, 64, 10), 2) == 3
    # an MLP that leaves room for fewer buffers gets fewer, then none
    wide = (32, 400, 16)
    room = fq.SMEM_LIMIT - fq.query_smem_bytes(wide)
    stage = 64 * fq.ring_stride(32, 2)
    assert fq.ring_stages(wide, 2) == min(6, max(0, room // stage))
    assert fq.ring_stages(bench, 2, extra=fq.SMEM_LIMIT) == 0


def test_stride_is_an_odd_number_of_words():
    for d0 in (8, 16, 24, 32, 64, 128):
        for item in (2, 4):
            s = fq.ring_stride(d0, item)
            assert s % 16 == 0 and (s // 16) % 2 == 1 and s >= d0 * item


def test_profiling_kernels_share_k7a_ring_and_grid():
    """The stage kernel's ring (beside its scratch) has K7a bf16's buffers at
    the profiling MLP, and K8a's grid is K7a's."""
    dims = pq.PROFILE_DIMS
    assert pq.ring_stages(dims) == fq.ring_stages(dims, 2) == 6
    assert pq.ring_stages((32,)) == 6
    assert pq._stage_smem_bytes(dims) == fq.rows_query_smem_bytes(dims, 2) + pq._SCRATCH
    assert pq._stage_smem_bytes(dims) <= fq.SMEM_LIMIT


def test_workspace_layout_is_aligned_and_sized():
    plan = fs.FusedPlan(where=None, keys=[[(fs.COL, 0)]], sums=[[(fs.COL, 1)]],
                        mins=[], maxs=[[(fs.COL, 2)]], strides=[1], n_groups=6, consts=[],
                        ints=[(0, "sum")], args=[([(fs.COL, 1)], True)],
                        dists=[([(fs.COL, 0)], 8, "dist")])
    sections, total = fs.workspace_layout(plan, 264)
    assert len(sections) == 15
    shapes = [shp for _off, _n, _dt, shp in sections]
    assert shapes[:7] == [(264, 6), (264, 1, 6), (264, 3, 6), (264, 1, 6), (264, 1, 6),
                          (264, 1, 6), (264,)]
    assert shapes[7:] == [(6,), (1, 6), (3, 6), (1, 6), (1, 6), (1, 6), (1,), (48,)]
    end = 0
    for off, nbytes, dt, shp in sections:
        assert off % 16 == 0 and off >= end
        assert nbytes == int(np.prod(shp)) * torch.empty((), dtype=dt).element_size()
        end = off + nbytes
    assert total >= end
