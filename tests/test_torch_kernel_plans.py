"""The host side of the port's redesigned kernels, on the CPU: the split
walk's plan (``paged_attention.kernel.walk_plan``), the fitness kernels'
route (``recovery.kernel.fitness_plan``) and what the wrappers refuse
before any launch.  These are pure functions of shapes; the kernels
themselves run on the card in ``test_torch_cuda.py``, and their plain
versions against JAX in ``test_torch_paged_*.py`` and
``test_torch_recovery.py``.
"""
import pytest
import torch

from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.recovery import kernel as rec_kernel

RT = pa_kernel.ROWS_PER_TILE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, S, G, Hkv, D, block_size, max_live_blocks, MB) ->
# (n_tiles, nb_live, pages_per_split, n_split)
WALKS = {
    "gemma_decode": ((4, 1, 8, 1, 256, 16, 4, 6), (1, 4, 1, 4)),
    "gemma_prefill": ((4, 16, 8, 1, 256, 16, 5, 5), (8, 5, 1, 5)),
    "granite_decode_gqa": ((4, 1, 4, 8, 64, 16, 8, 8), (1, 8, 1, 8)),
    "block4_pages_gt_splits": ((4, 1, 8, 1, 256, 4, 16, 20), (1, 16, 4, 4)),
    "block4_one_split": ((3, 5, 2, 2, 16, 4, 3, 5), (1, 3, 4, 1)),
    "block5_ragged": ((3, 4, 3, 2, 16, 5, 7, 8), (1, 7, 3, 3)),
    "block64_one_page": ((2, 3, 4, 2, 64, 64, 3, 3), (1, 3, 1, 3)),
    "block1": ((2, 3, 2, 1, 16, 1, 23, 26), (1, 23, 16, 2)),
    "live_clamped_to_table": ((2, 1, 2, 1, 16, 16, 50, 6), (1, 6, 1, 6)),
    "live_zero_walks_one": ((2, 1, 2, 1, 16, 16, 0, 6), (1, 1, 1, 1)),
    "rows_past_a_tile": ((2, 9, 4, 1, 64, 16, 2, 4), (3, 2, 1, 2)),
}


@pytest.mark.parametrize("case", list(WALKS))
def test_walk_plan_split_and_grid(case):
    """The split count, grid and workspace from host integers: one split
    of ``max(1, KEYS_PER_SPLIT // block_size)`` pages, as many splits as
    the walk's live blocks need, a workspace only when there are several."""
    (B, S, G, Hkv, D, BS, live, MB), want = WALKS[case]
    plan = pa_kernel.walk_plan(B, S, G, Hkv, D, BS, live, MB)
    assert (plan.n_tiles, plan.nb_live, plan.pages_per_split,
            plan.n_split) == want
    n_tiles, nb_live, pps, n_split = want
    assert plan.grid == (n_tiles * n_split, Hkv, B)
    assert n_tiles * RT >= S * G > (n_tiles - 1) * RT
    assert n_split * pps >= nb_live > (n_split - 1) * pps
    if n_split == 1:
        assert plan.workspace == 0 and plan.counters == 0
    else:
        slots = n_tiles * n_split * Hkv * B
        assert plan.workspace == slots * RT * (D + 2)
        assert plan.counters == n_tiles * Hkv * B


@pytest.mark.parametrize("BS", [1, 3, 4, 5, 16, 17, 64])
def test_walk_plan_split_boundaries_ignore_the_live_bound(BS):
    """A split's boundaries depend on the block size alone, so a row's
    result cannot change with the tick's live-block bound or the batch: the
    pages per split are the same for every bound, and each bound's splits
    are the first of the next bound's."""
    plans = [pa_kernel.walk_plan(4, 1, 8, 1, 256, BS, live, 64)
             for live in range(1, 65)]
    assert len({p.pages_per_split for p in plans}) == 1
    assert plans[0].pages_per_split == max(1, pa_kernel.KEYS_PER_SPLIT // BS)
    assert [p.n_split for p in plans] == sorted(p.n_split for p in plans)


@pytest.mark.parametrize("B,Hkv", [(pa_kernel.MAX_GRID_YZ + 1, 1),
                                   (1, pa_kernel.MAX_GRID_YZ + 1)],
                         ids=["batch", "kv_heads"])
def test_walk_plan_refuses_a_grid_beyond_the_card(B, Hkv):
    with pytest.raises(ValueError):
        pa_kernel.walk_plan(B, 1, 1, Hkv, 16, 16, 1, 1)


def test_wrapper_refuses_a_batch_beyond_the_grid():
    """``_check`` (which runs before any launch, on any device) refuses a
    batch the grid cannot hold."""
    B, D = pa_kernel.MAX_GRID_YZ + 1, 16
    q = torch.zeros(B, 1, 1, D)
    pool = torch.zeros(2, 4, 1, D)
    with pytest.raises(ValueError, match="grid"):
        pa_kernel._check(q, q, q, pool, pool,
                         torch.zeros(B, 1, dtype=torch.int32),
                         torch.zeros(B, 1, dtype=torch.int32))


@pytest.mark.parametrize("fn", ["update", "update_int8", "readonly"])
def test_wrappers_refuse_devices_without_a_kernel(fn):
    """Neither the CPU's plain version nor a kernel: a tensor on another
    device raises, as the fitness wrapper does."""
    B, S, H, Hkv, D, NB, BS = 1, 1, 2, 1, 16, 3, 4
    meta = torch.device("meta")
    q = torch.zeros(B, S, H, D, device=meta)
    kn = torch.zeros(B, S, Hkv, D, device=meta)
    tables = torch.zeros(B, 2, dtype=torch.int32, device=meta)
    pos = torch.zeros(B, S, dtype=torch.int32, device=meta)
    kw = dict(window=1 << 30, softcap=0.0, max_live_blocks=1)
    with pytest.raises(ValueError, match="no kernel"):
        if fn == "readonly":
            pool = torch.zeros(NB, BS, Hkv, D, device=meta)
            pa_kernel.paged_attention(q, pool, pool, tables, pos, **kw)
        elif fn == "update":
            pool = torch.zeros(NB, BS, Hkv, D, device=meta)
            pa_kernel.paged_attention_update(q, kn, kn, pool, pool, tables,
                                             pos, **kw)
        else:
            pool = torch.zeros(NB, BS, Hkv, D, dtype=torch.int8,
                               device=meta)
            scale = torch.zeros(NB, BS, Hkv, device=meta)
            pa_kernel.paged_attention_update(q, kn, kn, pool, pool, tables,
                                             pos, k_scale=scale,
                                             v_scale=scale, **kw)


def test_int8_wrapper_takes_fresh_rows_in_q_dtype():
    """The kernel quantizes the fresh rows itself, so the int8 update takes
    them in q's dtype and refuses rows already quantized."""
    B, S, H, Hkv, D, NB, BS = 1, 1, 2, 1, 16, 3, 4
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    pool = torch.zeros(NB, BS, Hkv, D, dtype=torch.int8)
    scale = torch.zeros(NB, BS, Hkv)
    tables = torch.zeros(B, 2, dtype=torch.int32)
    pos = torch.zeros(B, S, dtype=torch.int32)
    fresh = torch.zeros(B, S, Hkv, D, dtype=torch.bfloat16)
    pa_kernel._check(q, fresh, fresh, pool, pool, tables, pos, k_scale=scale,
                     v_scale=scale)
    with pytest.raises(TypeError):
        pa_kernel._check(q, fresh.to(torch.int8), fresh.to(torch.int8), pool,
                         pool, tables, pos, k_scale=scale, v_scale=scale)


@pytest.mark.parametrize("P", list(range(1, 10)) + [37, 200])
def test_fitness_plan_route_and_scratch(P):
    """P <= P_NARROW (the GA's polish, P 4, among them) takes the narrow
    kernel, with a per-run scratch of ceil(E / 8) x P; wider populations
    take the wide kernel, with a per-tile scratch of ceil(E / 128) x P
    and a grid of ceil(P / BLOCK_INDIVIDUALS) tiles of individuals."""
    E, m = 8192, 2048
    plan = rec_kernel.fitness_plan(E, m, P)
    if P <= rec_kernel.P_NARROW:
        assert plan.route == "narrow"
        assert plan.workspace == (E // rec_kernel.RUN_EVENTS, P)
        assert plan.grid == (E // rec_kernel.NARROW_EVENTS, 1)
        assert plan.vec16
    else:
        assert plan.route == "wide"
        assert plan.workspace == (E // rec_kernel.BLOCK_EVENTS, P)
        assert plan.grid == (E // rec_kernel.BLOCK_EVENTS,
                             -(-P // rec_kernel.BLOCK_INDIVIDUALS))


def test_fitness_polish_takes_the_narrow_kernel():
    """The polish's population (``GAConfig().polish_k``) fits the narrow
    kernel, and ``P_NARROW`` is at least 4."""
    from repro_torch.core.catopt import GAConfig
    assert rec_kernel.P_NARROW >= 4
    assert rec_kernel.fitness_plan(8192, 2048,
                                   GAConfig().polish_k).route == "narrow"


@pytest.mark.parametrize("E,m,aligned,vec16", [
    (8192, 2048, True, True), (777, 130, True, False),
    (500, 300, False, False), (1000, 257, True, False), (7, 4, True, True)])
def test_fitness_plan_copy_width(E, m, aligned, vec16):
    """16-byte copies need m % 4 == 0 and 16-byte aligned IL and w; else
    4-byte copies.  Ragged E rounds the scratch up."""
    plan = rec_kernel.fitness_plan(E, m, 3, aligned=aligned)
    assert plan.vec16 is vec16
    assert plan.workspace == (-(-E // rec_kernel.RUN_EVENTS), 3)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_wkv_plan_splits_each_head(D):
    """The wkv kernel splits each head's D x D state over D / columns
    blocks, a column over D / rows_per_lane lanes of one warp (4 rows a
    lane, 8 at D 128), each lane keeping COLS_PER_LANE columns;
    rwkv6-1.6b's B 1 x H 32 x D 64 gets 128 blocks of 4 warps, one for
    each of 128 of the card's 132 SMs."""
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    plan = wkv_kernel.wkv_plan(1, 32, D)
    assert D % plan.columns == 0 and plan.columns % 8 == 0
    assert plan.lanes_per_column * wkv_kernel.rows_per_lane(D) == D
    assert plan.lanes_per_column <= 16 and plan.threads % 32 == 0
    assert plan.threads * wkv_kernel.COLS_PER_LANE == (
        plan.columns * plan.lanes_per_column)
    assert plan.columns % wkv_kernel.COLS_PER_LANE == 0
    assert plan.threads <= 256 and plan.blocks == 32 * D // plan.columns
    if D == 64:
        assert plan.blocks == 128 and plan.threads == 128
    assert wkv_kernel.wkv_plan(3, 5, D).blocks == 15 * D // plan.columns


def test_wkv_rows_aligned_or_copied():
    """Views whose rows start on 16-byte boundaries (the model's, a slice
    of a fused projection) go to the kernel as they are; a view one
    element off is copied first."""
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    base = torch.zeros(2, 5, 3, 4, 64, dtype=torch.bfloat16)
    assert wkv_kernel._rows_aligned(base[:, :, 1])
    assert wkv_kernel._rows_aligned(torch.zeros(2, 5, 8, 16)[:, :, ::2])
    flat = torch.zeros(2 * 5 * 4 * 64 + 1, dtype=torch.bfloat16)
    assert not wkv_kernel._rows_aligned(flat[1:].view(2, 5, 4, 64))
