"""Which body K10 (the gathered MoE matmul) launches on the card, and how
its tensor-core body splits the routed slots among its blocks:
`gathered_route` (csrc/moe_matmul.cu: gathered_tc_fits) with the cluster
split of `gemv_split`, and a numpy model of the kernel's leader plan
(gathered_plan in csrc/moe_matmul.cu):

  "gemv_tc"  W4 or W8, group 64 or 128, N % 16 == 0, codes, scales and
             zeros 16-byte aligned, 1 to 65535 slots: one weight stream per
             distinct routed expert, the slots of one expert (at most 8 a
             block) as the columns of the mma's B operand
  "gemv"     the rest (W2, other groups, ragged N, unaligned tensors):
             dq_core's GEMV, one slot a row tile

Also K2's launches: a CPU tensor takes the plain write and counts no launch,
and the card-only entries refuse CPU tensors. The kernels run only on the
card (tests/test_torch_gpu.py holds them to their plain versions there).
"""

import numpy as np
import pytest
import torch

from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.kernels import dequant_matmul as k1
from qtpu_torch.kernels import kv_attention as k23
from qtpu_torch.kernels import moe_matmul as k9
from qtpu_torch.models.config import MIXTRAL_8X7B, QWEN2_MOE_A14B

ALIGNED = (1 << 20, 1 << 21, 1 << 22)  # 16-byte aligned codes, scales, zeros
SMS = 132  # an H100 SXM
K10_SLOTS = (1, 6, 3, 6)  # the 2-slot Mixtral engine's step: 2 tokens x top-2, a repeat
MIXTRAL = {"gate_up": (MIXTRAL_8X7B.hidden_size, MIXTRAL_8X7B.intermediate_size),
           "down": (MIXTRAL_8X7B.intermediate_size, MIXTRAL_8X7B.hidden_size)}
QWEN = {"gate_up": (QWEN2_MOE_A14B.hidden_size, QWEN2_MOE_A14B.intermediate_size),
        "down": (QWEN2_MOE_A14B.intermediate_size, QWEN2_MOE_A14B.hidden_size)}


def _split(Gs, K, N, group=128):
    """The wrapper's split on an H100: tiles = the column strips of Gs slots."""
    return k1.gemv_split(SMS, -(-N // k1.GEMV_TC_COLS) * Gs, K // group, group)


def plan(eidx, E):
    """The kernel's plan (csrc/moe_matmul.cu: gathered_plan), in numpy: {slot
    i: the slots its block takes, in order} for every leading slot. Slot i
    leads when its expert e is in [0, E) and the slots before it of expert e
    number a multiple of 8; it takes the first at most 8 slots j >= i of e."""
    eidx = np.asarray(eidx)
    out = {}
    for i, e in enumerate(eidx):
        if not 0 <= e < E:
            continue
        if int((eidx[:i] == e).sum()) % 8 == 0:
            out[i] = [int(j) for j in np.flatnonzero(eidx[i:] == e)[:8] + i]
    return out


@pytest.mark.parametrize("site", sorted(MIXTRAL))
@pytest.mark.parametrize("bits,group", [(4, 128), (4, 64), (8, 128), (8, 64)])
def test_mixtral_sites_take_the_tensor_core_body(site, bits, group):
    K, N = MIXTRAL[site]
    for Gs in (1, len(K10_SLOTS), 8, 12, 64):
        assert k9.gathered_route(Gs, K, N, bits, group, ALIGNED) == "gemv_tc"


@pytest.mark.parametrize("site", sorted(QWEN))
def test_qwen2_moe_sites_take_the_tensor_core_body(site):
    K, N = QWEN[site]
    assert k9.gathered_route(4, K, N, 4, 128, ALIGNED) == "gemv_tc"


def test_the_split_at_mixtrals_sites():
    # the 2-slot step (Gs 4): gate/up 112 strips x 4 -> 2 blocks of 16 groups
    # (2048 K values each); down 32 strips x 4 -> 8 blocks of 14 groups
    assert _split(4, *MIXTRAL["gate_up"]) == (2, 16)
    assert _split(4, *MIXTRAL["down"]) == (8, 14)
    # one slot: gate/up needs 4 blocks a strip to reach 2 blocks an SM
    assert _split(1, *MIXTRAL["gate_up"]) == (4, 8)
    assert _split(1, *MIXTRAL["down"]) == (8, 14)  # x's slice cap forces 8 at K 14336


@pytest.mark.parametrize("Gs", [1, 2, 4, 6, 12, 64])
@pytest.mark.parametrize("site", sorted(MIXTRAL))
def test_the_split_covers_the_groups_once_within_xs_cap(Gs, site):
    K, N = MIXTRAL[site]
    for group in (64, 128):
        groups = K // group
        c, per = _split(Gs, K, N, group)
        assert 1 <= c <= 8
        slices = [range(r * per, min(groups, (r + 1) * per)) for r in range(c)]
        assert all(len(s) > 0 for s in slices)
        assert sorted(g for s in slices for g in s) == list(range(groups))
        assert per * group <= k1.GEMV_TC_X_CAP
        if K == 14336:  # down: at least 4 K slices (x's 4096-value cap)
            assert c >= 4


@pytest.mark.parametrize("bits,group,N,ptrs,why", [
    (2, 128, 4096, ALIGNED, "W2 keeps dq_core"),
    (4, 32, 4096, ALIGNED, "a group of 32"),
    (4, 256, 4096, ALIGNED, "a group of 256"),
    (4, 128, 4104, ALIGNED, "N % 16 != 0"),
    (4, 128, 4100, ALIGNED, "N % 16 != 0, N % 4 == 0"),
    (4, 128, 4096, (1 << 20, (1 << 21) + 8, 1 << 22), "scales 8-byte aligned"),
    (4, 128, 4096, ((1 << 20) + 4, 1 << 21, 1 << 22), "codes 4-byte aligned"),
    (4, 128, 4096, (1 << 20, 1 << 21, (1 << 22) + 2), "zeros 2-byte aligned"),
])
def test_calls_the_body_does_not_take_keep_dq_core(bits, group, N, ptrs, why):
    assert k9.gathered_route(4, 14336, N, bits, group, ptrs) == "gemv", why


def test_slot_counts_outside_the_grid_keep_dq_core():
    assert k9.gathered_route(0, 4096, 14336, 4, 128, ALIGNED) == "gemv"
    assert k9.gathered_route(k9.GATHERED_MAX_SLOTS, 4096, 14336, 4, 128, ALIGNED) == "gemv_tc"
    assert k9.gathered_route(k9.GATHERED_MAX_SLOTS + 1, 4096, 14336, 4, 128, ALIGNED) == "gemv"


def _check_plan(eidx, E):
    leaders = plan(eidx, E)
    taken = [j for rows in leaders.values() for j in rows]
    inside = [i for i, e in enumerate(eidx) if 0 <= e < E]
    assert sorted(taken) == inside  # every slot in range exactly once, none outside
    for i, rows in leaders.items():
        assert 1 <= len(rows) <= 8 and rows[0] == i and rows == sorted(rows)
        assert all(eidx[j] == eidx[i] for j in rows)  # one expert's weight stream a block
    # one leader per 8 slots of an expert: the weight streams the kernel makes
    counts = np.bincount([e for e in eidx if 0 <= e < E], minlength=E)
    assert len(leaders) == int(sum(-(-c // 8) for c in counts))
    return leaders


@pytest.mark.parametrize("seed", range(24))
def test_the_plan_takes_every_slot_once_at_most_8_a_leader(seed):
    rng = np.random.default_rng(seed)
    E = int(rng.choice([2, 4, 8, 64]))
    Gs = int(rng.integers(1, 200))
    eidx = rng.integers(-2, E + 2, size=Gs)  # repeats, ids out of range
    if seed % 3 == 0:  # many slots on one expert
        eidx[rng.random(Gs) < 0.7] = int(rng.integers(0, E))
    _check_plan(eidx.tolist(), E)


def test_the_plan_at_the_2_slot_step_streams_each_distinct_expert_once():
    leaders = _check_plan(list(K10_SLOTS), 8)
    assert leaders == {0: [0], 1: [1, 3], 2: [2]}  # expert 6's two slots share a stream
    assert len(leaders) == len(set(K10_SLOTS))


def test_the_plan_of_12_slots_on_one_expert_has_two_leaders():
    assert _check_plan([5] * 12, 8) == {0: list(range(8)), 8: list(range(8, 12))}
    assert _check_plan([3, -1, 3, 8, 0, 7, 3, -5], 4) == {0: [0, 2, 6], 4: [4]}


def _experts(E, K, N, bits=4, group=128):
    g = torch.Generator().manual_seed(0)
    parts = [quantize_pack(torch.randn(K, N, generator=g) * 0.02, bits, group)
             for _ in range(E)]
    return tuple(torch.stack([getattr(p, f) for p in parts]) for f in ("data", "scales", "zeros"))


def _counters():
    w = k9.moe_gathered_matmul
    return (w.launches, w.gemv_tc_launches, w.gemv_launches, k9.moe_gathered_matmul_simt.launches,
            k23.cache_band_write.launches, k23.cache_band_write_serial.launches,
            k23.cache_band_write_simt.launches)


def test_cpu_tensors_take_the_plain_version_and_count_no_route():
    site = _experts(4, 256, 128)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(5, 256, generator=g).to(torch.bfloat16)
    eidx = torch.tensor([2, 0, 2, 3, 2], dtype=torch.int32)
    before = _counters()
    got = k9.moe_gathered_matmul(x, eidx, *site, (4, 128, 256, 128))
    want = k9.moe_gathered_matmul_plain(x, eidx, *site, (4, 128, 256, 128))
    assert torch.equal(got, want)
    L, B, KV, S, hd = 2, 3, 2, 16, 64
    cache = [torch.zeros(L, B, KV, S, hd, dtype=torch.int8) for _ in range(2)]
    cache += [torch.zeros(L, B, KV, S) for _ in range(2)]
    kn = torch.randn(B, 1, KV, hd, generator=g).to(torch.bfloat16)
    pos = torch.tensor([0, 7, S], dtype=torch.int32)
    k23.cache_band_write(kn, kn, *cache, pos, 1)
    assert int(cache[0][1, 1, :, 7].abs().sum()) > 0 and float(cache[2][1, 2].abs().sum()) == 0
    assert _counters() == before


def test_the_card_only_entries_refuse_cpu_tensors():
    site = _experts(2, 256, 128)
    x = torch.zeros(2, 256, dtype=torch.bfloat16)
    eidx = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        k9.moe_gathered_matmul_simt(x, eidx, *site, (4, 128, 256, 128))
    cache = [torch.zeros(1, 2, 2, 16, 64, dtype=torch.int8) for _ in range(2)]
    cache += [torch.zeros(1, 2, 2, 16) for _ in range(2)]
    kn = torch.zeros(2, 1, 2, 64, dtype=torch.bfloat16)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    for fn in (k23.cache_band_write_serial, k23.cache_band_write_simt):
        with pytest.raises(ValueError):
            fn(kn, kn, *cache, pos, 0)
