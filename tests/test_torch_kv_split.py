"""How K3's kernel and K12 split a decode step's cache rows over blocks:
`decode_slices` and `decode_cluster` (K3's kernel: one thread-block cluster
per (sequence, kv-head), csrc/kv_attention.cu: kvd_slice) and
`flash_splits` (K12's split body, csrc/kv_flash_decode.cu), in
qtpu_torch/kernels/kv_attention.py. The kernels take the cluster and the
split as given and compute each block's slice from pos on the card, so these
rules decide which rows each block reads and which block writes row pos;
the kernels themselves run only on the card (tests/test_torch_gpu.py).
"""

import pytest

from qtpu_torch.kernels import kv_attention as kv
from qtpu_torch.models.config import GPT2_SMALL, MIXTRAL_8X7B, TINYLLAMA_1_1B

H100_SMS = 132
SERVE_S = 176  # the serve cells' cache: 128 + 32 + 16 rows rounded to 8
LONG_K11_S = 32784  # the per-layer cache at max_seq_len 32768: K11 on each layer


def _kept(p, S, window):
    hi = min(p, S - 1)
    lo = max(0, p - window + 1) if window > 0 else 0
    return list(range(lo, hi + 1))


@pytest.mark.parametrize("p,S,window,cluster", [
    # the serve cells' positions, every cluster size
    *[(p, SERVE_S, 0, c) for p in (0, 63, 64, 65, 128, 130, 170, 175) for c in (1, 2, 3, 8)],
    # pos on a chunk or slice boundary and one row past it
    (127, 256, 0, 2), (128, 256, 0, 2), (191, 256, 0, 3), (192, 256, 0, 3),
    # windows, one that empties whole slices
    (170, SERVE_S, 64, 3), (175, SERVE_S, 16, 8), (1000, 2048, 100, 8), (63, 256, 1, 4),
    # an inactive slot (pos >= S) reads [0, S) (or its window), writes nothing
    (SERVE_S, SERVE_S, 0, 3), (SERVE_S + 3, SERVE_S, 0, 1), (SERVE_S + 5, SERVE_S, 64, 3),
    (4 * SERVE_S, SERVE_S, 64, 3),
    # a negative pos reads nothing
    (-1, SERVE_S, 0, 3),
    # the long per-layer cache
    (LONG_K11_S - 80, LONG_K11_S, 0, 4), (LONG_K11_S - 1, LONG_K11_S, 4096, 8),
])
def test_decode_slices_cover_the_kept_rows_once(p, S, window, cluster):
    slices = kv.decode_slices(p, S, window, cluster)
    assert len(slices) == cluster
    rows = [s for beg, end in slices for s in range(beg, end)]
    assert rows == _kept(p, S, window)  # each kept row once, in rank order
    per = slices[0][1] - slices[0][0]
    for rank, (beg, end) in enumerate(slices):
        assert end >= beg
        if end > beg and rank + 1 < cluster and slices[rank + 1][1] > slices[rank + 1][0]:
            assert (end - beg) % kv.DECODE_CHUNK == 0 and end - beg == per  # whole chunks
    writers = [r for r, (beg, end) in enumerate(slices) if beg <= p < end]
    if 0 <= p < S:
        assert len(writers) == 1  # the one block that writes and stages row pos
        assert all(end == beg for beg, end in slices[writers[0] + 1:])
    else:
        assert writers == []


@pytest.mark.parametrize("B,KV,S,want", [
    (8, TINYLLAMA_1_1B.num_kv_heads, SERVE_S, 3),  # serve: K3, K8, boundary's K11
    (8, MIXTRAL_8X7B.num_kv_heads, SERVE_S, 2),  # serve_moe: K11
    (8, GPT2_SMALL.num_kv_heads, SERVE_S, 1),  # serve_gpt2: the one-layer entry
    (8, TINYLLAMA_1_1B.num_kv_heads, LONG_K11_S, 4),  # the per-layer cache off K12's granule
    (32, 8, SERVE_S, 1),  # more heads than SMs
    (1, 1, 40, 1),  # one chunk of S
    (1, 1, 4096, 8),  # the portable cluster size
])
def test_decode_cluster_at_the_path_shapes(B, KV, S, want):
    cluster = kv.decode_cluster(H100_SMS, B, KV, S)
    assert cluster == want
    assert 1 <= cluster <= kv.MAX_CLUSTER
    assert cluster == 1 or B * KV * cluster <= H100_SMS  # a block an SM


@pytest.mark.parametrize("blocks_per_sm,B,KV,rows,want", [
    (5, 8, 4, 32768, 16),  # long_ctx: TinyLlama B 8 at S 32768, four blocks an SM
    (3, 4, 8, 4096, 8),  # Mistral-7B widths, window 4096: 512-row slices
    (3, 4, 8, 32768, 12),  # hd 128 without a window: three blocks an SM fit
    (5, 8, 4, SERVE_S, 1),  # the serve cell's cache: one slice
    (4, 64, 32, 32768, 1),  # more heads than the card holds blocks
])
def test_flash_splits(blocks_per_sm, B, KV, rows, want):
    nsplit = kv.flash_splits(H100_SMS, blocks_per_sm, B, KV, rows)
    assert nsplit == want
    assert nsplit == 1 or B * KV * nsplit <= H100_SMS * min(4, blocks_per_sm)
