// Every head dim the attention kernels take, a multiple of 8 from 8 to 256
// (qtpu's Pallas kernels take any hd % 8 == 0; its K2 stops at 256), as
// X(hd): the instance tables of K5 (flash_attention.cu), K3's kernel
// (kv_attention.cu) and K12 (kv_flash_decode.cu) expand it. Mirrored by
// HEAD_DIMS in qtpu_torch/kernels/flash_attention.py and kv_attention.py.
#pragma once

#define QTPU_HEAD_DIMS(X)                                                                    \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96) X(104) X(112)     \
  X(120) X(128) X(136) X(144) X(152) X(160) X(168) X(176) X(184) X(192) X(200) X(208)      \
  X(216) X(224) X(232) X(240) X(248) X(256)
