"""Rows 2, 3, 1b, 2b and 3b at every head dim on the card: the float32
and bf16 flash dq and dk/dv and the bf16 forward against their plain
versions at the head dims of ``chip_smoke.TRAIN_HEAD_DIM_CHECKS`` (phase
4w (a): every width's D == W and D < W instances by each staging route
of their rows): rows 2 / 3 within 1e-5 of each gradient's max abs, 1b-3b
within 2 bf16 ULPs of their own plain versions beyond the float32 tier
and the flip slack and within the reference's bf16 tier, on lengths
below S, a row set with no visible key, Sq != Sk, a case of more work
items than the card holds at once and the main path's B 96, H 12, S
128; every call a launch at the head dim's width, and a head dim of 129
refused typed. The kernels are CUDA C++ for sm_90a with no CPU mode, so
the test skips without a card. No JAX here: the card's tests compare
with the plain PyTorch versions.
"""
import pytest
import torch

from chip_smoke import TRAIN_HEAD_DIM_CHECKS, check_train_head_dims
from mxnet_tpu_torch.ops import kernels


@pytest.mark.cuda
def test_train_head_dim_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for '
                    'sm_90a and have no CPU mode')
    res = check_train_head_dims(torch, kernels, torch.device('cuda'))
    assert sorted(res['by_dim']) == sorted(TRAIN_HEAD_DIM_CHECKS)
    for d, errs in res['by_dim'].items():
        assert set(errs) == {'flash_attention_dq', 'flash_attention_dkv',
                             'flash_attention_fwd.bf16',
                             'flash_attention_dq.bf16',
                             'flash_attention_dkv.bf16'}, d
