"""Rows 1, 4 and 4p at every head dim on the card: the float32 flash
forward, decode and paged decode kernels against their plain versions at
the head dims of ``chip_smoke.HEAD_DIM_CHECKS``, each also with more
forward work items than SMs, and at phase 3w's 16 heads of 128 (phase
3w (a)): 1e-5 absolute, prefill rows bitwise the decode kernel, the
paged instance bitwise the slot one, every call a launch, and a head dim
of 129 refused typed. The kernels are CUDA C++ for sm_90a with no CPU
mode, so the test skips without a card. No JAX here: the card's tests
compare with the plain PyTorch versions.
"""
import pytest
import torch

from chip_smoke import (HEAD_DIM_CHECKS, HEAD_DIM_HEADS, HEAD_DIM_SERVED,
                        TOL, check_head_dims)
from mxnet_tpu_torch.ops import kernels


@pytest.mark.cuda
def test_head_dim_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for '
                    'sm_90a and have no CPU mode')
    res = check_head_dims(torch, kernels, torch.device('cuda'),
                          HEAD_DIM_CHECKS)
    assert sorted(res['by_dim']) == sorted(
        [(d, HEAD_DIM_HEADS) for d in HEAD_DIM_CHECKS] + [HEAD_DIM_SERVED])
    assert all(err <= TOL for err in res['errs'].values()), res['errs']
