"""Hand-written Hopper kernels, the counterpart of
``mxnet_tpu/ops/pallas``.

Each TPU (Pallas) kernel on a ported path becomes a CUDA C++ kernel for
``sm_90a`` under ``csrc/``, built by nvcc on first use (``_build``) and
bound with ``ctypes``. Beside each kernel sits its plain PyTorch version;
a wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor, and counts its launches (:func:`launch_counts`). The
attention training kernels, the epilogue kernels and the softmax-xent
kernels are built for bf16 too (AMP, ``net.cast('bfloat16')``); their
bf16 instances count under their kernel's name and :data:`BF16`. The
whole-model optimizer update (``multi_tensor.MultiTensorPlan``, driven by
``optimizer/fused.py``) has no Pallas counterpart: it stands for the XLA
fusion of the reference's traced update. A kernel that does not build
raises :class:`KernelBuildFailure`, one that does not launch
:class:`KernelLaunchFailure` (``errors.py``): never transient to the
resilience layer.
"""
from ._launch import (BF16, KERNELS, instance_launches, launch_counts,
                      reset_launch_counts)
from .attention import (FWD_BLOCK_Q, HEAD_DIM_MAX, HEAD_WIDTHS, K_BLOCK,
                        FlashAttentionFunction,
                        dkv_bf16_geometry, dkv_geometry, dq_bf16_geometry,
                        dq_geometry, flash_attention,
                        flash_attention_backward,
                        flash_attention_backward_reference,
                        flash_attention_bf16_reference, flash_attention_dkv,
                        flash_attention_dkv_bf16_reference,
                        flash_attention_dkv_reference,
                        flash_attention_dq, flash_attention_dq_bf16_reference,
                        flash_attention_dq_reference,
                        flash_attention_reference, flash_attention_with_lse,
                        flash_decode_attention,
                        flash_decode_attention_reference,
                        flash_paged_decode_attention,
                        flash_paged_decode_attention_reference,
                        fwd_bf16_geometry, fwd_block_qs, fwd_geometry,
                        head_width, online_softmax_block)
from .epilogue import (ACT_TYPES, ActFunction, AddActFunction,
                       BnApplyFunction, BnGeometry, EpilogueGeometry,
                       act_backward,
                       act_backward_reference,
                       act_forward, act_forward_reference, add_act_forward,
                       add_act_forward_reference, bn_act_backward,
                       bn_act_backward_reference, bn_act_forward,
                       bn_act_forward_reference, bn_geometry,
                       epilogue_geometry,
                       fused_act, fused_add_act, fused_bn_apply)
from .errors import (HeadDimError, KernelBuildFailure, KernelError,
                     KernelLaunchFailure)
from .multi_tensor import MultiTensorPlan
from .matmul import (VARIANTS as MATMUL_VARIANTS, MatmulGeometry, matmul,
                     matmul_cur, matmul_ep, matmul_geometry, matmul_noacc,
                     matmul_reference, matmul_ws)
from .nms import (MAX_BOXES, greedy_nms_keep, greedy_nms_keep_reference,
                  nms_iterations)
from .xent import (XENT_INSTANCES, SoftmaxXentFunction, XentBwdChunk,
                   XentGeometry, fused_softmax_xent_rows,
                   fused_softmax_xent_rows_reference, softmax_xent_backward,
                   softmax_xent_backward_reference, softmax_xent_forward,
                   softmax_xent_forward_reference, xent_bwd_geometry,
                   xent_geometry)

__all__ = ['KERNELS', 'BF16', 'K_BLOCK', 'FWD_BLOCK_Q', 'HEAD_DIM_MAX',
           'HEAD_WIDTHS', 'head_width', 'fwd_block_qs', 'fwd_geometry',
           'fwd_bf16_geometry', 'dq_geometry', 'dkv_geometry',
           'dq_bf16_geometry', 'dkv_bf16_geometry',
           'flash_attention_bf16_reference',
           'flash_attention_dq_bf16_reference',
           'flash_attention_dkv_bf16_reference',
           'online_softmax_block', 'flash_attention',
           'FlashAttentionFunction', 'flash_attention_reference',
           'flash_attention_with_lse', 'flash_attention_dq',
           'flash_attention_dkv', 'flash_attention_backward',
           'flash_attention_dq_reference', 'flash_attention_dkv_reference',
           'flash_attention_backward_reference', 'flash_decode_attention',
           'flash_decode_attention_reference',
           'flash_paged_decode_attention',
           'flash_paged_decode_attention_reference', 'XENT_INSTANCES',
           'XentGeometry', 'xent_geometry', 'XentBwdChunk',
           'xent_bwd_geometry', 'fused_softmax_xent_rows',
           'fused_softmax_xent_rows_reference', 'SoftmaxXentFunction',
           'softmax_xent_forward', 'softmax_xent_forward_reference',
           'softmax_xent_backward', 'softmax_xent_backward_reference',
           'ACT_TYPES', 'EpilogueGeometry', 'epilogue_geometry',
           'BnGeometry', 'bn_geometry',
           'act_forward', 'act_forward_reference',
           'act_backward', 'act_backward_reference', 'add_act_forward',
           'add_act_forward_reference', 'bn_act_forward',
           'bn_act_forward_reference', 'bn_act_backward',
           'bn_act_backward_reference', 'ActFunction', 'AddActFunction',
           'BnApplyFunction', 'fused_act', 'fused_add_act', 'fused_bn_apply',
           'MAX_BOXES', 'greedy_nms_keep', 'greedy_nms_keep_reference',
           'nms_iterations', 'MATMUL_VARIANTS', 'MatmulGeometry',
           'matmul_geometry', 'matmul', 'matmul_reference',
           'matmul_cur', 'matmul_noacc', 'matmul_ws', 'matmul_ep',
           'MultiTensorPlan', 'KernelError', 'KernelBuildFailure',
           'HeadDimError',
           'KernelLaunchFailure',
           'launch_counts', 'instance_launches', 'reset_launch_counts']
