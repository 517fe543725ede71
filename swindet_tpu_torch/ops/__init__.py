"""Operators with hand-written Hopper kernels, each beside its plain
PyTorch version. A wrapper takes the plain version for a CPU tensor and
launches its kernel (or raises) for a CUDA tensor; ``wrapper.launches``
counts its kernel's launches. The ``*_op`` functions are the
differentiable entry points the models call."""
from .conv3x3 import (conv3x3, conv3x3_dw, conv3x3_dw_reference, conv3x3_op,
                      conv3x3_reference)
from .fused_mlp import (fused_mlp, fused_mlp_bwd, fused_mlp_bwd_limits,
                        fused_mlp_bwd_reference, fused_mlp_bwd_reference_f64,
                        fused_mlp_op, fused_mlp_reference)
from .layer_norm import layer_norm, layer_norm_op, layer_norm_reference
from .nms import nms_sorted, nms_sorted_reference
from .roi_align import (multilevel_roi_align, multilevel_roi_align_backward,
                        roi_align, roi_align_bwd, roi_align_op)
from .swin_attention import (shifted_window_attn_mask,
                             swin_attention_kernel_form,
                             swin_attention_reference, swin_window_attention)
from .window_attention import window_attention, window_attention_reference
from .window_attention_v3 import (window_attention_bwd,
                                  window_attention_bwd_reference,
                                  window_attention_fwd_p,
                                  window_attention_fwd_p_reference,
                                  window_attention_op, window_attention_v3)
from .window_attention_v4 import (window_attention_v4,
                                  window_attention_v4_bwd,
                                  window_attention_v4_bwd_limits,
                                  window_attention_v4_bwd_reference,
                                  window_attention_v4_bwd_reference_f64,
                                  window_attention_v4_op,
                                  window_attention_v4_reference)

# the kernel wrappers of the inference path, in the order of the model;
# serving runs these
INFERENCE_KERNELS = (layer_norm, window_attention_v3, conv3x3, roi_align,
                     nms_sorted)
# and those the training step adds: the forward that saves the softmax and
# the three backward kernels
TRAINING_KERNELS = (window_attention_fwd_p, window_attention_bwd,
                    conv3x3_dw, roi_align_bwd)
# the fused-MLP configuration's (SWINDET_FUSED_MLP=1): serving runs the
# forward, training both
FUSED_MLP_KERNELS = (fused_mlp, fused_mlp_bwd)
# the v4 window-attention configuration's (SWINDET_WATTN_V4=1), in place of
# the v3 attention kernels: serving runs the forward, training both
WATTN_V4_KERNELS = (window_attention_v4, window_attention_v4_bwd)
# kernels that no model path runs, as in the JAX package, where only the
# ops tests run them: the v1 attention and the full-map shifted attention
OP_ONLY_KERNELS = (window_attention, swin_window_attention)
KERNEL_WRAPPERS = (INFERENCE_KERNELS + TRAINING_KERNELS + FUSED_MLP_KERNELS
                   + WATTN_V4_KERNELS + OP_ONLY_KERNELS)


# wrappers with two kernels, picked by dtype (the attentions' also by head
# width): ``tc_launches`` counts the bf16 tensor-core kernel's share of
# ``launches``
TENSOR_CORE_KERNELS = (conv3x3, conv3x3_dw, fused_mlp, fused_mlp_bwd,
                       window_attention_v3, window_attention_fwd_p,
                       window_attention_bwd, window_attention_v4,
                       window_attention_v4_bwd, window_attention,
                       swin_window_attention)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in TENSOR_CORE_KERNELS:
        fn.tc_launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def tc_launch_counts() -> dict:
    return {fn.__name__: fn.tc_launches for fn in TENSOR_CORE_KERNELS}
