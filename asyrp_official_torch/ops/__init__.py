"""The port's hand-written kernels, each beside its plain PyTorch version:

  K1 `groupnorm.group_norm`  — GroupNorm(+SiLU), CUDA C++ (`csrc/groupnorm.cu`),
                               on NCHW or (forward only) channels-last tensors;
                               its backward K1-bwd in the same source
  K2 `attention.attention`   — spatial attention, one head (DDPM++) or several
                               with the legacy q/k scale (OpenAI UNets), CUDA C++
                               (`csrc/attention.cu`); its single-head backward
                               K2-bwd there too
  K3 `ddim_step.ddim_step`   — the asymmetric DDIM update, CUDA C++
                               (`csrc/steps.cu`); its backward K3-bwd there too
  `ddpm_step.ddpm_step`      — the DDPM ancestral update (`--sample_type ddpm`),
                               CUDA C++ (`csrc/steps.cu`)

Every kernel is built by `_build` (nvcc for sm_90a, loaded with ctypes).
A wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor; its `launches` attribute (and `bwd_launches` for K1, K2
and K3, `mh_launches` for K2 with several heads, `scalar_launches` for the
step kernels' scalar instance) counts kernel launches; K1's `nhwc_launches`
counts its calls on channels-last tensors.

K1, K2 and K3 are also registered as `torch.library` custom ops
(`torch.ops.asyrp.group_norm`, `.attention`, `.ddim_step`): on CUDA the
kernel's launch, on the CPU the plain version, with a fake for shapes. A
wrapper calls its op only while `torch.export` traces, so that an exported
program names the op (`pipelines/export.py`); in eager mode it launches
directly.
"""
import torch


def channels_last(x) -> bool:
    """Whether x is a 4-D tensor laid out channels-last (NHWC in memory)
    and not NCHW-contiguous as well (as a tensor with H = W = 1 is)."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def traced() -> bool:
    """Whether a wrapper takes its registered op (see above)."""
    return torch.compiler.is_compiling()
