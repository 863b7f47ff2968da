"""The port's hand-written kernels, each beside its plain PyTorch version:

  K1 `groupnorm.group_norm`  — GroupNorm(+SiLU), CUDA C++ (`csrc/groupnorm.cu`)
  K2 `attention.attention`   — single-head spatial attention, CUDA C++ (`csrc/attention.cu`)
  K3 `ddim_step.ddim_step`   — the asymmetric DDIM update, Triton

A wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor; its `launches` attribute counts kernel launches.
"""
